"""ATE and events of the JAX reference engine on a named sequence of
``tools/sequences.py``.

The PyTorch port is held to these numbers: ``chip_smoke.py`` holds its runs
of ``orbit``, ``kidnap`` and ``loop`` to the constants this tool printed,
and ``tools/torch_sequence.py`` runs the port on the same frames.  Without
``--loops``, ``SlamSystem.MAX_VERIFY = 0`` keeps the host from ever
verifying a loop; ``--loops`` leaves it at the reference's 4.

    JAX_PLATFORMS=cpu python tools/jax_reference_ate.py
        [--sequence orbit|hall|kidnap|loop] [--loops] [--seed S] [--frames N]
        [--out traj.npy]

Prints one JSON line: ATE (m), keyframes, points, lost frames,
keyframe-event frame indices, the frames with a relocalization attempt and
with a success, the path each attempt took (``bow`` once the vocabulary is
trained, else ``global``), and the loops closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np  # noqa: E402

import sequences  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequence", choices=sorted(sequences.SEQUENCES),
                    default="orbit")
    ap.add_argument("--frames", type=int, default=None,
                    help="keep the first N frames of the sequence")
    ap.add_argument("--out", type=str, default=None,
                    help="optional .npy path for the anchored trajectory")
    ap.add_argument("--loops", action="store_true",
                    help="verify and close loops (MAX_VERIFY stays 4)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the engine's seed (its RANSAC draws)")
    args = ap.parse_args()

    import jax.numpy as jnp

    from boslam_tpu.config import SlamConfig
    from boslam_tpu.geometry import align
    from boslam_tpu.io import synthetic
    from boslam_tpu.slam import SlamSystem

    cfg, traj, frames = sequences.build(args.sequence, SlamConfig, synthetic,
                                        args.frames)
    t0 = time.perf_counter()
    slam = SlamSystem(cfg, seed=args.seed)
    if not args.loops:
        slam.MAX_VERIFY = 0
    vocab_ready = []  # what each frame's step sees
    for ts, rgb, depth in frames:
        vocab_ready.append(bool(slam.loop.vocab_ready))
        slam.feed(ts, rgb, depth)
    slam.flush()
    _, est = slam.trajectory()
    rmse, _ = align.ate_rmse(jnp.asarray(est[:, 4:]),
                             jnp.asarray(traj.poses_twc[:, 4:]))
    if args.out:
        np.save(args.out, est)
    kf_frames = [i for i, m in enumerate(slam.metrics)
                 if m.get("event") in ("init", "keyframe")]
    reloc = [i for i, m in enumerate(slam.metrics) if "reloc_ok" in m]
    print(json.dumps({
        "sequence": args.sequence,
        "loops": args.loops,
        "ate_m": float(rmse),
        "frames": len(frames),
        "keyframes": slam.n_keyframes,
        "points": slam.n_points,
        "lost": sum(1 for m in slam.metrics if m.get("lost", False)),
        "lost_frames": [i for i, m in enumerate(slam.metrics) if m["lost"]],
        "kf_event_frames": kf_frames,
        "reloc_frames": reloc,
        "reloc_ok_frames": [i for i in reloc if slam.metrics[i]["reloc_ok"]],
        "reloc_paths": ["bow" if vocab_ready[i] else "global" for i in reloc],
        "n_loops_closed": slam.n_loops_closed,
        "loop_closed_frames": [i for i, m in enumerate(slam.metrics)
                               if m.get("event") == "loop_closed"],
        "loop_verified": [(i, m["loop_candidate"], m["loop_inliers"])
                          for i, m in enumerate(slam.metrics)
                          if "loop_inliers" in m],
        "seconds": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main()
