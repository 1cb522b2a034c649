"""ATE of the JAX reference engine, loop verification off, on a named
sequence of ``tools/sequences.py``.

The PyTorch port is held to these numbers: ``chip_smoke.py`` holds its ATE
on the ``orbit`` sequence to ``JAX_REFERENCE_ATE_M``, and
``tools/torch_sequence.py`` runs the port on the same frames.
``SlamSystem.MAX_VERIFY = 0`` keeps the host from ever verifying a loop, so
the trajectory does not depend on the loop modules that the port does not
have yet.

    JAX_PLATFORMS=cpu python tools/jax_reference_ate.py [--sequence orbit|hall]
        [--frames N] [--out traj.npy]

Prints one JSON line: ATE (m), keyframes, points, lost frames,
keyframe-event frame indices.
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
    args = ap.parse_args()

    import jax.numpy as jnp

    from boslam_tpu.config import SlamConfig
    from boslam_tpu.geometry import align
    from boslam_tpu.io import synthetic
    from boslam_tpu.slam import SlamSystem

    cfg, traj, frames = sequences.build(args.sequence, SlamConfig, synthetic,
                                        args.frames)
    t0 = time.perf_counter()
    slam = SlamSystem(cfg)
    slam.MAX_VERIFY = 0
    for ts, rgb, depth in frames:
        slam.feed(ts, rgb, depth)
    slam.flush()
    _, est = slam.trajectory()
    rmse, _ = align.ate_rmse(jnp.asarray(est[:, 4:]),
                             jnp.asarray(traj.poses_twc[:, 4:]))
    if args.out:
        np.save(args.out, est)
    kf_frames = [i for i, m in enumerate(slam.metrics)
                 if m.get("event") in ("init", "keyframe")]
    print(json.dumps({
        "sequence": args.sequence,
        "ate_m": float(rmse),
        "frames": len(frames),
        "keyframes": slam.n_keyframes,
        "points": slam.n_points,
        "lost": sum(1 for m in slam.metrics if m.get("lost", False)),
        "kf_event_frames": kf_frames,
        "seconds": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main()
