"""Run the PyTorch port over a named sequence of ``tools/sequences.py`` on
the CUDA card and print its accuracy and speed.

The JAX reference on the same frames comes from
``JAX_PLATFORMS=cpu python tools/jax_reference_ate.py --sequence NAME``
(with ``--loops`` when this run has it).

    python tools/torch_sequence.py [--sequence orbit|hall|kidnap|loop|survey]
        [--loops] [--global-ba] [--seed S] [--frames N] [--warmup 10]
        [--device cuda|cpu]

Without ``--loops`` the engine verifies no loop (``MAX_VERIFY = 0``), as the
reference tool does.  ``--global-ba`` runs one ``run_global_ba()`` after the
run, as the reference tool does.  Prints one JSON line: ATE (m), fps after
the warm-up frames, keyframes, points, lost frames, keyframe-event frame
indices, the relocalization attempts and successes, the loops closed, host
syncs per frame, the card, and with ``--global-ba`` the ATE after it, its
costs, its edge count and its synchronized ms.  ``--device cpu`` runs the
plain path on the CPU (no fps).
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
import torch  # noqa: E402

import sequences  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequence", choices=sorted(sequences.SEQUENCES),
                    default="hall")
    ap.add_argument("--frames", type=int, default=None,
                    help="keep the first N frames of the sequence")
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--loops", action="store_true",
                    help="verify and close loops (MAX_VERIFY stays 4)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the engine's seed (its RANSAC draws)")
    ap.add_argument("--global-ba", action="store_true",
                    help="run global BA once after the run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.geometry import align
    from boslam_tpu_torch.io import synthetic
    from boslam_tpu_torch.slam import SlamSystem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, traj, frames = sequences.build(args.sequence, SlamConfig, synthetic,
                                        args.frames)
    slam = SlamSystem(cfg, seed=args.seed, device=args.device)
    cuda = slam.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if not args.loops:
        slam.MAX_VERIFY = 0
    out = {"sequence": args.sequence, "loops": args.loops,
           "frames": len(frames),
           "card": torch.cuda.get_device_name(0) if cuda else "cpu"}
    t_warm = None
    for i, (ts, rgb, depth) in enumerate(frames):
        if i == args.warmup and cuda:
            # No flush here: the host events (vocabulary training, loop
            # verification) must run on the reference's chunk schedule.
            sync()
            t_warm = time.perf_counter()
        slam.feed(ts, rgb, depth)
    slam.flush()
    sync()
    if t_warm is not None:
        out["fps_after_warmup"] = (len(frames) - args.warmup) / (
            time.perf_counter() - t_warm)

    def ate():
        _, est = slam.trajectory()
        rmse, _ = align.ate_rmse(
            torch.from_numpy(est[:, 4:].astype(np.float32)),
            torch.from_numpy(traj.poses_twc[:, 4:].astype(np.float32)))
        return float(rmse)

    out.update(
        ate_m=ate(),
        keyframes=slam.n_keyframes,
        points=slam.n_points,
        lost=sum(1 for m in slam.metrics if m.get("lost", False)),
        kf_event_frames=[i for i, m in enumerate(slam.metrics)
                         if m.get("event") in ("init", "keyframe")],
        reloc_frames=[i for i, m in enumerate(slam.metrics) if "reloc_ok" in m],
        reloc_ok_frames=[i for i, m in enumerate(slam.metrics)
                         if m.get("reloc_ok")],
        n_loops_closed=slam.n_loops_closed,
        loop_closed_frames=[i for i, m in enumerate(slam.metrics)
                            if m.get("event") == "loop_closed"],
        loop_verified=[(i, m["loop_candidate"], m["loop_inliers"])
                       for i, m in enumerate(slam.metrics)
                       if "loop_inliers" in m],
        host_syncs_per_frame=slam.sync.count / len(frames),
    )
    if args.global_ba:
        sync()
        t0 = time.perf_counter()
        rec = slam.run_global_ba()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        out.update(ate_after_global_ba_m=ate(), gba_cost0=rec["gba_cost0"],
                   gba_cost1=rec["gba_cost1"], gba_edges=rec["gba_edges"],
                   gba_ms=ms if cuda else None)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
