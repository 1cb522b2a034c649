"""CLI: run the PyTorch port on a TUM RGBD sequence or the synthetic fixture.

Examples:
    python -m boslam_tpu_torch.main --synthetic 120 --out traj.txt
    python -m boslam_tpu_torch.main --tum /data/rgbd_dataset_freiburg1_xyz \
        --camera fr1 --out traj.txt

Runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path.
Prints one JSON line with the run's counts and, when groundtruth exists, its
ATE.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description="boslam_tpu_torch RGBD SLAM")
    ap.add_argument("--tum", type=str, help="TUM sequence directory")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N synthetic frames instead of a dataset")
    ap.add_argument("--camera", choices=["fr1", "fr2", "fr3"], default="fr1")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--out", type=str, default="trajectory.txt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args()

    import torch

    from boslam_tpu_torch.config import SlamConfig, TUM_FR1, TUM_FR2, TUM_FR3
    from boslam_tpu_torch.geometry import align
    from boslam_tpu_torch.io import synthetic as synth
    from boslam_tpu_torch.io import tum
    from boslam_tpu_torch.slam import SlamSystem

    cam = {"fr1": TUM_FR1, "fr2": TUM_FR2, "fr3": TUM_FR3}[args.camera]
    cfg = SlamConfig(camera=cam)

    gt = None
    if args.synthetic:
        traj = synth.orbit_trajectory(args.synthetic, radius=0.6, loop=True)
        frames = synth.render_sequence(cfg.camera, traj)
        gt = (traj.timestamps, traj.poses_twc)
    elif args.tum:
        frames = tum.sequence(args.tum, cfg.camera.depth_factor,
                              limit=args.limit)
        try:
            gt = tum.read_groundtruth(f"{args.tum}/groundtruth.txt")
        except OSError:
            pass
    else:
        ap.error("need --tum or --synthetic")

    slam = SlamSystem(cfg, seed=args.seed, device=args.device)
    for i, (ts, rgb, depth) in enumerate(frames):
        slam.process_frame(ts, rgb, depth)
        m = slam.metrics[-1]
        if i % 25 == 0:
            print(
                f"[{i}] kf={slam.n_keyframes} pts={slam.n_points} "
                f"inl={m.get('n_inliers', 0)} {m.get('event', '')}",
                file=sys.stderr,
            )
    ts_arr, poses = slam.trajectory()
    tum.save_trajectory(args.out, ts_arr, poses)
    print(f"wrote {len(ts_arr)} poses to {args.out}", file=sys.stderr)

    summary = {
        "device": str(slam.device),
        "frames": len(ts_arr),
        "keyframes": slam.n_keyframes,
        "points": slam.n_points,
        "lost": sum(1 for m in slam.metrics if m.get("lost", False)),
        "host_syncs": slam.sync.count,
    }
    if gt is not None:
        if args.synthetic:
            n = min(len(ts_arr), len(gt[1]))
            gt_assoc, mask, poses_eval = gt[1][:n], np.ones(n, bool), poses[:n]
        else:
            gt_assoc, mask = tum.associate_groundtruth(ts_arr, gt[0], gt[1])
            poses_eval = poses
        rmse, _ = align.ate_rmse(
            torch.from_numpy(np.asarray(poses_eval[:, 4:], np.float32)),
            torch.from_numpy(np.asarray(gt_assoc[:, 4:], np.float32)),
            torch.from_numpy(mask.astype(np.float32)),
        )
        summary["ate_rmse_m"] = float(rmse)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
