"""CLI: run the PyTorch port on a TUM or ICL-NUIM RGBD sequence or the
synthetic fixture.

Examples:
    python -m boslam_tpu_torch.main --synthetic 120 --out traj.txt
    python -m boslam_tpu_torch.main --synthetic 120 --global-ba
    python -m boslam_tpu_torch.main --tum /data/rgbd_dataset_freiburg1_xyz \
        --camera fr1 --out traj.txt --metrics run.jsonl
    python -m boslam_tpu_torch.main --synthetic 60 --async-mapping \
        --mapping-device 0 --checkpoint-every 5 --checkpoint-dir ckpt
    python -m boslam_tpu_torch.main --synthetic 60 --resume ckpt
        (the restored engine is fed the sequence again from frame 0)
    BOSLAM_COORDINATOR=host0:8476 BOSLAM_NUM_PROCESSES=2 \
        BOSLAM_PROCESS_ID=0 python -m boslam_tpu_torch.main --synthetic 120 \
        --distributed --global-ba     (and PROCESS_ID=1 on the other rank;
        see parallel/distributed.py, torchrun works too)

Runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path.
``--viz``, ``--metrics-tb`` and ``--config`` need matplotlib, tensorboard
and PyYAML, which the rest of the port does without.  Prints one JSON line:
the summary of the run's metric records, its counts and, when groundtruth
exists, its ATE.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description="boslam_tpu_torch RGBD SLAM")
    ap.add_argument("--tum", type=str, help="TUM sequence directory")
    ap.add_argument("--icl", type=str, help="ICL-NUIM sequence directory")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N synthetic frames instead of a dataset")
    ap.add_argument("--camera", choices=["fr1", "fr2", "fr3", "icl"],
                    default="fr1")
    ap.add_argument("--config", type=str, default=None,
                    help="YAML config file; sections override the --camera "
                         "preset (see SlamConfig.from_yaml; needs PyYAML)")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--out", type=str, default="trajectory.txt")
    ap.add_argument("--metrics", type=str, default=None,
                    help="write the per-frame metric records to this JSONL")
    ap.add_argument("--metrics-tb", type=str, default=None,
                    help="TensorBoard logdir: mirror the per-frame metric "
                         "records as scalars (needs tensorboard)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save engine state every N keyframes")
    ap.add_argument("--checkpoint-dir", type=str, default="ckpt")
    ap.add_argument("--resume", type=str, default=None,
                    help="checkpoint directory to resume from")
    ap.add_argument("--profile", type=str, default=None,
                    help="torch.profiler trace logdir; the engine's spans "
                         "go beside the trace, on its clock (spans.json)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--global-ba", action="store_true",
                    help="run full-map BA after loop closures AND at exit")
    ap.add_argument("--distributed", action="store_true",
                    help="join the torch.distributed process group (NCCL "
                         "on the cards, gloo with --device cpu) and run "
                         "global BA landmark-sharded over all its ranks; "
                         "see parallel/distributed.py for the launch recipe")
    ap.add_argument("--viz", type=str, default=None,
                    help="render the final map + trajectory to this PNG "
                         "(needs matplotlib)")
    ap.add_argument("--async-mapping", action="store_true",
                    help="defer local BA to the flushes (the reference's "
                         "mapping thread); keyframe frames pay only "
                         "insert/fuse/cull")
    ap.add_argument("--mapping-device", type=int, default=None,
                    help="CUDA device index of the deferred solves (the "
                         "working card: a second CUDA stream); implies "
                         "--async-mapping")
    ap.add_argument("--no-native-loader", action="store_true",
                    help="decode PNGs with cv2 (default: the C++ "
                         "prefetching decoder when it builds and loads)")
    args = ap.parse_args()

    import torch

    if args.distributed:
        # Before anything touches CUDA: the rank's card is chosen here.
        from boslam_tpu_torch.device import resolve_device
        from boslam_tpu_torch.parallel.distributed import (
            maybe_initialize, rank_device,
        )

        args.device = str(rank_device(resolve_device(args.device)))
        maybe_initialize(force=True, device=args.device)

    from boslam_tpu_torch.config import (
        ICL_NUIM, SlamConfig, TUM_FR1, TUM_FR2, TUM_FR3,
    )
    from boslam_tpu_torch.geometry import align
    from boslam_tpu_torch.io import icl_nuim
    from boslam_tpu_torch.io import synthetic as synth
    from boslam_tpu_torch.io import tum
    from boslam_tpu_torch.slam import SlamSystem
    from boslam_tpu_torch.utils import checkpoint as ckpt
    from boslam_tpu_torch.utils.metrics import (
        dump_metrics, profile_trace, summarize,
    )

    if args.icl:
        args.camera = "icl"
    cam = {"fr1": TUM_FR1, "fr2": TUM_FR2, "fr3": TUM_FR3,
           "icl": ICL_NUIM}[args.camera]
    cfg = SlamConfig(camera=cam)
    if args.config:
        cfg = SlamConfig.from_yaml(args.config, base=cfg)
    if args.global_ba:
        import dataclasses

        cfg = cfg.replace(
            loop=dataclasses.replace(cfg.loop, run_global_ba=True)
        )

    native = False if args.no_native_loader else None
    gt = None
    if args.synthetic:
        traj = synth.orbit_trajectory(args.synthetic, radius=0.6, loop=True)
        frames = synth.render_sequence(cfg.camera, traj)
        gt = (traj.timestamps, traj.poses_twc)
    elif args.tum:
        frames = tum.sequence(args.tum, cfg.camera.depth_factor,
                              limit=args.limit, native=native)
        try:
            gt = tum.read_groundtruth(f"{args.tum}/groundtruth.txt")
        except OSError:
            pass
    elif args.icl:
        frames = icl_nuim.sequence(args.icl, cfg.camera.depth_factor,
                                   limit=args.limit, native=native)
        try:
            gt = icl_nuim.read_groundtruth(args.icl)
        except OSError:
            pass
    else:
        ap.error("need --tum, --icl or --synthetic")

    ba_mesh = None
    if args.distributed:
        from boslam_tpu_torch.parallel.distributed import runtime_info
        from boslam_tpu_torch.parallel.mesh import make_mesh

        info = runtime_info()
        print(f"[distributed] {info}", file=sys.stderr)
        if info["global_devices"] > 1:
            ba_mesh = make_mesh(seq=1)
            print(
                f"[distributed] global BA sharded over "
                f"pt={ba_mesh.shape['pt']} devices", file=sys.stderr,
            )

    slam = SlamSystem(cfg, seed=args.seed, device=args.device,
                      async_mapping=args.async_mapping,
                      mapping_device=args.mapping_device, ba_mesh=ba_mesh,
                      trace=bool(args.profile))
    if args.resume:
        # As the reference's CLI does: the restored engine is fed the
        # sequence again from its first frame.
        ckpt.restore(args.resume, slam)
        print(f"resumed from {args.resume}: {slam.n_keyframes} keyframes, "
              f"{len(slam.timestamps)} frames", file=sys.stderr)

    last_ckpt_kf = slam.n_keyframes
    with profile_trace(args.profile, slam.sync) as step:
        for i, (ts, rgb, depth) in enumerate(frames):
            slam.process_frame(ts, rgb, depth)
            step()
            m = slam.metrics[-1]
            if i % 25 == 0:
                print(
                    f"[{i}] kf={slam.n_keyframes} pts={slam.n_points} "
                    f"inl={m.get('n_inliers', 0)} {m.get('event', '')}",
                    file=sys.stderr,
                )
            if (
                args.checkpoint_every
                and slam.n_keyframes >= last_ckpt_kf + args.checkpoint_every
            ):
                ckpt.save(args.checkpoint_dir, slam)
                last_ckpt_kf = slam.n_keyframes

    if args.global_ba:
        slam.flush()
        rec = slam.run_global_ba()
        print(f"global BA: cost {rec['gba_cost0']:.1f} -> {rec['gba_cost1']:.1f} "
              f"({rec['gba_edges']} edges)", file=sys.stderr)
    ts_arr, poses = slam.trajectory()
    tum.save_trajectory(args.out, ts_arr, poses)
    print(f"wrote {len(ts_arr)} poses to {args.out}", file=sys.stderr)

    summary = summarize(slam.metrics)
    summary.update(
        device=str(slam.device),
        frames=len(ts_arr),
        keyframes=slam.n_keyframes,
        points=slam.n_points,
        lost=sum(1 for m in slam.metrics if m.get("lost", False)),
        host_syncs=slam.sync.count,
    )
    if gt is not None:
        if args.synthetic:
            # Over the overlap, should a resume have been given another N.
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

    if args.metrics:
        dump_metrics(args.metrics, slam.metrics)
    if args.metrics_tb:
        from boslam_tpu_torch.utils.metrics import export_tensorboard

        export_tensorboard(args.metrics_tb, slam.metrics)
        print(f"wrote TensorBoard scalars to {args.metrics_tb}",
              file=sys.stderr)
    if args.viz:
        from boslam_tpu_torch.viz import render_map

        render_map(
            slam.map, trajectory=poses,
            groundtruth=gt[1] if (gt is not None and args.synthetic) else None,
            out_path=args.viz,
        )
        print(f"wrote map view to {args.viz}", file=sys.stderr)


if __name__ == "__main__":
    main()
