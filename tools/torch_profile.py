"""Where a frame's time goes in the PyTorch port, on the CUDA card.

Drives ``SlamSystem`` over the first frames of a sequence of
``tools/sequences.py`` (by default ``orbit``, the one of ``chip_smoke.py``
phase 3: full-width ``SlamConfig()``, 120-frame orbit, 1% depth noise) and
measures two ways:

1. stage wall times: each stage of ``frame_step_core`` (frontend, tracking,
   the keyframe event's map ops, local BA) is wrapped in a host clock that
   ends in ``torch.cuda.synchronize()``, so a stage's time includes the
   device work it queued.  These synchronizations are the tool's own.
2. ``torch.profiler`` over a window of frames without those wrappers
   (``boslam_tpu_torch.utils.timing.frame_device_ms``): wall time per
   frame, device busy time (the sum of kernel times on the one stream,
   copies included), the device's idle share, device operations and host
   syncs per frame and the kernels that take the most device time.

    python tools/torch_profile.py [--sequence orbit] [--frames 40]
        [--warmup 10] [--out DIR]

Prints one JSON line; the kernel table goes to ``DIR/torch_profile.txt``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import sequences  # noqa: E402

# Stage name -> (module attribute path) of the functions frame_step_core
# calls.  ``slam`` binds some of them by name at import, so those are
# patched in ``boslam_tpu_torch.slam``; the map ops through their module.
STAGES = {
    "frontend": ("slam", "extract_features"),
    "tracking": ("slam", "track_frame"),
    "local_ba": ("slam", "local_bundle_adjustment"),
    "update_track_stats": ("map_ops", "update_track_stats"),
    "evict": ("map_ops", "evict_for_slot"),
    "insert_keyframe": ("map_ops", "insert_keyframe"),
    "fuse": ("map_ops", "fuse_new_keyframe"),
    "refresh": ("map_ops", "refresh_point_model"),
    "cull_points": ("map_ops", "cull_points"),
    "cull_keyframe": ("map_ops", "cull_one_keyframe"),
}


def _patch(wrap):
    from boslam_tpu_torch import slam
    from boslam_tpu_torch.mapping import map_ops

    mods = {"slam": slam, "map_ops": map_ops}
    saved = []
    for name, (mod, attr) in STAGES.items():
        fn = getattr(mods[mod], attr)
        saved.append((mods[mod], attr, fn))
        setattr(mods[mod], attr, wrap(name, fn))
    return saved


def _restore(saved):
    for mod, attr, fn in saved:
        setattr(mod, attr, fn)


def stage_times(cfg, frames, warmup):
    """{stage: [calls, total ms]} over the frames after ``warmup``, and the
    whole frame's wall ms, every stage synchronized."""
    from boslam_tpu_torch.slam import SlamSystem

    acc = collections.defaultdict(lambda: [0, 0.0])
    live = [False]

    def wrap(name, fn):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            if live[0]:
                acc[name][0] += 1
                acc[name][1] += (time.perf_counter() - t0) * 1e3
            return out
        return timed

    saved = _patch(wrap)
    try:
        slam = SlamSystem(cfg)
        frame_ms = []
        for i, f in enumerate(frames):
            live[0] = i >= warmup
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slam.process_frame(*f)
            torch.cuda.synchronize()
            if live[0]:
                frame_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        _restore(saved)
    return dict(acc), frame_ms


def profile_window(cfg, frames, warmup, top):
    """``utils.timing.frame_device_ms`` over the frames after ``warmup``."""
    from boslam_tpu_torch.slam import SlamSystem
    from boslam_tpu_torch.utils.timing import frame_device_ms

    slam = SlamSystem(cfg)
    for f in frames[:warmup]:
        slam.feed(*f)
    res = frame_device_ms(slam, frames[warmup:])
    rows = sorted(res["by_kernel"].items(), key=lambda kv: -kv[1][1])
    summary = {
        "frames": len(frames) - warmup,
        "wall_ms_per_frame": res["wall_ms"],
        "device_busy_ms_per_frame": res["device_busy_ms"],
        "device_idle_share": res["device_idle_share"],
        "kernel_launches_per_frame": res["device_ops"],
        "host_syncs_per_frame": res["host_syncs"],
        "distinct_kernels": len(rows),
    }
    # The port's own kernels (csrc/*.cu), wherever they rank.
    summary["own_kernels"] = {
        name: {"launches_per_frame": cnt, "device_ms_per_frame": ms}
        for name, (cnt, ms) in rows
        if any(k in name for k in ("fast_rank_kernel", "describe_patches_kernel",
                                   "match_tiles_kernel", "merge_tiles_kernel"))
    }
    table = [f"{'kernel':90s} {'launches/frame':>14s} {'ms/frame':>10s}"]
    for name, (cnt, ms) in rows[:top]:
        table.append(f"{name[:90]:90s} {cnt:14.2f} {ms:10.4f}")
    return summary, "\n".join(table)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequence", choices=sorted(sequences.SEQUENCES),
                    default="orbit")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", type=str, default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile: no CUDA device visible")

    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.io import synthetic
    from boslam_tpu_torch.ops import frontend_cuda as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fc.build_kernels()
    cfg, _, frames = sequences.build(args.sequence, SlamConfig, synthetic,
                                     args.frames)

    stages, frame_ms = stage_times(cfg, frames, args.warmup)
    n = len(frame_ms)
    prof, table = profile_window(cfg, frames, args.warmup, args.top)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "torch_profile.txt"), "w") as fh:
        fh.write(table + "\n")
    print(table, flush=True)
    from boslam_tpu_torch.utils.timing import card

    print(json.dumps({
        "card": card()[0],
        "synchronized": {
            "frames": n,
            "frame_ms_mean": float(np.mean(frame_ms)),
            "frame_ms_median": float(np.median(frame_ms)),
            "stage_ms_per_frame": {k: v[1] / n for k, v in stages.items()},
            "stage_calls": {k: v[0] for k, v in stages.items()},
        },
        "profiled": prof,
    }), flush=True)


if __name__ == "__main__":
    main()
