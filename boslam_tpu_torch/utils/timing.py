"""Per-stage and per-frame timing of the engine on the CUDA card.

The counterpart of ``boslam_tpu.utils.timing``.  It times the three stages
of the frame step (feature extraction, frame-to-map tracking, local bundle
adjustment) on copies of a live engine's state, and the whole frame step
under ``torch.profiler``, and grounds both in the card's peak rates:

* ``stage_timings``: each stage's ms by CUDA events, its kernel time under
  the profiler, and its share of the card's peak FLOP/s and bytes/s;
* ``frame_device_ms``: device busy ms per frame over a window of frames
  fed to an engine, the idle share, device operations and host syncs per
  frame;
* ``step_utilization``: the frame's FLOPs and bytes (``stage_cost``) over
  the device busy ms.

The operation and byte counts are analytic (``stage_cost``): what the
algorithm needs on the config's shapes, each input byte read once and each
output byte written once, so a share never reads above 1.  Every function
that measures raises when it finds no card; none falls back to the CPU.
The stage runners (``stage_runners``) are split from the clocks so that the
CPU can run them.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, NamedTuple, Sequence

import numpy as np
import torch

# Peak rates of the cards the port is measured on (NVIDIA data sheets, dense
# rates at the full power limit): float32 outside the tensor cores, because
# the engine runs with TF32 off, and HBM bytes/s.  Matched in order against
# the lower-cased device name.
_PEAKS = (
    ("h100 pcie", 51e12, 2.0e12),
    ("h100 80gb hbm3", 67e12, 3.35e12),
    ("h100 sxm", 67e12, 3.35e12),
)

STAGES = ("feature", "track", "local_ba")

# Operation counts of stage_cost, per unit of work (see its docstring).
RESIZE_OPS = 12          # per output pixel: 3 taps x (mul, add), two passes
BLUR_OPS = 28            # per pixel: 7 taps x (mul, add), two passes
FAST_OPS = 56            # per pixel: 16 x (sub, 2 compares) + 8 NMS compares
KEYPOINT_OPS = 4 * 32 * 32 + 13 * 256 + 50  # moments, rotated BRIEF, rest
POINT_OPS = 52           # per map point per search: projection + view gate
PAIR_OPS = 35            # per keypoint x point: window, octave, Hamming, top-2
GN_EDGE_OPS = 300        # per edge per GN step: residual, Jacobian, J^T W J
COST_EDGE_OPS = 30       # per edge per cost evaluation
CELL_OPS = 247           # per (camera, point) cell of local BA per iteration
OPT_CELL_OPS = 378       # per (optimized camera, point) cell per iteration
BA_COST_OPS = 40         # per cell per cost evaluation
FEATURE_BYTES = 70       # one FrameFeatures row
TRACK_POINT_BYTES = 70   # map point fields tracking reads + visible written
TRACK_KEYPOINT_BYTES = 59  # keypoint fields tracking reads + its match written
BA_KEYPOINT_BYTES = 21   # per window keyframe slot: obs, valid, uv, depth, octave


def _require_card(device=None) -> None:
    if not torch.cuda.is_available() or (
            device is not None and torch.device(device).type != "cuda"):
        raise RuntimeError("timing runs on a CUDA card and found none")


def card() -> tuple:
    """(``nvidia-smi``'s "name, power limit" line, power limit in W)."""
    _require_card()
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return line, float(line.rsplit(",", 1)[1].strip().split()[0])


def device_peaks(name: str | None = None):
    """(peak FLOP/s, peak bytes/s) of the card named ``name`` (by default
    card 0's ``torch.cuda.get_device_name``), or None for a card not in the
    table: then no share is reported."""
    if name is None:
        _require_card()
        name = torch.cuda.get_device_name(0)
    low = name.lower()
    for key, flops, nbytes in _PEAKS:
        if key in low:
            return flops, nbytes
    return None


def stage_cost(cfg, stage: str) -> tuple:
    """(operations, bytes) of one call of ``stage`` on ``cfg``'s shapes.

    Each input byte is read once and each output byte written once; no
    intermediate is counted.  Operations are the algorithm's arithmetic and
    comparisons at the level the constants above name:

    * ``feature`` (``extract_features`` on f32 gray [H, W] and f32 depth at
      the wire shape): the pyramid's resize into levels 1..L-1, the 7-tap
      blur and FAST with 3x3 NMS over every pixel of every level, and per
      keypoint (``n_features``) its 32x32 intensity moments and 256 rotated
      BRIEF tests; it writes the keypoints' ``FrameFeatures`` rows.
    * ``track`` (``track_frame``): two projection searches (the motion
      model's and the local map's; the widened third runs only when the
      first finds under twice ``min_inliers`` matches and is not counted),
      each projecting and gating every map point and testing every keypoint
      against every point, then ``optimize_pose``'s ``ba_rounds`` x
      ``ba_iters`` GN steps over the keypoints and a cost per round; it
      reads the points' position, descriptor, angle and viewing model and
      the keypoints' fields, and writes each point's visibility and each
      keypoint's match.
    * ``local_ba`` (``local_bundle_adjustment``): the window of ``n_opt_kf``
      + ``n_fixed_kf`` keyframes by ``max_local_points`` points as a dense
      grid, ``lm_iters`` iterations of residuals, Jacobians, the Schur
      build over the optimized keyframes, the point blocks' inverses, the
      reduced camera system's Cholesky solve and the back-substitution,
      and the costs before and after; it reads the window keyframes' pose
      and observation rows, one covisibility row and the points, and writes
      the optimized poses and points.
    """
    from boslam_tpu_torch.features.frontend import pyramid_shapes

    cam, orb = cfg.camera, cfg.orb
    n = orb.n_features
    if stage == "feature":
        shapes = pyramid_shapes(cam.height, cam.width, orb.n_levels,
                                orb.scale_factor)
        pixels = sum(h * w for h, w in shapes)
        resized = pixels - cam.height * cam.width
        hd, wd = cam.depth_wire_shape
        ops = (RESIZE_OPS * resized + (BLUR_OPS + FAST_OPS) * pixels
               + KEYPOINT_OPS * n)
        nbytes = 4 * cam.height * cam.width + 4 * hd * wd + FEATURE_BYTES * n
    elif stage == "track":
        tk, p = cfg.tracker, cfg.map.max_points
        per_search = (POINT_OPS * p + PAIR_OPS * n * p
                      + tk.ba_rounds * n * (tk.ba_iters * GN_EDGE_OPS
                                            + COST_EDGE_OPS))
        ops = 2 * per_search
        nbytes = TRACK_POINT_BYTES * p + TRACK_KEYPOINT_BYTES * n
    elif stage == "local_ba":
        lb = cfg.local_ba
        ko, l = lb.n_opt_kf, lb.max_local_points
        c = ko + lb.n_fixed_kf
        d = 6 * ko
        per_iter = (CELL_OPS * c * l + OPT_CELL_OPS * ko * l
                    + l * (81 + 180 * ko + 216 * ko * ko)
                    + d ** 3 // 3 + 2 * d * d)
        ops = lb.lm_iters * per_iter + 2 * BA_COST_OPS * c * l
        nbytes = (c * (28 + BA_KEYPOINT_BYTES * n) + 5 * cfg.map.max_keyframes
                  + 25 * l + 28 * ko)
    else:
        raise ValueError(f"unknown stage {stage!r}")
    return float(ops), float(nbytes)


class Stage(NamedTuple):
    """One stage on a live engine: ``prepare()`` copies the state the stage
    may write, ``run(*prepare())`` runs it."""

    prepare: Callable[[], tuple]
    run: Callable[..., object]


def _clone(nt):
    return type(nt)(*(t.clone() for t in nt))


def stage_runners(slam, gray, depth) -> Dict[str, Stage]:
    """The three stages on ``slam``'s live state, each on its own copy of
    the map and track state, so that the engine is left as it was.

    ``gray``: [H, W] f32 frame; ``depth``: f32 metres at the wire shape.
    ``track`` tracks this frame's features; ``local_ba`` solves the window
    around the latest keyframe."""
    from boslam_tpu_torch.features.frontend import extract_features
    from boslam_tpu_torch.mapping.map_state import latest_kf_slot
    from boslam_tpu_torch.solvers.local_ba import local_bundle_adjustment
    from boslam_tpu_torch.tracking.tracker import HostSync, track_frame

    cfg, dev = slam.cfg, slam.device
    g = torch.as_tensor(np.asarray(gray, np.float32), device=dev)
    d = torch.as_tensor(np.asarray(depth, np.float32), device=dev)
    feats = extract_features(g, d, cfg)
    center = latest_kf_slot(slam.map)
    return {
        "feature": Stage(lambda: (), lambda: extract_features(g, d, cfg)),
        "track": Stage(lambda: (_clone(slam.map), _clone(slam.track)),
                       lambda m, t: track_frame(cfg, m, t, feats, HostSync())),
        "local_ba": Stage(lambda: (_clone(slam.map),),
                          lambda m: local_bundle_adjustment(cfg, m, center)),
    }


def _device_events(prof):
    """(device µs, device operations, {name: [launches, µs]}) of a
    profile: kernels, copies and fills.  Read from the trace's raw events:
    building the profiler's event tree for ~10^5 events a frame takes
    minutes of host time."""
    busy, n, by_name = 0.0, 0, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        us = e.duration_ns() / 1e3
        busy += us
        n += 1
        rec = by_name.setdefault(e.name(), [0, 0.0])
        rec[0] += 1
        rec[1] += us
    if not n:
        raise RuntimeError("torch.profiler recorded no device activity")
    return busy, n, by_name


def _profile():
    """A profiler of the card's activity only: recording every host
    operation as well would slow the host it measures."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def stage_timings(slam, gray, depth, repeats: int = 7) -> Dict[str, float]:
    """Per stage, on copies of ``slam``'s live state, after two warm-ups:
    ``{stage}_ms``, the median over ``repeats`` calls of CUDA events
    recorded around the call; ``{stage}_device_ms``, its kernel time per
    call under ``torch.profiler``; and on a card of the peak table
    ``{stage}_util_flops`` / ``{stage}_util_hbm`` (``stage_cost`` over
    ``{stage}_ms`` and the peaks) and ``{stage}_bound_by``, which of the
    two bounds the least time."""
    _require_card(slam.device)
    peaks = device_peaks()
    out: Dict[str, float] = {}
    for name, stage in stage_runners(slam, gray, depth).items():
        for _ in range(2):
            stage.run(*stage.prepare())
        times = []
        for _ in range(repeats):
            args = stage.prepare()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            stage.run(*args)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        ms = float(np.median(times))
        argsets = [stage.prepare() for _ in range(repeats)]
        torch.cuda.synchronize()
        with _profile() as prof:
            for args in argsets:
                stage.run(*args)
            torch.cuda.synchronize()
        busy_us, _, _ = _device_events(prof)
        out[f"{name}_ms"] = ms
        out[f"{name}_device_ms"] = busy_us / 1e3 / repeats
        if peaks is not None:
            flops, nbytes = stage_cost(slam.cfg, name)
            out[f"{name}_util_flops"] = flops / (ms * 1e-3) / peaks[0]
            out[f"{name}_util_hbm"] = nbytes / (ms * 1e-3) / peaks[1]
            out[f"{name}_bound_by"] = ("operations" if flops / peaks[0]
                                       >= nbytes / peaks[1] else "bytes")
    return out


def frame_device_ms(slam, frames: Sequence) -> dict:
    """``torch.profiler`` over ``frames`` (``(ts, rgb, depth)``) fed to
    ``slam`` and flushed; the caller warms ``slam`` up first.

    Returns per frame: ``device_busy_ms`` (kernels, copies and fills on the
    card: what a frame costs the card when the host never makes it wait),
    ``wall_ms`` (host clock, synchronized, under the profiler),
    ``device_idle_share``, ``device_ops`` and ``host_syncs`` (``HostSync``
    reads), and ``by_kernel``: {name: [launches, device ms]} per frame."""
    _require_card(slam.device)
    slam.flush()
    torch.cuda.synchronize()
    n, syncs0 = len(frames), slam.sync.count
    with _profile() as prof:
        t0 = time.perf_counter()
        for f in frames:
            slam.feed(*f)
        slam.flush()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, n_ops, by_name = _device_events(prof)
    busy_ms = busy_us / 1e3
    return {
        "device_busy_ms": busy_ms / n,
        "wall_ms": wall_ms / n,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops": n_ops / n,
        "host_syncs": (slam.sync.count - syncs0) / n,
        "by_kernel": {k: [c / n, us / 1e3 / n] for k, (c, us) in by_name.items()},
    }


def step_utilization(cfg, device_step_ms: float, kf_events_per_frame: float,
                     peaks) -> Dict[str, float]:
    """The frame step's share of the card: ``stage_cost`` of feature +
    track + local BA weighted by the keyframe events per frame, over
    ``device_step_ms`` (device busy ms per frame).  ``step_gflops`` per
    frame, ``step_util_flops`` against the peak, ``step_bytes_gbps`` the
    rate the counted bytes move at.  Empty without peaks."""
    if peaks is None or device_step_ms <= 0:
        return {}
    weight = {"feature": 1.0, "track": 1.0, "local_ba": kf_events_per_frame}
    flops = nbytes = 0.0
    for stage, w in weight.items():
        f, b = stage_cost(cfg, stage)
        flops += w * f
        nbytes += w * b
    sec = device_step_ms * 1e-3
    return {
        "step_gflops": flops / 1e9,
        "step_util_flops": flops / sec / peaks[0],
        "step_bytes_gbps": nbytes / sec / 1e9,
    }
