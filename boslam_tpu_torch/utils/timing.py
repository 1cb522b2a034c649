"""Per-stage and per-frame timing of the engine on the CUDA card.

The counterpart of ``boslam_tpu.utils.timing``.  It times the whole frame
step under ``torch.profiler``, grounds it in the card's peak rates, and
lays the engine's spans (``tracking.tracker.HostSync``) over the
profiler's device trace:

* ``frame_device_ms``: device busy ms per frame over a window of frames
  fed to an engine, the idle share, device operations and host syncs per
  frame;
* ``step_utilization``: the frame's FLOPs and bytes (``stage_cost``) over
  the device busy ms;
* ``clock_pair`` / ``clock_map``: the spans' clock
  (``time.perf_counter_ns``) mapped onto the profiler's (Unix ns);
* ``attribute``: each device operation to the innermost span open when
  the host launched it, and each stretch of the device's idle time to the
  innermost span open on the host meanwhile; ``clock_slack`` checks the
  mapping against the runtime calls of the host's reads;
  ``profile_spans`` runs a callable under the profiler and does both;
* ``chrome_events``: the spans as Chrome trace events beside the
  profiler's trace (``main.py --profile``).

The operation and byte counts are analytic (``stage_cost``): what the
algorithm needs on the config's shapes, each input byte read once and each
output byte written once, so a share never reads above 1.  Every function
that measures on the card raises when it finds none; none falls back to
the CPU.  The span functions take plain records, so the CPU runs them.
"""

from __future__ import annotations

import bisect
import re
import subprocess
import time
from typing import Dict, Sequence

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


# --- spans on the profiler's clock ------------------------------------------

NO_SPAN = "no span"
NO_LAUNCH = "no launch record"


def clock_pair() -> tuple:
    """(``time.perf_counter_ns()``, ``time.time_ns()``) read back to back.
    The profiler stamps its events in Unix nanoseconds."""
    return time.perf_counter_ns(), time.time_ns()


def clock_map(before: tuple, after: tuple):
    """The spans' clock onto the profiler's: a function of a
    ``perf_counter_ns`` reading, linear through two ``clock_pair()``s read
    around the profiled window (the two clocks drift apart by a few parts
    per million)."""
    (p0, u0), (p1, u1) = before, after
    rate = (u1 - u0) / (p1 - p0) if p1 > p0 else 1.0
    return lambda t: u0 + round((t - p0) * rate)


def profiler_records(prof):
    """(device operations, runtime calls) of a profile's raw events, each
    [(start ns, end ns, name, correlation id)] sorted by start.  A device
    operation and the runtime call that launched it share a correlation
    id; with ``ProfilerActivity.CUDA`` alone the host's events are those
    runtime calls."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        t0 = e.start_ns()
        rec = (t0, t0 + e.duration_ns(), e.name(), e.correlation_id())
        (dev if e.device_type() == torch.autograd.DeviceType.CUDA
         else host).append(rec)
    dev.sort()
    host.sort()
    return dev, host


def launch_times(calls) -> Dict[int, int]:
    """{correlation id: start ns} of the runtime calls that launched
    device work (a lazy module load shares its launch's id and starts
    inside it: the earliest call is the launch)."""
    out: Dict[int, int] = {}
    for t0, _, _, corr in calls:
        out.setdefault(corr, t0)
    return out


def _innermost(intervals):
    """Properly nested [(t0, t1, name)] -> the disjoint stretches
    [(start, end, name)], in order, over which ``name`` is the innermost
    interval open; stretches with none open are left out."""
    out, stack, cur = [], [], None
    for t0, t1, name in sorted(intervals, key=lambda iv: (iv[0], -iv[1])):
        while stack and stack[-1][0] <= t0:
            end, top = stack.pop()
            out.append((cur, end, top))
            cur = end
        if stack:
            out.append((cur, t0, stack[-1][1]))
        stack.append((t1, name))
        cur = t0
    while stack:
        end, top = stack.pop()
        out.append((cur, end, top))
        cur = end
    return [s for s in out if s[1] > s[0]]


def attribute(spans, to_clock, device_ops, calls, window=None) -> dict:
    """The device's work and idle time by span.

    ``spans``: ``HostSync`` spans; ``to_clock`` maps their times onto the
    profiler's (``clock_map``); ``device_ops`` and ``calls`` as
    ``profiler_records`` returns them.  Each device operation goes to the
    innermost span open when its runtime call started, wherever it ran
    (``NO_SPAN`` if none was open; ``NO_LAUNCH`` if its call is missing).
    The device is idle outside the union of its operations within
    ``window`` ((start, end) on the profiler's clock; by default from the
    first operation's start to the last one's end), and each idle stretch
    is split by time among the innermost spans open on the host
    meanwhile.  Returns ``ops_by_span`` {name: [operations, device s]},
    ``idle_by_span`` {name: idle s}, ``busy_s`` and ``window_s``."""
    segs = _innermost([(to_clock(s.t0), to_clock(s.t1), s.name)
                       for s in spans])
    starts = [s[0] for s in segs]

    def at(t):
        i = bisect.bisect_right(starts, t) - 1
        return segs[i][2] if i >= 0 and t < segs[i][1] else NO_SPAN

    launched = launch_times(calls)
    ops: Dict[str, list] = {}
    for t0, t1, _, corr in device_ops:
        t = launched.get(corr)
        rec = ops.setdefault(NO_LAUNCH if t is None else at(t), [0, 0.0])
        rec[0] += 1
        rec[1] += (t1 - t0) / 1e9
    if window is None:
        window = (device_ops[0][0], max(op[1] for op in device_ops)) \
            if device_ops else (0, 0)
    lo, hi = window
    idle_iv, cur, busy = [], lo, 0
    for t0, t1, _, _ in device_ops:
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 <= cur:
            continue
        if t0 > cur:
            idle_iv.append((cur, t0))
        busy += t1 - max(t0, cur)
        cur = t1
    if cur < hi:
        idle_iv.append((cur, hi))
    idle: Dict[str, float] = {}
    for a, b in idle_iv:
        i = bisect.bisect_right(starts, a) - 1
        if i < 0 or segs[i][1] <= a:
            i += 1  # the first stretch that ends after ``a``
        t = a
        while t < b:
            if i < len(segs) and segs[i][0] <= t:
                end, name = min(segs[i][1], b), segs[i][2]
                i += 1
            else:
                end = min(segs[i][0], b) if i < len(segs) else b
                name = NO_SPAN
            idle[name] = idle.get(name, 0.0) + (end - t) / 1e9
            t = end
    return {"ops_by_span": ops, "idle_by_span": idle, "busy_s": busy / 1e9,
            "window_s": (hi - lo) / 1e9}


def clock_slack(spans, to_clock, calls) -> dict:
    """How far ``to_clock`` may be off, read from the host's reads: each
    ``sync.read`` span holds the runtime calls of its read (the copy and
    the wait), so a mapping off by less than ``before_ns`` early or
    ``after_ns`` late keeps every read's calls inside its span: the least
    time from a read span's start to its first call and from its last
    call's end to the span's end.  ``reads`` counts the read spans,
    ``empty`` those in which no call starts."""
    starts = [c[0] for c in calls]
    before = after = None
    reads = empty = 0
    for s in spans:
        if s.name != "sync.read":
            continue
        reads += 1
        a, b = to_clock(s.t0), to_clock(s.t1)
        inside = calls[bisect.bisect_left(starts, a):
                       bisect.bisect_right(starts, b)]
        if not inside:
            empty += 1
            continue
        lo = inside[0][0] - a
        hi = b - max(c[1] for c in inside)
        before = lo if before is None else min(before, lo)
        after = hi if after is None else min(after, hi)
    return {"reads": reads, "empty": empty, "before_ns": before,
            "after_ns": after}


def profile_spans(run, sync) -> dict:
    """``run()`` under ``torch.profiler`` (card activity only), the spans
    it closed taken from ``sync`` and mapped onto the profiler's clock by
    a ``clock_pair()`` on either side: ``attribute``'s result over the
    run, with ``slack`` (``clock_slack``), the clocks' ``offset_ns`` at
    the start, ``spans``, ``device_ops``, ``calls`` and ``to_clock``
    beside it."""
    _require_card()
    torch.cuda.synchronize()
    with _profile() as prof:
        before = clock_pair()
        run()
        torch.cuda.synchronize()
        after = clock_pair()
    to_clock = clock_map(before, after)
    dev, calls = profiler_records(prof)
    spans = sync.drain()
    got = attribute(spans, to_clock, dev, calls,
                    window=(to_clock(before[0]), to_clock(after[0])))
    got.update(slack=clock_slack(spans, to_clock, calls),
               offset_ns=before[1] - before[0], spans=spans, device_ops=dev,
               calls=calls, to_clock=to_clock)
    return got


def trace_base_ns(path: str) -> int:
    """The ``baseTimeNanoseconds`` of a profiler trace (its header's time
    origin: the trace's ``ts`` count microseconds from it), else 0."""
    with open(path, "rb") as f:
        head = f.read(1 << 16).decode("utf-8", "replace")
    m = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    return int(m.group(1)) if m else 0


def chrome_events(spans, to_clock, base_ns: int = 0) -> list:
    """The spans as Chrome trace complete events ("X") on the profiler's
    clock, in microseconds from ``base_ns`` (``trace_base_ns`` of the
    profiler's trace), on a host row of their own, each with its request."""
    return [{"ph": "X", "name": s.name, "pid": "host spans", "tid": 0,
             "ts": (to_clock(s.t0) - base_ns) / 1e3,
             "dur": (s.t1 - s.t0) / 1e3, "args": {"request": s.request}}
            for s in sorted(spans, key=lambda s: (s.t0, -s.t1))]
