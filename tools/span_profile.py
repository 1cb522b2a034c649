"""Where the engine's time goes, read from its own spans, on the CUDA card.

Runs a benchmark cell's traffic through the port with the span recorder on
(``SlamSystem(trace=True)``, ``HostSync(trace=True)``): a frame cell's
sequence rendered on the card by ``slambench/render.py`` and fed frame by
frame, or the global-BA cell's problem solved again and again.  Prints one
JSON line per part, and writes the lines to ``DIR/span_profile.jsonl``:

* ``cost``: what the recorder costs.  Frames (or solves) alternate between
  the recorder on and off in one engine for ``--seconds``; the medians of
  each side (plain frames only), and the host's cost of one span measured
  alone, times the spans a frame opens.
* ``spans``: each span's median ms over the traced frames or solves, and
  what the benchmark's span metrics would read over them.
* ``profile``: ``torch.profiler`` over ``--trace-frames`` frames (or one
  solve) after the window, the spans mapped onto its clock
  (``utils.timing.clock_map``): device operations and device ms launched
  inside each span and the device's idle ms while each span was innermost
  on the host, per frame (``utils.timing.attribute``); the mapping's check
  by the host's reads (``clock_slack``); the share of the plain frames'
  ``frame`` time their child spans cover; for global BA, each CG
  application's device operations and device ms.

    python tools/span_profile.py --cell hall.live [--seconds 30]
        [--seed 7] [--trace-frames 32] [--out DIR]
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "slambench"))

import torch  # noqa: E402

import core  # noqa: E402
from boslam_tpu_torch.tracking.tracker import HostSync  # noqa: E402
from boslam_tpu_torch.utils import timing  # noqa: E402

KF_EVENTS = ("init", "keyframe", "loop_closed")


def _emit(out, part, rec):
    line = json.dumps(dict(part=part, **rec))
    print(line, flush=True)
    with open(os.path.join(out, "span_profile.jsonl"), "a") as f:
        f.write(line + "\n")


def span_cost_ns(n=200_000):
    """Host ns of one span opened and closed with the recorder on, and of
    the off path's shared no-op."""
    out = {}
    for trace in (True, False):
        sync = HostSync(trace)
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with sync.span("x"):
                pass
        out["on" if trace else "off"] = (time.perf_counter_ns() - t0) / n
    return out


def _by_name(spans):
    got = {}
    for s in spans:
        got.setdefault(s.name, []).append((s.t1 - s.t0) / 1e6)
    return got


def _top(d, n, key):
    return dict(sorted(d.items(), key=key, reverse=True)[:n])


def frames_cell(spec, args, out):
    import render
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.ops.build import build_kernels
    from boslam_tpu_torch.slam import SlamSystem

    dev = torch.device("cuda")
    slam_cfg = spec["config_spec"]["slam"]
    tr = spec["traffic_spec"]
    cfg = SlamConfig.from_dict(slam_cfg)
    traj = render.trajectory(tr["path"])
    frames = render.render_wire(
        render.Camera.from_config(slam_cfg), traj,
        depth_noise=tr["depth_noise"], room_scale=tr["room_scale"],
        generator=torch.Generator(device=dev).manual_seed(args.seed),
        device=dev)
    build_kernels()
    warm = SlamSystem(cfg, seed=args.seed, chunk=tr["chunk"], device=dev)
    for f in frames[:tr["warmup_frames"]]:
        warm.feed(*f)
    warm.flush()
    del warm
    torch.cuda.synchronize()

    # The window: frames alternate between the recorder on and off.
    slam = SlamSystem(cfg, seed=args.seed, chunk=tr["chunk"], device=dev)
    times = {True: [], False: []}
    spans, pos = [], 0
    t_open = time.perf_counter()
    while time.perf_counter() - t_open < args.seconds \
            and pos < len(frames) - args.trace_frames:
        on = pos % 2 == 1
        slam.sync.trace = on
        n_rec = len(slam.metrics)
        t0 = time.perf_counter()
        slam.feed(*frames[pos])
        dt = time.perf_counter() - t0
        spans += slam.sync.drain()
        if slam.metrics[n_rec:] and \
                slam.metrics[-1].get("event") not in KF_EVENTS:
            times[on].append(dt * 1e3)
        pos += 1
    window_frames = pos
    per_span = span_cost_ns()
    n_on = window_frames // 2
    spans_per_frame = len(spans) / max(n_on, 1)
    _emit(out, "cost", {
        "cell": spec["name"], "frames": window_frames,
        "plain_ms_mean_on": statistics.mean(times[True]),
        "plain_ms_mean_off": statistics.mean(times[False]),
        "plain_ms_p50_on": statistics.median(times[True]),
        "plain_ms_p50_off": statistics.median(times[False]),
        "plain_frames_on": len(times[True]),
        "plain_frames_off": len(times[False]),
        "span_ns_on": per_span["on"], "span_ns_off": per_span["off"],
        "spans_per_traced_frame": spans_per_frame,
        "recorder_ms_per_frame": per_span["on"] * spans_per_frame / 1e6})

    by = _by_name(spans)
    frames_on = {s.request for s in spans if s.name == "frame"}
    kf_frames = {s.request for s in spans if s.name == "frame.keyframe"}
    waits = sum((s.t1 - s.t0) / 1e6 for s in spans
                if s.name in ("sync.read", "flush.readback"))
    _emit(out, "spans", {
        "cell": spec["name"], "traced_frames": len(frames_on),
        "keyframe_frames": len(kf_frames),
        "median_ms": {k: statistics.median(v) for k, v in by.items()},
        "count": {k: len(v) for k, v in by.items()},
        "frontend_ms_p50": statistics.median(by["frame.frontend"]),
        "track_ms_p50": statistics.median(by["frame.track"]),
        "kf_event_ms_p50": statistics.median(by.get("frame.keyframe", [0])),
        "local_ba_ms_p50": statistics.median(by.get("keyframe.local_ba",
                                                    [0])),
        "sync_wait_ms_per_frame": waits / max(len(frames_on), 1)})

    # The profiled frames, all traced.
    slam.sync.trace = True
    slam.sync.drain()
    syncs0 = slam.sync.count
    take = frames[pos:pos + args.trace_frames]

    def run():
        for f in take:
            slam.feed(*f)
        slam.flush()

    got = timing.profile_spans(run, slam.sync)
    pspans, to_clock = got["spans"], got["to_clock"]
    n = len(take)
    ops = got["ops_by_span"]
    front = [op for op in got["device_ops"]
             if "fast_rank_kernel" in op[2] or "describe_patches_kernel"
             in op[2]]
    front_spans = [s for s in pspans if s.name == "frame.frontend"]
    iv = sorted((to_clock(s.t0), to_clock(s.t1)) for s in front_spans)
    launched = timing.launch_times(got["calls"])
    front_in = sum(1 for op in front
                   if any(a <= launched.get(op[3], -1) <= b for a, b in iv))
    kids = {}
    for s in pspans:
        kids.setdefault(s.parent, 0)
        kids[s.parent] += s.t1 - s.t0
    plain = [s for s in pspans if s.name == "frame" and s.request not in
             {k.request for k in pspans if k.name == "frame.keyframe"}]
    cover = [kids.get(s.id, 0) / (s.t1 - s.t0) for s in plain]
    total_ops = sum(v[0] for v in ops.values())
    outside = ops.get(timing.NO_SPAN, [0])[0] + \
        ops.get(timing.NO_LAUNCH, [0])[0]
    _emit(out, "profile", {
        "cell": spec["name"], "frames": n,
        "host_syncs_per_frame": (slam.sync.count - syncs0) / n,
        "ops_per_frame": total_ops / n,
        "attributed_share": 1.0 - outside / max(total_ops, 1),
        "busy_s": got["busy_s"], "window_s": got["window_s"],
        "idle_share": 1.0 - got["busy_s"] / got["window_s"],
        "ops_by_span": _top({k: [v[0] / n, v[1] * 1e3 / n]
                             for k, v in ops.items()}, 30,
                            key=lambda kv: kv[1][0]),
        "idle_by_span_ms": _top({k: v * 1e3 / n
                                 for k, v in got["idle_by_span"].items()},
                                30, key=lambda kv: kv[1]),
        "frontend_kernels": len(front), "frontend_kernels_in_frontend":
            front_in,
        "plain_frame_cover_min": min(cover) if cover else None,
        "plain_frame_cover_median": statistics.median(cover) if cover
        else None,
        "clock_offset_ns": got["offset_ns"], "clock_slack": got["slack"]})


def _cg_apply_bound_s(cfg, st):
    """The least time of one CG application on the H100's peaks, counted
    from its inputs' shapes by ``chip_smoke.cg_bytes_ops`` on the first LM
    iteration's system."""
    import chip_smoke
    from boslam_tpu_torch.solvers import global_ba as gba

    dev = st.kf_pose.device
    P = st.pt_xyz.shape[0]
    K, N = st.kf_obs_pt.shape
    edges = gba.build_global_edges(cfg, st)
    sched = gba._point_schedule(edges, P)
    mask = st.kf_valid & (torch.arange(K, device=dev) > 0)
    (_, Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d, _, Hpp_inv, _) = gba._assemble(
        cfg, st.kf_pose, st.pt_xyz, edges, sched, mask,
        torch.tensor(1e-4, device=dev), cfg.local_ba.huber_delta, K, N)
    x = torch.zeros(K, 6, device=dev)
    n_bytes, n_ops = chip_smoke.cg_bytes_ops(
        (Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d, Hpp_inv, sched), x)
    return max(n_bytes / chip_smoke.PEAK_BYTES_PER_S,
               n_ops / chip_smoke.PEAK_F32_OPS_PER_S)


def gba_cell(spec, args, out):
    import gba
    import problem
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.solvers import global_ba

    dev = torch.device("cuda")
    slam_cfg = spec["config_spec"]["slam"]
    tr = dict(spec["traffic_spec"])
    if args.rehearsal:
        tr.update(tr["rehearsal"])
    cfg = SlamConfig.from_dict(slam_cfg)
    raw = problem.make(tr, slam_cfg, args.seed)
    state = gba._program_map(cfg, raw, dev)

    def solve(sync):
        return global_ba.global_bundle_adjustment(
            cfg, state, lm_iters=tr["lm_iters"], cg_iters=tr["cg_iters"],
            sync=sync)

    solve(HostSync())
    torch.cuda.synchronize()
    times = {True: [], False: []}
    spans = []
    t_open = time.perf_counter()
    i = 0
    while time.perf_counter() - t_open < args.seconds:
        on = i % 2 == 1
        sync = HostSync(on)
        t0 = time.perf_counter()
        solve(sync)
        torch.cuda.synchronize()
        times[on].append((time.perf_counter() - t0) * 1e3)
        spans += sync.drain()
        i += 1
    per_span = span_cost_ns()
    n_on = len(times[True])
    pairs = [b - a for a, b in zip(times[False], times[True])]
    _emit(out, "cost", {
        "cell": spec["name"], "solves": i,
        "paired_ms_p50_on_minus_off": statistics.median(pairs),
        "paired_ms_quartiles": statistics.quantiles(pairs, n=4),
        "solve_ms_p50_on": statistics.median(times[True]),
        "solve_ms_p50_off": statistics.median(times[False]),
        "span_ns_on": per_span["on"], "span_ns_off": per_span["off"],
        "spans_per_solve": len(spans) / max(n_on, 1),
        "recorder_ms_per_solve":
            per_span["on"] * len(spans) / max(n_on, 1) / 1e6})
    by = _by_name(spans)
    _emit(out, "spans", {
        "cell": spec["name"], "traced_solves": n_on,
        "median_ms": {k: statistics.median(v) for k, v in by.items()},
        "count_per_solve": {k: len(v) / n_on for k, v in by.items()}})

    sync = HostSync(True)
    got = timing.profile_spans(lambda: solve(sync), sync)
    pspans, to_clock = got["spans"], got["to_clock"]
    launched = timing.launch_times(got["calls"])
    starts = sorted((launched[op[3]], op) for op in got["device_ops"]
                    if op[3] in launched)
    keys = [t for t, _ in starts]
    per_apply = []
    for s in pspans:
        if s.name != "gba.cg_apply":
            continue
        a, b = to_clock(s.t0), to_clock(s.t1)
        inside = [op for _, op in starts[bisect.bisect_left(keys, a):
                                         bisect.bisect_right(keys, b)]]
        per_apply.append((len(inside), sum(op[1] - op[0] for op in inside)))
    ops = got["ops_by_span"]
    n_apply = len(per_apply)
    mean_s = sum(d for _, d in per_apply) / max(n_apply, 1) / 1e9
    bound_s = _cg_apply_bound_s(cfg, state)
    _emit(out, "profile", {
        "cell": spec["name"], "rehearsal": args.rehearsal,
        "busy_s": got["busy_s"], "window_s": got["window_s"],
        "idle_share": 1.0 - got["busy_s"] / got["window_s"],
        "ops_by_span": {k: [v[0], v[1] * 1e3] for k, v in ops.items()},
        "idle_by_span_ms": {k: v * 1e3
                            for k, v in got["idle_by_span"].items()},
        "cg_applications": n_apply,
        "ops_per_application": sorted({c for c, _ in per_apply}),
        "application_device_ms_mean": mean_s * 1e3,
        "application_bound_ms": bound_s * 1e3,
        "application_roofline_pct": 100.0 * bound_s / mean_s,
        "application_device_ms": [d / 1e6 for _, d in per_apply[:8]],
        "clock_offset_ns": got["offset_ns"], "clock_slack": got["slack"]})


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tools/span_profile.py")
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--trace-frames", type=int, default=32)
    ap.add_argument("--rehearsal", action="store_true",
                    help="global BA at the mix's small rehearsal size")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("tools/span_profile.py runs on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    spec = core.cell(args.cell)
    card, watts = timing.card()
    _emit(args.out, "card", {"card": card, "power_limit_w": watts,
                             "torch": torch.__version__})
    if spec["traffic_spec"]["kind"] == "frames":
        frames_cell(spec, args, args.out)
    else:
        gba_cell(spec, args, args.out)


if __name__ == "__main__":
    main()
