"""The frame cells: a camera stream replayed through ``SlamSystem.feed``.

A run is four stages, each a function that another runner imports
(``loops.py`` does), composed by ``run_cell`` around the runner's probes:

- ``setup`` renders the mix's path on the device (its first ``prefix``
  frames where the mix names a prefix; the depth noise drawn from the
  mix's ``render_seed``, else from ``--seed``) and brings it to the host in
  the engine's wire format (users' frames arrive from the host), builds the
  kernels and warms an engine up on the sequence's first frames (the init
  frame, tracked frames, keyframes with inline local BA and the first
  vocabulary training), then drops that engine.  Its ``make_engine`` builds
  every engine of the run alike: the configuration's ``engine`` keywords,
  and with ``--trace 1`` the engine's span recorder on.
- ``window`` feeds the frames to a fresh engine one by one, closed loop: a
  frame is fed once the last one's pose is on the host (``chunk`` 1 flushes
  inside ``feed``).  A run that reaches the sequence's end flushes the
  engine and replays the same frames on a fresh engine.  A frame is timed
  from its ``feed`` call to its pose on the host.  A CPU rehearsal also
  runs until the mix's ``rehearsal.frames`` frames are done.
- ``traced`` profiles ``trace_frames`` more frames after the window.
- ``check``, once the window has closed, holds every engine's trajectory
  to the ground truth, a sample of the keyframes the map holds to the plain
  frontend (``reference.frontend``) run on the same frames, and adds each
  probe's numbers: ``LocalBaProbe`` holds the window's last local-BA solve
  to the plain local BA (``reference.ba``, float64) over the same map.

A probe wraps a program function from outside while its ``on`` is set
(inside the window), has ``close()``, which puts the function back, and
``values(slam_cfg, device)``, its numbers for the check.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

import profiling
import render
from reference import ba as ref_ba
from reference.frontend import Frontend
from reference.geometry import ate_rmse

KF_EVENTS = ("init", "keyframe", "loop_closed")  # a closed loop's keyframe
UV_ATOL = 1e-3      # pixels
DEPTH_ATOL = 1e-4   # metres
# The map's arrays that local BA reads, by the reference's names.
LBA_INPUTS = {"kf_pose": "kf_pose", "pt_xyz": "pt_xyz", "covis": "covis",
              "kf_valid": "kf_valid", "kf_obs_pt": "kf_obs",
              "pt_valid": "pt_valid", "kf_kp_valid": "kf_kpv",
              "kf_uv": "kf_uv", "kf_depth": "kf_depth",
              "kf_octave": "kf_octave"}
ENGINE_OPTIONS = ("async_mapping", "mapping_device")


class LocalBaProbe:
    """Local BA as the frame step calls it (``slam.local_bundle_adjustment``),
    watched from outside: while ``on``, ``last`` holds the newest solve's
    input map, center, the poses and points it wrote back and the costs it
    reported, copied on the device (no host read)."""

    def __init__(self, slam_module):
        self.module = slam_module
        self.solve = slam_module.local_bundle_adjustment
        self.last, self.on = None, False
        slam_module.local_bundle_adjustment = self

    def __call__(self, cfg, state, center):
        out, stats = self.solve(cfg, state, center)
        if self.on:
            self.last = ({LBA_INPUTS[k]: getattr(state, k).clone()
                          for k in LBA_INPUTS}, center.clone(),
                         out.kf_pose.clone(), out.pt_xyz.clone(), stats)
        return out, stats

    def close(self):
        self.module.local_bundle_adjustment = self.solve

    def values(self, slam_cfg, device):
        """No solve in the window: the numbers are missing."""
        if self.last is None:
            return {}
        return local_ba_gaps(self.last, slam_cfg, device)


def local_ba_gaps(solve, slam_cfg, device):
    """The solve against the reference in float64 over the same window:
    its reported costs against the objective at its input and at its
    output, and its output's cost against the reference's own damped
    Gauss-Newton from the same input."""
    arrays, center, pose_out, xyz_out, stats = solve
    raw = {k: v.cpu().numpy() for k, v in arrays.items()}
    lb = slam_cfg["local_ba"]
    if lb["lm_accept_reject"]:
        raise NotImplementedError("the reference follows local BA's damped "
                                  "Gauss-Newton schedule only")
    f64 = torch.float64
    cams, moves, pts, e = ref_ba.local_window(
        raw, int(center), lb, slam_cfg["orb"]["scale_factor"], f64, device)
    cam = ref_ba.camera(slam_cfg)
    poses_in = torch.from_numpy(raw["kf_pose"][cams]).to(device, f64)
    pts_in = torch.from_numpy(raw["pt_xyz"][pts]).to(device, f64)
    ref_in = float(ref_ba.cost(cam, poses_in, pts_in, e))
    ref_out = float(ref_ba.cost(cam, pose_out.cpu()[cams].to(device, f64),
                                xyz_out.cpu()[pts].to(device, f64), e))
    lams = [lb["lm_lambda0"] * lb["lm_lambda_decay"] ** i
            for i in range(lb["lm_iters"])]
    ref_gn = float(ref_ba.damped_gauss_newton(cam, poses_in, pts_in, e,
                                              moves, lams)[3])
    print(f"[slambench] last local BA: center {int(center)}, "
          f"{len(cams)} keyframes ({int(moves.sum())} moving), {len(pts)} "
          f"points, {e.cam.shape[0]} edges; cost {ref_in:.6g} -> program "
          f"{ref_out:.6g}, reference {ref_gn:.6g}", file=sys.stderr, flush=True)
    return {"lba_cost0_rel_gap": abs(float(stats.cost0) - ref_in) / ref_in,
            "lba_cost1_rel_gap": abs(float(stats.cost1) - ref_out) / ref_out,
            "lba_ref_gap": abs(ref_out - ref_gn) / ref_gn}


class Stream:
    """The replay: engines in order, each fed the sequence from frame 0.
    With ``spans``, each engine's finished spans are drained after every
    ``feed`` and flush into ``spans`` as (frame position, name, host ms)."""

    def __init__(self, make_engine, frames, spans: bool = False):
        self.make_engine = make_engine
        self.frames = frames
        self.engines = [make_engine()]
        self.pos = 0
        self.drained = 0
        self.pending = []
        self.spans = [] if spans else None

    def step(self):
        """Feed the next frame; returns [(seconds, record, syncs)] for the
        frames whose rows the engine drained."""
        slam = self.engines[-1]
        if self.pos == len(self.frames):
            slam.flush()
            self._drain(slam)
            self.engines.append(self.make_engine())
            slam, self.pos, self.drained, self.pending = self.engines[-1], 0, 0, []
        s0 = slam.sync.count
        t0 = time.perf_counter()
        slam.feed(*self.frames[self.pos])
        now = time.perf_counter()
        self.pos += 1
        self.pending.append(t0)
        out = []
        syncs = slam.sync.count - s0
        while self.drained < len(slam.metrics):
            out.append((now - self.pending.pop(0), slam.metrics[self.drained],
                        syncs))
            syncs = 0
            self.drained += 1
        self._drain(slam)
        return out

    def flush(self):
        """Flush every engine: a chunk > 1 leaves rows to drain, and the
        last loop verification resolves at a flush."""
        for slam in self.engines:
            slam.flush()
            self._drain(slam)

    def _drain(self, slam):
        if self.spans is not None:
            self.spans += [(s.request, s.name, (s.t1 - s.t0) * 1e-6)
                           for s in slam.sync.drain()]


def _keyframe_rows(engines, n_check, rng):
    """A sample of the keyframes the engines' maps hold, drawn by ``rng``,
    with the most recent keyframe of the longest engine always in it:
    (engine, frame index, the map's row of that keyframe on the host)."""
    cands = []
    longest = max(range(len(engines)), key=lambda i: len(engines[i].metrics))
    for ei, slam in enumerate(engines):
        # A slot's keyframe came from the last frame whose record inserted
        # into it (one record per frame, in order).
        frame_of = {r["kf_id"]: i for i, r in enumerate(slam.metrics)
                    if "kf_id" in r}
        valid = slam.map.kf_valid.cpu().numpy()
        seq = slam.map.kf_seq.cpu().numpy()
        for slot in np.nonzero(valid)[0]:
            cands.append((ei, int(slot), frame_of[int(slot)], int(seq[slot])))
    if not any(c[0] == longest for c in cands):
        return []  # a map without keyframes: nothing the window built
    last = max((c for c in cands if c[0] == longest), key=lambda c: c[3])
    rest = [c for c in cands if c is not last]
    take = [last] + [rest[i] for i in rng.permutation(len(rest))[:n_check - 1]]
    rows = []
    for ei, slot, fi, _ in take:
        m = engines[ei].map
        rows.append((ei, fi, {k: getattr(m, k)[slot].cpu() for k in (
            "kf_uv", "kf_desc", "kf_octave", "kf_kp_valid", "kf_depth")}))
    return rows


def kp_mismatch(row, ref):
    """(keypoints the two sides do not share, keypoints of the larger
    side): a keypoint is shared when the other side has one at the same
    octave, within UV_ATOL pixels and DEPTH_ATOL metres, with the same
    descriptor."""
    pv, rv = row["kf_kp_valid"].bool(), ref.valid.cpu()
    p_uv, r_uv = row["kf_uv"][pv].double(), ref.uv.cpu()[rv].double()
    same = ((row["kf_octave"][pv][:, None] == ref.octave.cpu()[rv][None, :])
            & ((p_uv[:, None, :] - r_uv[None, :, :]).abs().amax(-1) <= UV_ATOL)
            & ((row["kf_depth"][pv][:, None].double()
                - ref.depth.cpu()[rv][None, :].double()).abs() <= DEPTH_ATOL)
            & (row["kf_desc"][pv][:, None, :]
               == ref.desc.cpu()[rv][None, :, :]).all(-1))
    shared = int(same.any(1).sum())
    larger = max(int(pv.sum()), int(rv.sum()))
    return larger - shared, larger


class Setup(NamedTuple):
    frames: list                # (ts, u8 gray, u16 depth) on the host
    truth: render.Trajectory    # the poses the frames were rendered from
    cfg: object                 # the engine's SlamConfig
    make_engine: Callable       # () -> a fresh engine as the run builds it


class Window(NamedTuple):
    stream: Stream
    timed: list                 # [(seconds, record, syncs)] a frame
    seconds: float
    complete: int               # engines that fed the whole sequence in it
    spans: list | None          # the window's spans, with --trace 1


def engine_options(config_spec: dict, device) -> dict:
    """The configuration's ``engine`` keywords for ``SlamSystem``:
    ``async_mapping``, and ``mapping_device`` "card", a second CUDA stream
    of the working card ("cpu", the same-device path, on a CPU rehearsal)."""
    opts = dict(config_spec.get("engine", {}))
    unknown = sorted(set(opts) - set(ENGINE_OPTIONS))
    if unknown:
        raise ValueError(f"engine options {unknown}: only {ENGINE_OPTIONS}")
    if "mapping_device" in opts:
        if opts["mapping_device"] != "card":
            raise ValueError('mapping_device takes only "card"')
        opts["mapping_device"] = device.type
    return opts


def setup(spec, *, seed, trace, device, rehearsal) -> Setup:
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.slam import SlamSystem

    slam_cfg = spec["config_spec"]["slam"]
    tr = spec["traffic_spec"]
    cfg = SlamConfig.from_dict(slam_cfg)
    traj = render.trajectory(tr["path"])
    take = slice(0, tr.get("prefix"))
    warm_n = tr["warmup_frames"]
    traj = render.Trajectory(traj.poses_twc[take], traj.timestamps[take])
    if rehearsal:  # every ``stride``-th frame: a keyframe comes soon
        reh = tr["rehearsal"]
        step = reh.get("stride", 1)
        take = slice(0, reh["frames"] * step, step)
        traj = render.Trajectory(traj.poses_twc[take], traj.timestamps[take])
        warm_n = reh["warmup_frames"]
    gen = torch.Generator(device=device).manual_seed(tr.get("render_seed",
                                                            seed))
    frames = render.render_wire(render.Camera.from_config(slam_cfg), traj,
                                depth_noise=tr["depth_noise"],
                                room_scale=tr["room_scale"], generator=gen,
                                device=device)
    if device.type == "cuda":
        from boslam_tpu_torch.ops.build import build_kernels

        build_kernels()
    kw = dict(engine_options(spec["config_spec"], device), chunk=tr["chunk"],
              device=device)
    if trace:
        kw["trace"] = True

    def make_engine():
        return SlamSystem(cfg, seed=seed, **kw)

    warm = make_engine()
    for f in frames[:warm_n]:
        warm.feed(*f)
    warm.flush()
    del warm
    if device.type == "cuda":
        torch.cuda.synchronize()
    return Setup(frames, traj, cfg, make_engine)


def window(st: Setup, seconds: float, *, min_frames: int = 0,
           spans: bool = False) -> Window:
    """Frames fed until ``seconds`` have passed and ``min_frames`` are
    done, then every engine flushed."""
    stream = Stream(st.make_engine, st.frames, spans)
    timed = []
    t_open = time.perf_counter()
    now = t_open
    while now - t_open < seconds or len(timed) < min_frames:
        timed += stream.step()
        now = time.perf_counter()
    stream.flush()
    window_s = time.perf_counter() - t_open
    complete = len(stream.engines) - (stream.pos < len(st.frames))
    return Window(stream, timed, window_s, complete,
                  None if stream.spans is None else list(stream.spans))


def traced(stream: Stream, n_frames: int) -> dict:
    """``n_frames`` more frames under the profiler: its summary."""
    def more():
        for _ in range(n_frames):
            stream.step()
        stream.engines[-1].flush()

    _, prof = profiling.traced(more)
    prof["n_frames"] = n_frames
    return prof


def check(spec, st: Setup, stream: Stream, *, seed, device, control,
          probes) -> dict:
    """The numbers compared with the cell's limits.  The stream's engines
    are dropped before the references run."""
    slam_cfg = spec["config_spec"]["slam"]
    tr = spec["traffic_spec"]
    engines = stream.engines
    trajectories = [slam.trajectory()[1] for slam in engines]
    lost = sum(1 for slam in engines for r in slam.metrics if r["lost"])
    rows = _keyframe_rows(engines, tr["check_keyframes"],
                          np.random.default_rng(seed))
    del engines
    stream.engines.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # The reference in float32 with TF32 off, as the configuration states;
    # the control computes it with TF32 on.
    torch.backends.cuda.matmul.allow_tf32 = control == "reference_tf32"
    fe = Frontend(slam_cfg, device)
    miss = total = 0
    for _, fi, row in rows:
        _, gray, d16 = st.frames[fi]
        ref = fe(torch.from_numpy(gray).to(device),
                 torch.from_numpy(d16.astype(np.int32)).to(device))
        m, t = kp_mismatch(row, ref)
        miss, total = miss + m, total + t
    torch.backends.cuda.matmul.allow_tf32 = False
    # Each engine's first ``check_frames`` frames: a faster program reaches
    # further into the sequence, and the drift grows along it.
    n_ate = tr["check_frames"]
    gt = st.truth.poses_twc
    ate = max(ate_rmse(est[:n_ate, 4:], gt[:len(est[:n_ate]), 4:])[0]
              for est in trajectories)
    # No keyframe to compare is no map: every keypoint missing.
    values = {"ate_m": ate, "kp_mismatch": miss / total if total else 1.0,
              "lost_frames": float(lost)}
    for p in probes:
        values.update(p.values(slam_cfg, device))
    return values


def _report(win: Window, setup_s: float, slam_cfg: dict):
    """(end-to-end metrics, the run record the per-layer readers read)."""
    timed = win.timed
    dts = np.array([t for t, _, _ in timed])
    is_kf = np.array([r.get("event") in KF_EVENTS for _, r, _ in timed])
    run_rec = {
        "kind": "frames", "slam_cfg": slam_cfg, "n_frames": len(timed),
        "frame_s": dts, "keyframe": is_kf,
        "host_syncs": int(sum(s for _, _, s in timed)),
    }
    if win.spans is not None:
        run_rec["spans"] = win.spans
    e2e = {"fps": len(timed) / win.seconds,
           "frame_ms_p90": float(np.percentile(dts, 90)) * 1e3,
           "setup_s": setup_s}
    engines = win.stream.engines
    print(f"[slambench] window {win.seconds:.3f} s: {len(timed)} frames, "
          f"{int(is_kf.sum())} keyframe frames, {len(engines)} engine(s); "
          f"mean ms plain {1e3 * dts[~is_kf].mean():.2f} keyframe "
          f"{1e3 * dts[is_kf].mean():.2f}", file=sys.stderr, flush=True)
    pos = np.arange(len(timed)) % len(win.stream.frames)  # each starts at 0
    closed = [int(p) for p, (_, r, _) in zip(pos, timed)
              if r.get("event") == "loop_closed"]
    slow = np.argsort(-dts)[:3]
    print(f"[slambench] loop closures at the keyframes of frames {closed}; "
          f"slowest frames (position, ms) "
          f"{[(int(pos[i]), round(1e3 * float(dts[i]), 1)) for i in slow]}",
          file=sys.stderr, flush=True)
    last = engines[-1]
    print(f"[slambench] map at the window's close: "
          f"{int(last.map.kf_valid.sum())} keyframes, "
          f"{int(last.map.pt_valid.sum())} points (of "
          f"{last.map.pt_valid.shape[0]}); loop closures "
          f"{sum(s.n_loops_closed for s in engines)}",
          file=sys.stderr, flush=True)
    return e2e, run_rec


def run_cell(spec, probes, window_values=None, *, seed, seconds, trace,
             device, rehearsal, control, t_start):
    """A frame cell's run: the stages around ``probes``, which are closed
    at the end; ``window_values(win)`` adds numbers of the window to the
    check."""
    try:
        return _run_cell(spec, probes, window_values, seed, seconds, trace,
                         device, rehearsal, control, t_start)
    finally:
        for p in probes:
            p.close()


def _run_cell(spec, probes, window_values, seed, seconds, trace, device,
              rehearsal, control, t_start):
    on_card = device.type == "cuda"
    tr = spec["traffic_spec"]
    st = setup(spec, seed=seed, trace=trace, device=device,
               rehearsal=rehearsal)
    setup_s = time.perf_counter() - t_start

    for p in probes:
        p.on = True
    win = window(st, seconds,
                 min_frames=tr["rehearsal"]["frames"] if rehearsal else 0,
                 spans=trace)
    for p in probes:
        p.on = False
    e2e, run_rec = _report(win, setup_s, spec["config_spec"]["slam"])
    values = window_values(win) if window_values is not None else {}

    extra = {}
    if trace and on_card:
        prof = traced(win.stream, tr["trace_frames"])
        run_rec["profile_frames"] = prof
        extra = {"busy_s": prof["busy_s"], "window_s": prof["window_s"],
                 "breakdown": {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}}
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    timed = win.timed
    values.update(check(spec, st, win.stream, seed=seed, device=device,
                        control=control, probes=probes))
    return dict(e2e=e2e, run=run_rec, values=values, attempted=len(timed),
                failed=int(sum(1 for _, r, _ in timed if r["lost"])),
                memory_peak=memory_peak, **extra)


def run(spec, **kw):
    import boslam_tpu_torch.slam as slam_module

    return run_cell(spec, [LocalBaProbe(slam_module)], **kw)
