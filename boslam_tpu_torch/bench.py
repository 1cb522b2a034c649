"""The engine's benchmark on the CUDA card.

    python -m boslam_tpu_torch.bench [--frames 450] [--warmup-frames 128]
        [--ba-frames 400] [--ba-points 50000] [--budget 1200]
        [--no-stages] [--no-global-ba] [--no-tracked-ba] [--error-budget]
        [--depth-stride 2] [--device cuda|cpu]

The counterpart of the JAX package's ``bench.py``, phase for phase, with
its keys and their meanings.  Each phase is a function that takes its
config and frames (or its problem) and returns a dict:

1. ``bench_tracking``: the 450-frame 3-petal clover ``hall`` in a
   hall-sized synthetic room (room scale 2.5), a wide-FOV VGA camera (640x480,
   512 features, 8 levels, local BA on every keyframe), loops on.  Three
   stream passes, each on a fresh engine and timed by a host clock that ends
   in a device synchronization, and up to two ``run_sequence(batch=16)``
   passes; the median of each is reported beside every pass.  ATE,
   keyframes, points, loops and lost frames; on the card, the launches per
   frame of the frontend kernels.
2. ``bench_device_path``: ``torch.profiler`` over a window of frames on its
   own engine after a warm-up (the fps passes run untraced): device busy ms
   per frame, idle share, device operations and host syncs per frame, and
   the frame's share of the card's peaks.  In the primary line.
3. ``bench_global_ba``: the synthetic problem of 256 keyframes, 50k
   landmarks and 512 observations each (rng seed 0), 6 LM x 40 CG
   iterations; LM iterations/s, median of 3 after a warm-up.
4. ``bench_error_budget_cheap``: ATE with loop closing off (the drift
   floor) and on a render without depth noise.  ``--error-budget`` runs
   instead the full sweep (``bench_error_budget_full``: noise 0 and 2.5 %,
   depth on the wire at stride 1 and 2, and loops off).
5. ``bench_stages``: the frame step's stages from the engine's own spans
   (``HostSync``) over a live pass: each span's host ms, and on the card
   the device ms, operations and idle ms launched or spent inside it
   (``utils.timing.attribute``) over a window under the profiler.
6. ``bench_tracked_global_ba``: the 400-frame ``survey`` drives the engine
   to a large map (1024 features, 65536 points, no redundancy culling);
   global BA runs on that map: LM iterations/s and ATE before and after.

A wall-clock budget (``--budget``) gates phases 2-6 on estimates of their
seconds on the card (``PHASE_EST``).  The primary JSON line prints after
phases 1 and 2; the final line, a strict superset of it, adds the later
phases, their seconds, the phases skipped and the elapsed time.

The card's line carries its name and power limit (``nvidia-smi``).  With
``--device cpu`` the bench runs the plain PyTorch path and writes no
device metric (``device_*``, ``*_util_*``, ``step_*``, ``card``, launch
counts); without it and without a card it raises.

``vs_baseline`` divides fps by 30, the live-camera rate of the ORB-SLAM
family's CPU tracking.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import sys
import threading
import time

import numpy as np
import torch

BASELINE_FPS = 30.0  # live-camera rate; see the module docstring
BATCH = 16           # feed_batch size of the batch passes
DEVICE_FRAMES = 32   # frames under the profiler in the device pass

# Seconds each gated phase is expected to take on the card, with margin
# (PERF.md section 5 has the measured ones).
PHASE_EST = {
    "device_path": 60.0,
    "global_ba_50k": 15.0,
    "stages": 45.0,
    "tracked_ba": 180.0,
}


class Budget:
    """Wall-clock budget: a phase runs only if ``allow(name, est_s)`` finds
    the remaining seconds cover its estimate; skipped phases and each
    phase's seconds are recorded."""

    def __init__(self, total_s: float):
        self.t0 = time.perf_counter()
        self.total = total_s
        self.skipped = []
        self.phase_times = {}

    def remaining(self) -> float:
        return self.total - (time.perf_counter() - self.t0)

    def allow(self, name: str, est: float) -> bool:
        rem = self.remaining()
        if rem >= est:
            return True
        self.skipped.append(name)
        print(f"[bench] SKIP {name}: est {est:.0f}s > {rem:.0f}s remaining",
              file=sys.stderr)
        return False

    def timed(self, name: str):
        budget = self

        class _T:
            def __enter__(self):
                self.t = time.perf_counter()

            def __exit__(self, *exc):
                budget.phase_times[name] = time.perf_counter() - self.t

        return _T()


def _wire(cfg, ts, rgb, depth_f32):
    """A rendered frame in the engine's wire format: (ts, u8 gray, u16
    depth at the camera's wire shape).  Datasets arrive in this format, so
    the conversion stays out of the timed passes."""
    from boslam_tpu_torch.slam import depth_wire, to_gray_u8

    return ts, to_gray_u8(rgb), depth_wire(depth_f32, cfg.camera)


def _render(cam, traj, depth_noise, seed, room_scale):
    """(ts, rgb, f32 depth) per pose of ``traj``, the depth noise drawn from
    one generator in frame order (``io.synthetic.render_sequence``'s
    frames, one at a time)."""
    from boslam_tpu_torch.io.synthetic import render_frame

    rng = np.random.default_rng(seed)
    for ts, pose in zip(traj.timestamps, traj.poses_twc):
        rgb, depth = render_frame(cam, pose, room_scale=room_scale)
        if depth_noise > 0:
            depth = depth + rng.normal(size=depth.shape).astype(
                np.float32) * (depth_noise * depth)
        yield float(ts), rgb, depth


def _render_wire(cfg, traj, depth_noise, seed, room_scale, emit=None):
    """``traj`` rendered into wire-format frames: each passed to ``emit`` as
    it is made, or all returned."""
    out = []
    emit = out.append if emit is None else emit
    for f in _render(cfg.camera, traj, depth_noise, seed, room_scale):
        emit(_wire(cfg, *f))
    return out


class RenderFeed:
    """Renders the main sequence frame by frame on a thread, so that the
    engine's warm-up consumes frames while the rest render; each queued
    extra sequence renders whole in a worker process, so that it takes no
    interpreter time from the timed passes.  ``close()`` stops the
    workers."""

    def __init__(self, cfg, traj, *, depth_noise, seed, room_scale):
        self.cfg = cfg
        self.frames = []
        self.n_total = len(traj.timestamps)
        self._cv = threading.Condition()
        self._pool = None
        self._extra = {}
        self._error = None
        self._thread = threading.Thread(
            target=self._render_main, daemon=True,
            args=(cfg, traj, depth_noise, seed, room_scale))
        self._thread.start()

    def _render_main(self, *args):
        try:
            _render_wire(*args, emit=self._append)
        except BaseException as e:  # re-raised by the waiting consumer
            with self._cv:
                self._error = e
                self._cv.notify_all()
            raise

    def _append(self, frame):
        with self._cv:
            self.frames.append(frame)
            self._cv.notify_all()

    def _wait_for(self, n):
        with self._cv:
            while len(self.frames) < n:
                if self._error is not None:
                    raise RuntimeError("rendering the main sequence failed") \
                        from self._error
                self._cv.wait()
            return self.frames

    def queue(self, name, cfg, traj, *, depth_noise, seed, room_scale):
        if self._pool is None:
            self._pool = concurrent.futures.ProcessPoolExecutor(
                2, mp_context=multiprocessing.get_context("spawn"))
        self._extra[name] = self._pool.submit(
            _render_wire, cfg, traj, depth_noise, seed, room_scale)

    def get(self, i):
        """Blocking: the i-th frame of the main sequence."""
        return self._wait_for(i + 1)[i]

    def wait_main(self):
        return self._wait_for(self.n_total)

    def wait_extra(self, name, timeout_s=600.0):
        """The queued sequence ``name``, or None if it is not ready within
        ``timeout_s`` or was never queued."""
        fut = self._extra.get(name)
        if fut is None:
            return None
        try:
            return fut.result(timeout=timeout_s)
        except concurrent.futures.TimeoutError:
            return None

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _ate(slam, traj) -> float:
    from boslam_tpu_torch.geometry import align

    _, est = slam.trajectory()
    n = min(len(est), len(traj.poses_twc))
    rmse, _ = align.ate_rmse(
        torch.from_numpy(est[:n, 4:].astype(np.float32)),
        torch.from_numpy(traj.poses_twc[:n, 4:].astype(np.float32)))
    return float(rmse)


def _run_engine(cfg, frames, *, loop_off: bool = False, device=None):
    """One engine pass over wire-format frames; returns the SlamSystem."""
    from boslam_tpu_torch.slam import SlamSystem

    slam = SlamSystem(cfg, device=device)
    if loop_off:
        slam.MAX_VERIFY = 0  # the host never verifies: no closures
    for ts, gray, d16 in frames:
        slam.feed(ts, gray, d16)
    slam.flush()
    return slam


def _tracking_cfg(depth_stride: int = 2):
    """``hall``'s configuration: a wide-FOV VGA RGBD camera (the clover needs
    ~90 degrees of field of view to keep pixel flow inside the matcher's
    windows) with the TUM presets' compute shapes (640x480, 512 features, 8
    levels)."""
    from boslam_tpu_torch.config import (
        CameraConfig, LoopConfig, SlamConfig, TrackerConfig,
    )

    cam = CameraConfig(fx=260.0, fy=260.0, cx=319.5, cy=239.5, depth_max=20.0,
                       depth_wire_stride=depth_stride)
    return SlamConfig(
        camera=cam,
        loop=LoopConfig(min_gap_kf=8, consistency=2),
        tracker=TrackerConfig(kf_min_interval=2, kf_tracked_ratio=0.8),
    )


def _survey_cfg():
    """``survey``'s configuration: the same camera with a 30 m depth range,
    1024 features, a keyframe at least every 6 frames and no redundancy
    culling, so the map grows to the global-BA scale."""
    from boslam_tpu_torch.config import (
        CameraConfig, LoopConfig, MapConfig, OrbConfig, SlamConfig,
        TrackerConfig,
    )

    cam = CameraConfig(fx=260.0, fy=260.0, cx=319.5, cy=239.5, depth_max=30.0)
    return SlamConfig(
        camera=cam,
        orb=OrbConfig(n_features=1024),
        map=MapConfig(max_keyframes=256, max_points=65536,
                      kf_cull_redundancy=2.0),
        loop=LoopConfig(min_gap_kf=8, consistency=2),
        tracker=TrackerConfig(kf_min_interval=2, kf_max_interval=6,
                              kf_tracked_ratio=0.8),
    )


def warm_up(cfg, get_frame, n: int, device) -> dict:
    """One engine over the first ``n`` frames (``get_frame(i)``, which may
    block on the render), so that the timed passes find the allocator warm
    and every rare event's first call made."""
    from boslam_tpu_torch.slam import SlamSystem

    t0 = time.perf_counter()
    slam = SlamSystem(cfg, device=device)
    slam.feed(*get_frame(0))
    slam.flush()
    _sync(device)
    first = time.perf_counter() - t0
    for i in range(1, n):
        slam.feed(*get_frame(i))
    slam.flush()
    _sync(device)
    total = time.perf_counter() - t0
    return {"warmup_first_frame_s": first,
            "warmup_warm_frames_s": total - first, "warmup_total_s": total}


def _timed_pass(run, n_frames: int, device):
    """(engine, frames/s) of ``run()``, the clock ending in a device
    synchronization."""
    t0 = time.perf_counter()
    slam = run()
    _sync(device)
    return slam, n_frames / (time.perf_counter() - t0)


def bench_tracking(cfg, frames, traj, *, budget: Budget, device,
                   n_passes: int = 3, n_batch_passes: int = 2):
    """Phase 1.  Returns (extras, engines): ``engines["stream"]`` is the
    last stream pass's engine, ``engines["batch"]`` the last batch pass's
    (if one ran); the ATE and counts come from ``engines[fps_mode]``."""
    from boslam_tpu_torch.ops.build import LAUNCHES
    from boslam_tpu_torch.slam import run_sequence

    on_card = torch.device(device).type == "cuda"
    n = len(frames)
    launches = dict.fromkeys(LAUNCHES, 0)
    fps_runs, engines = [], {}
    for i in range(n_passes):
        if i > 0 and budget.remaining() < 60:
            budget.skipped.append(f"fps_pass_{i}")
            break
        before = dict(LAUNCHES)
        engines["stream"], fps = _timed_pass(
            lambda: _run_engine(cfg, frames, device=device), n, device)
        fps_runs.append(fps)
        for k in launches:
            launches[k] += LAUNCHES[k] - before[k]
    fps = float(np.median(fps_runs))

    # Batch passes: the same frames through one stacked copy per 16.  The
    # second runs only if the first came within 10 % of the stream median.
    fps_batch_runs = []
    for i in range(n_batch_passes):
        if budget.total < 240 or budget.remaining() < (150 if i == 0 else 60) \
                or (i == 1 and fps_batch_runs[0] < 0.9 * fps):
            budget.skipped.append(f"fps_batch_pass_{i}")
            break
        engines["batch"], f = _timed_pass(
            lambda: run_sequence(cfg, frames, batch=BATCH, device=device),
            n, device)
        fps_batch_runs.append(f)
    fps_batch = float(np.median(fps_batch_runs)) if fps_batch_runs else 0.0
    mode = "batch" if fps_batch_runs and fps_batch > fps else "stream"
    slam = engines[mode]

    rmse = _ate(slam, traj)
    m = slam.metrics
    extras = {
        # Headline: the better of the stream and batch medians (the same
        # tracking over the same frames); ``fps_mode`` says which.
        "fps": max(fps, fps_batch),
        "fps_mode": mode,
        "fps_stream": fps,
        "fps_batch": fps_batch,
        "fps_runs": fps_runs,
        "fps_batch_runs": fps_batch_runs,
        "ate_rmse_m": rmse,
        "keyframes": slam.n_keyframes,
        "map_points": slam.n_points,
        "loops_closed": slam.n_loops_closed,
        "loop_edges": int(slam.map.n_loop_edges),
        "lost_frames": sum(1 for r in m if r.get("lost")),
        "depth_wire_stride": cfg.camera.depth_wire_stride,
    }
    if on_card:
        for k, v in launches.items():
            extras[f"{k}_launches_per_frame"] = v / (n * len(fps_runs))
    print(f"[bench] fps={fps:.2f} (runs {[round(f, 2) for f in fps_runs]}, "
          f"batch {[round(f, 2) for f in fps_batch_runs]}) ate={rmse:.4f}m "
          f"kf={extras['keyframes']} pts={extras['map_points']} "
          f"lost={extras['lost_frames']} loops={extras['loops_closed']}",
          file=sys.stderr)
    return extras, engines


def bench_device_path(cfg, frames, *, warm: int, kf_events_per_frame: float,
                      device=None, n_frames: int = DEVICE_FRAMES) -> dict:
    """Phase 2: an engine fed ``frames[:warm]``, then ``torch.profiler``
    over the next ``n_frames`` (``utils.timing.frame_device_ms``) and the
    frame's share of the card (``step_utilization``, local BA weighted by
    ``kf_events_per_frame``)."""
    from boslam_tpu_torch.slam import SlamSystem
    from boslam_tpu_torch.utils import timing

    slam = SlamSystem(cfg, device=device)
    for f in frames[:warm]:
        slam.feed(*f)
    res = timing.frame_device_ms(slam, frames[warm:warm + n_frames])
    busy = res["device_busy_ms"]
    out = {
        "device_step_ms": busy,
        "device_fps": 1e3 / busy,
        "device_idle_share": res["device_idle_share"],
        "device_ops_per_frame": res["device_ops"],
        "host_syncs_per_frame": res["host_syncs"],
        "device_path_frames": len(frames[warm:warm + n_frames]),
    }
    out.update(timing.step_utilization(cfg, busy, kf_events_per_frame,
                                       timing.device_peaks()))
    print("[bench] device path: " + json.dumps(out), file=sys.stderr)
    return out


def _gba_problem(n_points: int, n_kf: int, obs_per_kf: int, device):
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.io.synthetic import synthetic_ba_problem
    from boslam_tpu_torch.mapping.map_state import MapState

    cfg = SlamConfig.from_dict(dict(map=dict(max_keyframes=n_kf,
                                             max_points=65536),
                                    orb=dict(n_features=512)))
    st, gt_poses, _ = synthetic_ba_problem(
        cfg, np.random.default_rng(0), n_kf=n_kf, n_pts=n_points,
        obs_per_kf=obs_per_kf)
    return cfg, MapState(*(t.to(device) for t in st)), gt_poses.to(device)


def bench_global_ba(n_points: int = 50000, *, n_kf: int = 256,
                    obs_per_kf: int = 512, device=None) -> dict:
    """Phase 3: global BA on the synthetic problem (rng seed 0), 6 LM x 40
    CG iterations; LM iterations/s over the median of 3 runs after a
    warm-up, each run's input salted."""
    from boslam_tpu_torch.device import resolve_device
    from boslam_tpu_torch.geometry import se3
    from boslam_tpu_torch.solvers.global_ba import global_bundle_adjustment

    device = resolve_device(device)
    cfg, st, gt_poses = _gba_problem(n_points, n_kf, obs_per_kf, device)
    lm_iters = 6

    def run(s):
        return global_bundle_adjustment(cfg, s, lm_iters=lm_iters, cg_iters=40)

    run(st)
    _sync(device)
    dts = []
    for i in range(3):
        salted = st._replace(kf_pose=st.kf_pose + 1e-30 * (i + 1))
        t0 = time.perf_counter()
        st2, stats = run(salted)
        _sync(device)
        dts.append(time.perf_counter() - t0)
    iters_per_s = lm_iters / float(np.median(dts))
    _, terr = se3.pose_distance(st2.kf_pose[:n_kf], gt_poses)
    out = {
        "ba_iters_per_sec": iters_per_s,
        "ba_landmarks": int(st.pt_valid.sum()),
        "ba_edges": int(stats.n_edges),
        "ba_cost_reduction": float(stats.cost0) / max(float(stats.cost1), 1e-9),
    }
    print(f"[bench] global BA: {out['ba_edges']} edges, {out['ba_landmarks']} "
          f"pts, cost {float(stats.cost0):.0f}->{float(stats.cost1):.0f}, "
          f"{iters_per_s:.2f} LM iters/s, max pose err "
          f"{float(terr.max()) * 1e3:.2f}mm", file=sys.stderr)
    return out


def bench_error_budget_cheap(cfg, frames, traj, *, noise0=None,
                             device=None) -> dict:
    """Phase 4: ATE with loop closing off on ``frames`` (the drift floor)
    and, given ``noise0`` (the same trajectory rendered without depth
    noise), the ATE and loops there (intrinsic accuracy)."""
    t0 = time.perf_counter()
    out = {"ate_loop_off_m": _ate(
        _run_engine(cfg, frames, loop_off=True, device=device), traj)}
    if noise0 is not None:
        slam0 = _run_engine(cfg, noise0, device=device)
        out["ate_noise0_m"] = _ate(slam0, traj)
        out["loops_noise0"] = slam0.n_loops_closed
    print(f"[bench] error budget ({time.perf_counter() - t0:.1f}s): "
          + json.dumps(out), file=sys.stderr)
    return out


def bench_error_budget_full(traj, *, device=None) -> dict:
    """The full error budget: ATE on renders with depth noise 0 and 2.5 %,
    depth on the wire at stride 1 and 2, and with loops off on the noisy
    render: intrinsic drift, the sensor-noise floor, the wire format's cost
    and what loop closing buys."""
    cam = _tracking_cfg(1).camera
    raw = {}
    for noise, tag in ((0.0, "noise0"), (0.025, "noise25")):
        # Rendered once; the stride is a transform of the wire format.
        raw[tag] = list(_render(cam, traj, noise, 3, 2.5))
        print(f"[bench] error-budget: rendered {tag}", file=sys.stderr)

    out = {}
    for stride in (1, 2):
        cfg = _tracking_cfg(stride)
        for tag in ("noise0", "noise25"):
            frames = [_wire(cfg, *f) for f in raw[tag]]
            slam, fps = _timed_pass(
                lambda: _run_engine(cfg, frames, device=device), len(frames),
                device)
            key = f"ate_{tag}_stride{stride}_m"
            out[key] = _ate(slam, traj)
            out[f"loops_{tag}_stride{stride}"] = slam.n_loops_closed
            if tag == "noise25":
                out[f"ate_loopoff_stride{stride}_m"] = _ate(_run_engine(
                    cfg, frames, loop_off=True, device=device), traj)
            print(f"[bench] error-budget stride={stride} {tag}: "
                  f"ate={out[key]} loops={slam.n_loops_closed} ({fps:.1f} fps)",
                  file=sys.stderr)
    return out


def bench_stages(cfg, frames, *, warm: int, device=None,
                 n_frames: int = DEVICE_FRAMES) -> dict:
    """Phase 5: an engine with its span recorder on, fed ``frames[:warm]``
    and then ``n_frames`` more, under ``torch.profiler`` on the card.
    ``stages_host_ms``: each span's median host ms over the frames fed
    outside the profiler (all of them on the CPU), the first frame's first
    calls left out; ``stages_per_frame``: how often it opens a frame over
    those frames.  On the card, per profiled frame: ``stages_device_ms``
    and ``stages_device_ops``, the device work launched with the span
    innermost, and ``stages_idle_ms``, the device's idle time while it was
    innermost on the host (``utils.timing.profile_spans``)."""
    from boslam_tpu_torch.slam import SlamSystem
    from boslam_tpu_torch.utils import timing

    on_card = torch.device(device).type == "cuda"
    slam = SlamSystem(cfg, device=device, trace=True)
    untraced = frames[:warm] if on_card else frames[:warm + n_frames]
    for f in untraced:
        slam.feed(*f)
    slam.flush()
    host: dict = {}
    for s in slam.sync.drain():
        if s.request > 0:
            host.setdefault(s.name, []).append((s.t1 - s.t0) / 1e6)
    n_host = max(len(untraced) - 1, 1)
    out = {"stages_host_ms": {k: float(np.median(v)) for k, v in host.items()},
           "stages_per_frame": {k: len(v) / n_host for k, v in host.items()}}
    window = frames[warm:warm + n_frames] if on_card else []
    if window:
        def run():
            for f in window:
                slam.feed(*f)
            slam.flush()

        got = timing.profile_spans(run, slam.sync)
        n = len(window)
        ops = got["ops_by_span"]
        out.update(
            stages_device_ms={k: v[1] * 1e3 / n for k, v in ops.items()},
            stages_device_ops={k: v[0] / n for k, v in ops.items()},
            stages_idle_ms={k: v * 1e3 / n
                            for k, v in got["idle_by_span"].items()})
    print("[bench] stages: " + json.dumps(out), file=sys.stderr)
    return out


def bench_tracked_global_ba(frames, traj, *, device=None) -> dict:
    """Phase 6: the engine over ``survey``'s frames, then global BA on the
    map it built: LM iterations/s (median of 2 runs after a warm-up, each
    input salted) and the ATE before and after."""
    from boslam_tpu_torch.solvers.global_ba import global_bundle_adjustment

    cfg = _survey_cfg()
    t0 = time.perf_counter()
    slam = _run_engine(cfg, frames, device=device)
    print(f"[bench] tracked-BA: engine run {time.perf_counter() - t0:.1f}s "
          f"kf={slam.n_keyframes} pts={slam.n_points}", file=sys.stderr)
    ate_before = _ate(slam, traj)
    lm_iters = cfg.loop.global_ba_iters

    def run(st):
        return global_bundle_adjustment(cfg, st, lm_iters=lm_iters,
                                        cg_iters=cfg.loop.global_ba_cg_iters)

    run(slam.map)
    _sync(device)
    dts = []
    for i in range(2):
        salted = slam.map._replace(kf_pose=slam.map.kf_pose + 1e-30 * (i + 1))
        t0 = time.perf_counter()
        st2, stats = run(salted)
        _sync(device)
        dts.append(time.perf_counter() - t0)
    slam.map = st2
    out = {
        "tba_keyframes": slam.n_keyframes,
        "tba_points": slam.n_points,
        "tba_edges": int(stats.n_edges),
        "tba_iters_per_sec": lm_iters / float(np.median(dts)),
        "tba_cost_reduction": float(stats.cost0) / max(float(stats.cost1),
                                                       1e-9),
        "tba_ate_before_m": ate_before,
        "tba_ate_after_m": _ate(slam, traj),
        "tba_loops_closed": slam.n_loops_closed,
    }
    print("[bench] tracked-BA: " + json.dumps(out), file=sys.stderr)
    return out


def _line(extras, budget=None) -> dict:
    """The bench's JSON line: the metric, its ratio to the baseline and
    ``extras``; with ``budget``, the phases skipped and the elapsed time."""
    line = {
        "metric": "tracked_frames_per_sec_per_chip",
        "value": extras["fps"],
        "unit": "fps",
        "vs_baseline": extras["fps"] / BASELINE_FPS,
        "baseline_note": "denominator=30fps, the live-camera rate of the "
                         "ORB-SLAM family's CPU tracking",
        **extras,
    }
    if "device_fps" in extras:
        line["vs_baseline_device"] = extras["device_fps"] / BASELINE_FPS
    if budget is not None:
        line["phases_skipped"] = budget.skipped
        line["elapsed_s"] = time.perf_counter() - budget.t0
    return line


def _emit(extras, budget=None) -> None:
    print(json.dumps(_line(extras, budget)), flush=True)


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m boslam_tpu_torch.bench")
    ap.add_argument("--frames", type=int, default=450)
    ap.add_argument("--warmup-frames", type=int, default=128)
    ap.add_argument("--ba-frames", type=int, default=400)
    ap.add_argument("--ba-points", type=int, default=50000)
    ap.add_argument("--budget", type=float, default=1200.0,
                    help="wall-clock budget (s); a phase is skipped when the "
                         "remaining budget is below its estimate.  Every "
                         "phase fits in the default on the H100")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu, the "
                         "plain path without device metrics")
    ap.add_argument("--no-stages", action="store_true")
    ap.add_argument("--no-global-ba", action="store_true")
    ap.add_argument("--no-tracked-ba", action="store_true")
    ap.add_argument("--error-budget", action="store_true",
                    help="run the full stride/noise accuracy sweep instead "
                         "of the tracking benchmark")
    ap.add_argument("--depth-stride", type=int, default=2,
                    help="depth on the wire, one sample per s x s block "
                         "(boundary-aware; slam.depth_wire)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = _parse(argv)
    budget = Budget(args.budget)
    from boslam_tpu_torch.device import resolve_device
    from boslam_tpu_torch.io import synthetic

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        from boslam_tpu_torch.ops.build import build_kernels
        from boslam_tpu_torch.utils.timing import card

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi, watts = card()
        head = {"device": torch.cuda.get_device_name(0), "card": smi,
                "power_limit_w": watts}
        t0 = time.perf_counter()
        build_kernels()
        head["warmup_build_s"] = time.perf_counter() - t0
    else:
        head = {"device": "cpu"}
    print(f"[bench] device: {head['device']}", file=sys.stderr)

    traj = synthetic.clover_trajectory(args.frames, n_petals=3, radius=2.5,
                                       yaw_amplitude=0.4)
    if args.error_budget:
        out = bench_error_budget_full(traj, device=device)
        _emit({**head, "fps": 0.0, **out}, budget)
        return

    cfg = _tracking_cfg(args.depth_stride)
    rf = RenderFeed(cfg, traj, depth_noise=0.025, seed=3, room_scale=2.5)
    try:
        rf.queue("noise0", cfg, traj, depth_noise=0.0, seed=3, room_scale=2.5)
        if not args.no_tracked_ba:
            rf.queue("survey", _survey_cfg(),
                     synthetic.survey_trajectory(args.ba_frames, span=6.0),
                     depth_noise=0.01, seed=5, room_scale=3.0)
        warm_n = min(args.warmup_frames, args.frames)
        warm = warm_up(cfg, rf.get, warm_n, device)
        frames = rf.wait_main()
        extras, engines = bench_tracking(cfg, frames, traj, budget=budget,
                                         device=device)
        extras = {**head, **extras, **warm}
        kf_rate = sum(1 for r in engines["stream"].metrics
                      if r.get("event") == "keyframe") / len(frames)
        if not on_card:
            budget.skipped.append("device_path")
        elif budget.allow("device_path", PHASE_EST["device_path"]):
            with budget.timed("device_path"):
                extras.update(bench_device_path(
                    cfg, frames, warm=min(warm_n, len(frames) // 2),
                    kf_events_per_frame=kf_rate, device=device))
        _emit(extras)  # the primary line

        if not args.no_global_ba and budget.allow(
                "global_ba_50k", PHASE_EST["global_ba_50k"]):
            with budget.timed("global_ba_50k"):
                extras.update(bench_global_ba(args.ba_points, device=device))
        fps_est = max(extras["fps_stream"], 0.1)
        if budget.allow("error_budget_cheap",
                        2.5 * args.frames / fps_est + 10):
            with budget.timed("error_budget_cheap"):
                noise0 = rf.wait_extra("noise0",
                                       timeout_s=max(budget.remaining(), 5.0))
                if noise0 is None:
                    budget.skipped.append("error_budget_noise0")
                extras.update(bench_error_budget_cheap(
                    cfg, frames, traj, noise0=noise0, device=device))
        if not args.no_stages and budget.allow("stages",
                                               PHASE_EST["stages"]):
            with budget.timed("stages"):
                extras.update(bench_stages(
                    cfg, frames, warm=min(warm_n, len(frames) // 2),
                    device=device))
        if not args.no_tracked_ba and budget.allow(
                "tracked_ba", PHASE_EST["tracked_ba"]):
            with budget.timed("tracked_ba"):
                survey = rf.wait_extra("survey",
                                       timeout_s=max(budget.remaining(), 10.0))
                if survey is None:
                    budget.skipped.append("tracked_ba_render")
                else:
                    extras.update(bench_tracked_global_ba(
                        survey, synthetic.survey_trajectory(args.ba_frames,
                                                            span=6.0),
                        device=device))
        extras["phase_times"] = budget.phase_times
        _emit(extras, budget)  # the final line: a superset of the primary
    finally:
        rf.close()


if __name__ == "__main__":
    main()
