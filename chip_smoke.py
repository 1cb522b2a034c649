"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card and build: the card's name and power limit, then ``nvcc`` builds
     of every kernel of the main path from ``boslam_tpu_torch/csrc``;
  2. kernels against their plain PyTorch versions on the card, at the 8
     pyramid levels of a 640x480 frame (and a ragged height), level by level
     and as the main path calls them, all levels in one launch; with device
     times (CUDA-graph replay, CUDA events) of kernel, plain version,
     library call, the per-level way of calling and the tensor code the
     fused kernel replaces, the time of an empty kernel's launch, the eager
     per-call time, and the roofline bound;
  2b. the motion-only BA kernel (``pose_gn``) against its plain version at
     the main path's shapes (one tracking pass at 512 and at 1024 edges,
     relocalization's four candidates, a batch of loop verifications), with
     ptxas's registers and spills, its device time beside its bound and the
     plain version's, and its launches per tracked frame over a 32-frame
     ``hall`` pass (2 a frame, 3 where tracking takes its wide fallback);
  3. end to end: ``run_sequence`` over a 120-frame full-width synthetic orbit
     on the card, every kernel launch counted (one per frame for each
     frontend kernel), ATE against groundtruth held to the JAX reference's
     ATE on the same sequence;
  4. the streaming Hamming matcher (kernel B3) against its plain version at
     relocalization's shapes (512 frame rows against 65536 map points, no
     window; a random windowed problem; a ragged map; a live map whose
     visible columns are the lowest 600 slots; a map with none visible),
     with its device, plain, eager and bound times;
  5. ``kidnap``: the orbit with blanked frames on a 65536-point map, so that
     tracking is lost twice and relocalized once through the whole-map path
     (B3) and once through BoW; relocalization frames, successes, lost
     frames and closed loops must be the JAX reference's, B3's launches the
     whole-map attempts, and the ATE within the bound; the input of the
     first whole-map call is kept and B3 held to its plain version and timed
     on it;
  6. ``loop``: a full-width sequence on which the JAX reference closes a
     loop; the port must close as many, with the ATE within the bound (the
     keyframe it closes at is printed beside the reference's).  The run is
     phase 10's stream pass, right after phase 5.
  Phases 5 and 6 also time the rare events on the card, synchronized.
  7. global BA: (a) the bench's synthetic problem at full width (256
     keyframes, 50000 points, 512 observations each, rng seed 0): edges and
     landmarks exactly the JAX reference's, cost0, cost1 and the largest
     pose error against ground truth within their tolerances; 6 LM and 40
     CG iterations timed by CUDA events (median of 3 after a warm-up), LM
     iterations per second, CG iterations per LM iteration, and one CG
     application's device time beside its bound; (b) ``run_global_ba()``
     on the engine that phase 6 leaves: cost1 <= cost0 and the ATE after it
     within the bound of the JAX reference's ATE after global BA.
  8. asynchronous local mapping on phase 3's sequence: (a)
     ``run_sequence(..., async_mapping=True)``: 0 lost frames, the JAX
     reference's async keyframe events, the ATE within the bound of the
     reference's async ATE, a landed solve with cost1 <= cost0, no dropped
     solve, one launch per frame of each frontend kernel; the CUDA graphs of
     the deferred and the inline solve held bit-equal to the eager solves
     on one snapshot;
     (b) the same run with ``mapping_device=0`` (the solves on a second
     CUDA stream): the same events and every pose within 1e-6 m of (a); fps
     after the warm-up, host ms of keyframe frames and of flushes, and host
     syncs per frame for the inline, async and async+stream runs; (c) the
     CLI: ``--synthetic 60 --async-mapping --mapping-device 0 --metrics
     --checkpoint-every 5 --checkpoint-dir --profile``, then ``--resume``
     from its checkpoint.  The native loader is held on the CPU only: the
     card's machine has no libpng to build it against.
  9. the parallel layer: (a) ``run_sequences`` over four full-width
     sequences of unequal length on the one card (``kidnap`` and three more
     orbits, ``tools/sequences.py`` BATCH): each sequence's relocalization
     frames, successes, lost frames and closed loops the JAX reference's
     batched run's, each ATE within the bound, no record from a finished
     sequence, one launch of each frontend kernel per active
     sequence-frame, B3's launches ``kidnap``'s whole-map attempts;
     aggregate frames/s beside phase 3's, host syncs per sequence-frame;
     (b) distributed global BA on phase 7a's problem, one rank over NCCL
     and two ranks on the one card over gloo (subprocesses, file
     rendezvous), against the single-device solver with the reference
     test's tolerances, the two ranks bit-equal; LM iterations/s of each;
     (c) the CLI with ``--distributed --global-ba`` as one rank; (d)
     ``run_sequence(batch=8)`` (``feed_batch``) on phase 3's frames: every
     pose within 1e-6 m of phase 3's, one launch per frame of each frontend
     kernel.
 10. the bench's path (``boslam_tpu_torch.bench``'s phase functions) on
     ``loop``'s frames in the wire format (run after phase 5, before phase
     7b takes its stream pass's engine), with ``hall``'s configuration
     (``bench._tracking_cfg``): one stream pass with loops on (the ATE
     within the bound of the JAX reference's, 1 loop, 0 lost frames, one
     launch per frame of each frontend kernel), one ``batch=16`` pass (every
     pose within 1e-6 m of the stream pass's), a pass with loops off (the
     ATE within the bound of the reference's loop-off ATE), the device pass
     (``utils.timing.frame_device_ms`` over 20 frames), every printed
     share at most 1, and the stage pass (``bench_stages``: at least 95 %
     of its device operations launched inside a span of the engine's own);
     then ``bench_global_ba`` at 50k
     landmarks, edges and landmarks exactly phase 7a's.  Prints the bench's
     primary line.

Prints the ``kernels`` JSON line, the card line and, last, the device JSON.
Exits non-zero without a result when no CUDA device is visible or the port
is missing.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))

# ATE of the JAX reference engine (full-width SlamConfig(), SlamSystem with
# MAX_VERIFY = 0, i.e. loop verification off) on the sequence of phase 3,
# measured on the CPU by ``JAX_PLATFORMS=cpu python tools/jax_reference_ate.py``:
# 9 keyframes, 551 points, 0 lost frames, 30 keyframe events.
JAX_REFERENCE_ATE_M = 0.02130824886262417
ATE_FACTOR, ATE_SLACK_M = 1.25, 0.005

# The JAX reference on the sequences of phases 5 and 6 (``tools/sequences.py``),
# loop verification on (MAX_VERIFY = 4), measured on the CPU by
# ``JAX_PLATFORMS=cpu python tools/jax_reference_ate.py --sequence NAME --loops``.
JAX_REFERENCE = {
    "kidnap": dict(ate_m=0.020950505509972572, reloc_frames=[9, 10, 71, 72],
                   reloc_ok_frames=[10, 72],
                   reloc_paths=["global", "global", "bow", "bow"],
                   lost_frames=[8, 70], n_loops_closed=0,
                   loop_closed_frames=[]),
    "loop": dict(ate_m=0.12142354995012283, reloc_frames=[], reloc_ok_frames=[],
                 reloc_paths=[], lost_frames=[], n_loops_closed=1,
                 loop_closed_frames=[291]),
}

# Printed beside the reference's value but not held (ROADMAP C1): the frame
# at which the loop closes depends on float rounding the port cannot share.
# On ``loop`` the engines' first integer divergence is one octave-7
# keypoint at frame 24, from pyramid levels an ulp apart (XLA's resize
# contraction against the port's two matmuls); the port's verification on
# the reference's state decides every request as the reference does, but
# its keyframe culls differ, so the keyframes of the reference's closure
# are gone before the port resolves them (``tools/loop_verify_probe.py``,
# ``tools/engine_divergence.py``).
REPORTED_ONLY = ("loop_closed_frames",)

# Phase 7a: the JAX reference's global BA on the bench's synthetic problem,
# ``JAX_PLATFORMS=cpu python tools/jax_reference_ate.py --ba-problem``.
GBA_PROBLEM = dict(n_kf=256, n_pts=50000, obs_per_kf=512, lm_iters=6,
                   cg_iters=40)
JAX_GBA = dict(n_edges=131019, n_landmarks=40155, cost0=2382497.0,
               cost1=9808.646484375, max_pose_err_m=0.0021189532708376646)
GBA_COST0_RTOL = 1e-4
GBA_COST1_RTOL = 1e-2
GBA_POSE_ERR_FACTOR, GBA_POSE_ERR_SLACK_M = 1.1, 1e-4
# Phase 7b: the JAX reference's ATE after one global BA at the end of
# ``loop``, ``JAX_PLATFORMS=cpu python tools/jax_reference_ate.py --sequence
# loop --loops --global-ba`` (27 keyframes, 1033 points, 6262 edges, cost
# 36201.90 -> 19766.19, ATE 0.12142 -> 0.15859 m).
JAX_GBA_LOOP_ATE_AFTER_M = 0.15858738124370575

# H100 SXM peaks (NVIDIA data sheet) for the roofline bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12  # B3's distance product, as the TPU computes it
PEAK_INT8_OPS_PER_S = 1979e12  # B3's AND-popcount product on the card

# Kernel B3 cases: (name, frame rows, map points, no window); besides these,
# a live map (only the lowest LIVE_SLOTS columns visible, as the engine's
# free list fills its map) and a map with no visible column.
MATCH_CASES = (("reloc", 512, 65536, True), ("window", 512, 65536, False),
               ("ragged", 512, 65536 - 77, False))
LIVE_SLOTS = 600

N_FRAMES, WARMUP = 120, 10

# Phase 8a: the JAX reference with ``async_mapping=True`` on the sequence of
# phase 3, ``JAX_PLATFORMS=cpu python tools/jax_reference_ate.py
# --async-mapping``: 9 keyframes, 554 points, 0 lost frames, 30 keyframe
# events (every fourth frame).
JAX_REFERENCE_ASYNC_ATE_M = 0.02101525478065014
JAX_REFERENCE_ASYNC_KF_EVENTS = 30
STREAM_POSE_ATOL_M = 1e-6
# Phase 9a: the JAX reference's ``run_sequences`` on the four sequences of
# ``sequences.BATCH`` over a 4-device CPU mesh, ``JAX_PLATFORMS=cpu python
# tools/jax_reference_ate.py --batched`` (events from ``sequences.batch_events``).
JAX_BATCHED = {
    "kidnap": dict(ate_m=0.020975813269615173, keyframes=9, points=543,
                   lost_frames=[8, 70], reloc_frames=[9, 10, 71, 72],
                   reloc_ok_frames=[10, 72], loop_closed_frames=[]),
    "batch_a": dict(ate_m=0.020750300958752632, keyframes=9, points=606,
                    lost_frames=[], reloc_frames=[], reloc_ok_frames=[],
                    loop_closed_frames=[]),
    "batch_b": dict(ate_m=0.01484327670186758, keyframes=8, points=573,
                    lost_frames=[], reloc_frames=[], reloc_ok_frames=[],
                    loop_closed_frames=[]),
    "batch_c": dict(ate_m=0.018613949418067932, keyframes=9, points=640,
                    lost_frames=[], reloc_frames=[], reloc_ok_frames=[],
                    loop_closed_frames=[]),
}
BATCH_EVENTS = ("lost_frames", "reloc_frames", "reloc_ok_frames",
                "loop_closed_frames")
# Phase 10: the JAX reference on ``loop`` with loop verification off
# (MAX_VERIFY = 0), ``JAX_PLATFORMS=cpu python tools/jax_reference_ate.py
# --sequence loop``: 27 keyframes, 1041 points, 0 lost frames, 0 loops.
JAX_REFERENCE_LOOP_OFF_ATE_M = 0.1299504041671753
BENCH_DEVICE_WARM, BENCH_DEVICE_FRAMES = 40, 20
# Phase 9b: tests/test_parallel.py's tolerances for distributed global BA.
DGBA_COST0_RTOL, DGBA_POSE_ATOL_M, DGBA_POINT_ATOL_M = 1e-2, 2e-3, 5e-3
DGBA_DIR = os.path.join("build", "smoke_dgba")
FEED_BATCH = 8
# Phase 8c: the CLI's runs.
CLI_FRAMES, CLI_DIR = 60, os.path.join("build", "smoke_cli")
FAST_RTOL, FAST_ATOL = 1e-5, 1e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _median_event_ms(run, per: int, reps: int = 5) -> float:
    import torch

    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / per)
    out.sort()
    return out[len(out) // 2]


def call_ms(fn, iters: int = 50) -> float:
    """CUDA-event ms per call of an eager loop of ``iters`` calls.  For a
    short kernel this is the host's launch rate, not the kernel."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(iters):
            fn()
    return _median_event_ms(run, iters)


def device_ms(fn, iters: int = 20) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's launch cost drops out (inputs stay L2-warm, as
    on the main path, where each level was just written)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    return _median_event_ms(graph.replay, iters)


def check_frontend(dev, cfg):
    """Phase 2: kernels B1 and B2 against their plain versions, level by
    level and all levels in one launch; times and bounds.  Returns the two
    kernels' records."""
    import numpy as np
    import torch

    from boslam_tpu_torch.features import frontend
    from boslam_tpu_torch.io import synthetic
    from boslam_tpu_torch.ops import frontend_cuda as fc
    from boslam_tpu_torch.slam import to_gray_u8

    orb, cam = cfg.orb, cfg.camera
    rgb, _ = synthetic.render_frame(
        cam, np.array([1.0, 0, 0, 0, 0.1, -0.1, 0.2]))
    gray = torch.from_numpy(to_gray_u8(rgb)).to(dev).float()
    levels = frontend.build_pyramid(gray, cfg)
    budgets = frontend.distribute_features(orb.n_features, orb.n_levels,
                                           orb.scale_factor)
    t_hi, t_lo = float(orb.fast_threshold), float(orb.fast_threshold_min)
    args = (t_hi, t_lo, frontend._BOOST_HI, frontend._LEVEL_BORDER)
    kern = frontend._frontend_constants(dev)[0]

    fast = dict(err=0.0, per_level=0.0, plain=0.0, bytes=0.0, ops=0.0, corners=0)
    patch = dict(err=0.0, per_level=0.0, lib=0.0, bytes=0.0)
    plain_maps, blurred_all, ys_all, xs_all, index_all = [], [], [], [], []
    cases = [(f"L{l}", lvl) for l, lvl in enumerate(levels)]
    cases.append(("L0-ragged", levels[0][:477].contiguous()))
    for name, lvl in cases:
        h, w = lvl.shape
        rank, raw = fc.fast_rank(lvl, *args)
        rank_p, raw_p = fc.fast_rank_plain(lvl, *args)
        torch.cuda.synchronize()
        if not torch.equal(rank > 0, rank_p > 0):
            fail(f"fast_rank {name}: rank support differs")
        for a, b, what in ((raw, raw_p, "raw"), (rank, rank_p, "rank")):
            if not torch.allclose(a, b, rtol=FAST_RTOL, atol=FAST_ATOL):
                fail(f"fast_rank {name}: {what} differs, max "
                     f"{float((a - b).abs().max())}")
            if not torch.equal(a, b):
                fail(f"fast_rank {name}: {what} is not bit-identical")
            fast["err"] = max(fast["err"], float((a - b).abs().max()))
        if name.endswith("ragged"):
            print(f"[fast_rank] {name} {h}x{w} ok", flush=True)
            continue
        k = budgets[int(name[1:])]
        ys, xs, _ = frontend._grid_select(rank_p, k, orb.grid_rows, orb.grid_cols)
        blurred = frontend._blur(lvl, kern)
        pk = fc.extract_patches(blurred, ys, xs)
        pp = fc.extract_patches_plain(blurred, ys, xs)
        torch.cuda.synchronize()
        if not torch.equal(pk, pp):
            fail(f"extract_patches {name}: not bit-exact")
        patch["err"] = max(patch["err"], float((pk - pp).abs().max()))
        rows, cols = fc.patch_index(h, w, ys, xs)
        plain_maps.append((rank_p, raw_p))
        blurred_all.append(blurred)
        ys_all.append(ys)
        xs_all.append(xs)
        index_all.append((rows, cols))

        f_ms = device_ms(lambda: fc.fast_rank(lvl, *args))
        f_plain = device_ms(lambda: fc.fast_rank_plain(lvl, *args), iters=5)
        p_ms = device_ms(lambda: fc.extract_patches(blurred, ys, xs))
        p_lib = device_ms(lambda: blurred[rows, cols])
        fast["per_level"] += f_ms
        fast["plain"] += f_plain
        # One read of the level, one write of rank and raw.  Operations, as
        # this frame's data needs them: per score pixel (level + NMS ring)
        # 16 offsets x (1 sub + 2 compares) decide whether it is a corner at
        # the lower threshold; only a corner needs the rest, 16 x (4 x (sub,
        # max, add) + 2 compares) and 2 x 9 NMS maxima.
        n_corner = int((raw_p > 0).sum())
        fast["corners"] += n_corner
        fast["bytes"] += 12.0 * h * w
        fast["ops"] += 16 * 3.0 * (h + 2) * (w + 2) + (16 * 14.0 + 18.0) * n_corner
        patch["per_level"] += p_ms
        patch["lib"] += p_lib
        # The fused function, per keypoint: the 4 KB window and the
        # coordinates read; angle and 8 words written.
        patch["bytes"] += k * (4 * fc.PATCH * fc.PATCH + 8 + 36)
        print(f"[kernels] {name} {h}x{w} K={k}: one-level launches, device "
              f"ms: fast_rank {f_ms:.4f} (plain {f_plain:.4f}), "
              f"extract_patches with its patch output {p_ms:.4f} (gather "
              f"{p_lib:.4f})", flush=True)

    # The [32, 512] uint16 pattern table is read from device memory once.
    patch["bytes"] += fc.brief_table_np().nbytes

    # The main path's calls: every level in one launch.
    maps = fc.fast_rank_levels(levels, *args)
    torch.cuda.synchronize()
    for l, ((rank, raw), (rank_p, raw_p)) in enumerate(zip(maps, plain_maps)):
        if not (torch.equal(rank, rank_p) and torch.equal(raw, raw_p)):
            fail(f"fast_rank_levels: level {l} is not bit-identical to the "
                 f"plain version")
        if rank.data_ptr() % 16 or raw.data_ptr() % 16:
            fail(f"fast_rank_levels: level {l}'s views are not 16-byte aligned")
    angle, desc = fc.describe_patches(blurred_all, ys_all, xs_all)
    torch.cuda.synchronize()
    report = fc.describe_report(blurred_all, ys_all, xs_all, angle, desc)
    print(f"[describe_patches] {json.dumps(report)}", flush=True)
    if report["violations"]:
        fail(f"describe_patches: {report['violations']}")
    patch["err"] = max(patch["err"], report["max_angle_err"])

    def chain():
        return frontend.orient_and_brief(torch.cat(
            [b[r, c] for b, (r, c) in zip(blurred_all, index_all)]))

    floor_fn = fc.kernel_fn("launch_floor")
    floor = device_ms(
        lambda: floor_fn(torch.cuda.current_stream().cuda_stream))
    fast["ms"] = device_ms(lambda: fc.fast_rank_levels(levels, *args))
    patch["ms"] = device_ms(
        lambda: fc.describe_patches(blurred_all, ys_all, xs_all))
    patch["plain"] = device_ms(
        lambda: fc.describe_patches_plain(blurred_all, ys_all, xs_all), iters=5)
    patch["chain"] = device_ms(chain, iters=5)
    f_call = call_ms(lambda: fc.fast_rank_levels(levels, *args))
    p_call = call_ms(lambda: fc.describe_patches(blurred_all, ys_all, xs_all))
    print(f"[kernels] launch_floor_ms {floor:.5f} (an empty kernel built and "
          f"launched the same way, CUDA-graph replay)", flush=True)
    print(f"[kernels] fast_rank, 8 levels in one launch: device ms "
          f"{fast['ms']:.4f} (one launch per level: {fast['per_level']:.4f}; "
          f"plain {fast['plain']:.4f}); eager ms per call {f_call:.4f}; "
          f"{fast['corners']} of {sum(l.numel() for l in levels)} pixels are "
          f"corners at the lower threshold", flush=True)
    print(f"[kernels] extract_patches, gather + orientation + BRIEF of "
          f"{report['keypoints']} keypoints in one launch: device ms "
          f"{patch['ms']:.4f} (plain {patch['plain']:.4f}; the tensor code it "
          f"replaces, 8 gathers + cat + orient_and_brief: {patch['chain']:.4f}; "
          f"patches only, one launch per level: {patch['per_level']:.4f}, "
          f"gather: {patch['lib']:.4f}); eager ms per call {p_call:.4f}",
          flush=True)
    print(f"[kernels] all levels match; comparison launches "
          f"{dict(fc.LAUNCHES)}", flush=True)
    fast["floor"] = floor
    return fast, patch


# Phase 2b: the pose_gn kernel against optimize_pose_plain, with
# tests/test_torch_cuda.py's tolerances (float32, the sums over edges in
# another order), at the main path's shapes: one tracking pass of hall
# (N = 512) and of survey (N = 1024), relocalization's four candidates and
# a batch of loop verifications.
POSE_CASES = ("track512", "track1024", "reloc", "verify")
POSE_Q_ATOL, POSE_T_ATOL, CHI2_EDGE_RTOL = 1e-5, 1e-4, 1e-3
# Flops an edge a Gauss-Newton step (transform 18, projection and residual
# 16, chi2 and the two Huber terms 18, Jacobian 20, weighted rows 18, the
# 21 entries of H 126 and the 6 of b 36) and a cost-only pass (transform,
# residual, chi2, one Huber term: 42).
POSE_STEP_FLOPS, POSE_COST_FLOPS = 252, 42
# Bytes an edge: world point 12, pixel 8, depth 4, octave 4, three masks,
# the inlier flag written; a pose: 7 floats read and written, 2 scalars.
POSE_EDGE_BYTES, POSE_POSE_BYTES = 32, 64
HALL_POSE_FRAMES = 32


def pose_gn_bound(cfg, b, n):
    """(least ms, "bytes" or "operations") of one call over ``b`` poses of
    ``n`` edges: every edge read once, ba_rounds x (ba_iters steps + 2 cost
    passes) + 1 cost pass of arithmetic, at the published peaks."""
    tk = cfg.tracker
    flops = b * n * (tk.ba_rounds * (tk.ba_iters * POSE_STEP_FLOPS
                                     + 2 * POSE_COST_FLOPS) + POSE_COST_FLOPS)
    nbytes = b * (n * POSE_EDGE_BYTES + POSE_POSE_BYTES)
    t_ops = flops / PEAK_F32_OPS_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hold_pose_gn(cfg, name, got, ref, args, kwargs):
    """Violations of the card test's contract between the kernel's and the
    plain version's results (empty when it holds)."""
    import torch

    from boslam_tpu_torch.solvers import pose_opt, robust

    _, pts, uv, depth, hd, obs = args
    r, _ = pose_opt.pose_residuals(cfg, ref.pose, pts, uv, depth, hd)
    info = robust.octave_inv_sigma2(kwargs["octave"], cfg.orb.scale_factor)
    chi2 = torch.sum(r * r, dim=-1) * info
    bound = torch.where(hd, cfg.tracker.chi2_3d, cfg.tracker.chi2_2d)
    near = (chi2 - bound).abs() <= CHI2_EDGE_RTOL * bound
    differ = got.inliers != ref.inliers
    bad = []
    dq = float((got.pose[..., :4] - ref.pose[..., :4]).abs().max())
    dt = float((got.pose[..., 4:] - ref.pose[..., 4:]).abs().max())
    if not dq <= POSE_Q_ATOL:
        bad.append(f"{name}: quaternion differs by {dq}")
    if not dt <= POSE_T_ATOL:
        bad.append(f"{name}: translation differs by {dt} m")
    if bool((differ & ~near).any()):
        bad.append(f"{name}: {int((differ & ~near).sum())} inliers differ "
                   f"away from their chi2 bound")
    if bool(((got.n_inliers - ref.n_inliers).abs()
             > (near & obs).sum(-1)).any()):
        bad.append(f"{name}: n_inliers {got.n_inliers.tolist()} against "
                   f"{ref.n_inliers.tolist()}")
    return bad, dict(dq=dq, dt=dt, inliers_differ=int(differ.sum()))


def check_pose_gn(dev):
    """Phase 2b: the ``pose_gn`` kernel against ``optimize_pose_plain`` at
    the main path's shapes, its registers and spills, its device time
    beside its bound and the plain version's, and its launches per tracked
    frame over a 32-frame ``hall`` pass.  Returns its record."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import _pose_cases
    from boslam_tpu_torch import slam as slam_mod
    from boslam_tpu_torch.loopclosure import detect
    from boslam_tpu_torch.ops import build
    from boslam_tpu_torch.solvers import pose_opt
    from boslam_tpu_torch.tracking import tracker

    build.build_kernels(["pose_gn"], verbose=True)
    usage = [ln.strip() for ln in build.BUILD_LOGS.get("pose_gn", "").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    print(f"[pose_gn] ptxas: {json.dumps(usage)}", flush=True)
    rec = dict(cases={}, ptxas=usage)
    for name in POSE_CASES:
        cfg, args, kwargs = _pose_cases.problem(name, seed=11, device=dev)
        before = build.LAUNCHES["pose_gn"]
        got = pose_opt.optimize_pose(cfg, *args, **kwargs)
        ref = pose_opt.optimize_pose_plain(cfg, *args, **kwargs)
        torch.cuda.synchronize()
        if build.LAUNCHES["pose_gn"] != before + 1:
            fail(f"pose_gn {name}: {build.LAUNCHES['pose_gn'] - before} "
                 f"launches for one call")
        bad, err = hold_pose_gn(cfg, name, got, ref, args, kwargs)
        if bad:
            fail(f"pose_gn: {bad}")
        b = got.pose.numel() // 7
        n = args[1].shape[-2]
        ms = device_ms(lambda: pose_opt.optimize_pose(cfg, *args, **kwargs))
        if b == 1:
            plain = device_ms(
                lambda: pose_opt.optimize_pose_plain(cfg, *args, **kwargs),
                iters=2)
            plain_how = "graph"
        else:  # batched cholesky_solve (MAGMA) allocates: no graph capture
            plain = call_ms(
                lambda: pose_opt.optimize_pose_plain(cfg, *args, **kwargs),
                iters=5)
            plain_how = "eager"
        eager = call_ms(lambda: pose_opt.optimize_pose(cfg, *args, **kwargs))
        plain_eager = call_ms(
            lambda: pose_opt.optimize_pose_plain(cfg, *args, **kwargs), iters=5)
        bound, by = pose_gn_bound(cfg, b, n)
        rec["cases"][name] = dict(
            b=b, n=n, ms=ms, bound_ms=bound, bound_by=by, plain_ms=plain,
            plain_timed_by=plain_how, eager_ms=eager,
            plain_eager_ms=plain_eager, n_inliers=got.n_inliers.tolist(),
            **err)
        print(f"[pose_gn] {name} B={b} N={n}: device ms {ms:.5f} (bound "
              f"{bound:.6f}, {by}; plain {plain:.4f} by {plain_how}); eager ms "
              f"per call {eager:.4f} (plain {plain_eager:.4f}); "
              f"|dq| {err['dq']:.2e} |dt| {err['dt']:.2e} m, "
              f"{err['inliers_differ']} inliers differ", flush=True)

    # Launches per tracked frame over hall's first frames, by caller.
    import sequences
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.io import synthetic

    cfg, _, frames = sequences.build("hall", SlamConfig, synthetic,
                                     n_frames=HALL_POSE_FRAMES)
    calls = collections.Counter()

    def counted(key, fn):
        def wrapped(*a, **k):
            calls[key(*a)] += 1
            return fn(*a, **k)
        return wrapped

    saved = (slam_mod.track_frame, tracker.optimize_pose, detect.optimize_pose)
    passes = []

    def track_frame(*a, **k):
        n0 = calls["track"]
        out = saved[0](*a, **k)
        passes.append(calls["track"] - n0)
        return out

    slam_mod.track_frame = track_frame
    tracker.optimize_pose = counted(
        lambda cfg, pose0, *_: "track" if pose0.dim() == 1 else "reloc",
        saved[1])
    detect.optimize_pose = counted(lambda *_: "verify", saved[2])
    before = build.LAUNCHES["pose_gn"]
    try:
        slam_mod.run_sequence(cfg, frames, device="cuda")
        torch.cuda.synchronize()
    finally:
        slam_mod.track_frame, tracker.optimize_pose, detect.optimize_pose = saved
    launches = build.LAUNCHES["pose_gn"] - before
    per = collections.Counter(passes)
    rec["hall"] = dict(frames=len(frames), tracked_frames=len(passes),
                       launches=launches, calls=dict(calls),
                       passes_per_tracked_frame=dict(per),
                       launches_per_tracked_frame=launches / max(len(passes), 1))
    print(f"[pose_gn] hall, {len(frames)} frames: {json.dumps(rec['hall'])}",
          flush=True)
    if launches != sum(calls.values()):
        fail(f"pose_gn: {launches} launches for {sum(calls.values())} calls")
    if not passes or set(per) - {2, 3}:
        fail(f"pose_gn: tracking passes per tracked frame {dict(per)}, "
             f"expected 2 (3 on fallback frames)")
    return rec


def match_problem(dev, n, m, r_inf, seed=0, live=None):
    """A matching problem of kernel B3's shapes: random 256-bit words, with
    three quarters of the frame rows copied into random map columns with 0
    to 12 bits flipped and placed 3 px from their keypoints; 90% of the rows
    valid, 80% of the columns visible.  ``r_inf``: no window.  ``live``: the
    engine's map, whose free list fills the lowest slots: only the lowest
    ``live`` columns are visible (95% of them) and hold the copies."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    da = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    db = rng.integers(0, 2**32, size=(m, 8), dtype=np.uint64).astype(np.uint32)
    rows = rng.permutation(n)[: min(3 * n // 4, live or m)]
    cols = rng.choice(live or m, size=rows.size, replace=False)
    flips = np.zeros((rows.size, 256), bool)
    for i, k in enumerate(rng.integers(0, 13, rows.size)):
        flips[i, rng.choice(256, k, replace=False)] = True
    words = (flips.reshape(-1, 8, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    db[cols] = da[rows] ^ words
    ua = rng.uniform(0, (640.0, 480.0), size=(n, 2)).astype(np.float32)
    ub = rng.uniform(0, (640.0, 480.0), size=(m, 2)).astype(np.float32)
    ub[cols] = ua[rows] + 3.0
    r = (np.full(n, np.inf, np.float32) if r_inf
         else rng.uniform(8.0, 40.0, size=n).astype(np.float32))
    vis = rng.random(m) < 0.8
    if live is not None:
        vis = np.zeros(m, bool)
        vis[:live] = rng.random(live) < 0.95
    arrays = [da.view(np.int32), ua, r, rng.random(n) < 0.9, db.view(np.int32),
              ub, vis]
    return [torch.from_numpy(a).to(dev) for a in arrays]


def match_bound(n, m, v):
    """(bound ms, what bounds it, the earlier reading) of B3 at N rows x M
    columns of which V are visible.  The least time: the AND-popcount
    product over the visible columns (2*N*V*256 operations at the int8 rate)
    against the bytes the call must move (per row its words, pixel, radius
    and flag in, index, mask and distance out; every column's visibility;
    the visible columns' words and pixels).  The earlier reading: the
    product as the TPU computes it, 2*N*M*256 bf16 operations."""
    t_ops = 2.0 * n * v * 256 / PEAK_INT8_OPS_PER_S * 1e3
    t_bytes = (n * (32 + 8 + 4 + 1 + 4 + 1 + 4) + m + v * (32 + 8)) \
        / PEAK_BYTES_PER_S * 1e3
    bf16 = 2.0 * n * m * 256 / PEAK_BF16_OPS_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", bf16
    return t_bytes, "bytes", bf16


def hold_matcher(hc, name, prob, settings, min_matches=0):
    """Kernel B3 against its plain version on ``prob`` in each of
    ``settings`` (dicts of max_dist / ratio / mutual): idx and ok exactly,
    dist exactly where ok.  Returns (max abs dist error, matches of the
    last setting)."""
    import torch

    err, n_ok = 0.0, 0
    for kw in settings:
        idx, ok, dist = hc.fused_match_top2(*prob, **kw)
        idx_p, ok_p, dist_p = hc.fused_match_top2_plain(*prob, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(ok, ok_p) and torch.equal(idx, idx_p)
                and torch.equal(dist[ok_p], dist_p[ok_p])):
            fail(f"fused_match {name} {kw}: kernel and plain version differ")
        n_ok = int(ok_p.sum())
        if n_ok < min_matches:
            fail(f"fused_match {name}: only {n_ok} matches")
        if n_ok:
            err = max(err, float((dist[ok_p] - dist_p[ok_p]).abs().max()))
    return err, n_ok


ALL_SETTINGS = [dict(max_dist=64, ratio=ratio, mutual=mutual)
                for mutual in (True, False) for ratio in (1.0, 0.85)]


def check_matcher(dev, floor):
    """Phase 4: kernel B3 against its plain version, exact; times at the
    relocalization shape, dense and on a live map (``floor``: the empty
    launch's ms)."""
    from boslam_tpu_torch.ops import hamming_cuda as hc

    out = dict(err=0.0)
    kw = dict(max_dist=50, ratio=0.85, mutual=True)
    cases = [(name, match_problem(dev, n, m, r_inf), n // 4)
             for name, n, m, r_inf in MATCH_CASES]
    cases.append(("live_map", match_problem(dev, 512, 65536, True,
                                            live=LIVE_SLOTS), 100))
    empty = match_problem(dev, 512, 65536, True)
    empty[6].zero_()
    cases.append(("all_invisible", empty, 0))
    for name, prob, min_ok in cases:
        err, n_ok = hold_matcher(hc, name, prob, ALL_SETTINGS, min_ok)
        out["err"] = max(out["err"], err)
        n, m, v = prob[0].shape[0], prob[4].shape[0], int(prob[6].sum())
        print(f"[fused_match] {name} N={n} M={m} visible={v}: kernel = plain "
              f"in all 4 settings, {n_ok} matches at ratio 0.85", flush=True)
        if name in ("reloc", "live_map"):
            ms = device_ms(lambda: hc.fused_match_top2(*prob, **kw))
            bound, by, bf16 = match_bound(n, m, v)
            key = "" if name == "reloc" else "live_map_"
            out.update({f"{key}ms": ms, f"{key}bound": bound,
                        f"{key}bound_by": by, f"{key}visible": v})
            if name == "reloc":
                out["bound_bf16_all"] = bf16
                out["plain"] = device_ms(
                    lambda: hc.fused_match_top2_plain(*prob, **kw), iters=3)
                out["eager"] = call_ms(lambda: hc.fused_match_top2(*prob, **kw))
            print(f"[fused_match] {name}: device ms {ms:.5f} "
                  f"({ms / floor:.2f} launch floors), bound {bound:.6f} ms "
                  f"({by}, int8 rate, {v} visible columns; the product over "
                  f"all {m} columns at the bf16 rate: {bf16:.5f})", flush=True)
    print(f"[fused_match] reloc: plain {out['plain']:.4f} ms, eager ms per "
          f"call {out['eager']:.4f}", flush=True)
    return out


def capture_first_match():
    """Wrap the tracker's ``fused_match_top2`` so that the first call's
    inputs are kept (cloned).  Returns (captured dict, restore)."""
    from boslam_tpu_torch.tracking import tracker

    fn, captured = tracker.fused_match_top2, {}

    def wrap(*a, **k):
        if not captured:
            captured.update(args=[t.clone() for t in a], kw=dict(k))
        return fn(*a, **k)
    tracker.fused_match_top2 = wrap

    def restore():
        tracker.fused_match_top2 = fn
    return captured, restore


def check_captured(captured, floor):
    """B3 on the input of the engine's first whole-map call: exact against
    the plain version in its own setting and in all four; device ms."""
    from boslam_tpu_torch.ops import hamming_cuda as hc

    if not captured:
        fail("kidnap: no whole-map relocalization call was captured")
    prob, kw = captured["args"], captured["kw"]
    err, n_ok = hold_matcher(hc, "kidnap", prob, [kw] + ALL_SETTINGS)
    n, m, v = prob[0].shape[0], prob[4].shape[0], int(prob[6].sum())
    ms = device_ms(lambda: hc.fused_match_top2(*prob, **kw))
    bound, by, _ = match_bound(n, m, v)
    print(f"[fused_match] kidnap's first whole-map call N={n} M={m} "
          f"{kw}: {v} visible columns; kernel = plain in its setting and all "
          f"4 others; device ms {ms:.5f} ({ms / floor:.2f} launch floors), "
          f"bound {bound:.6f} ms ({by})", flush=True)
    return dict(captured_ms=ms, captured_bound=bound, visible_columns=v,
                captured_err=err)


def timed_events():
    """Wrap the rare events the engine binds by name in ``slam`` (train_vocab,
    verify_loops_batch, close_loop_update) in synchronized host clocks.
    Returns ({event: [ms, ...]}, restore)."""
    import torch

    from boslam_tpu_torch import slam as slam_mod

    times = collections.defaultdict(list)
    saved = []
    for name in ("train_vocab", "verify_loops_batch", "close_loop_update"):
        fn = getattr(slam_mod, name)
        saved.append((name, fn))

        def wrap(*a, _fn=fn, _name=name, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = _fn(*a, **k)
            torch.cuda.synchronize()
            times[_name].append((time.perf_counter() - t0) * 1e3)
            return res
        setattr(slam_mod, name, wrap)

    def restore():
        for name, fn in saved:
            setattr(slam_mod, name, fn)
    return times, restore


def run_events(name, fc, built):
    """Phase 5: a named sequence with lost frames, every frame synchronized
    and timed, held to the JAX reference's events (``hold_events``).
    ``built``: the sequence's (cfg, trajectory, frames)."""
    import numpy as np
    import torch

    from boslam_tpu_torch.slam import SlamSystem

    cfg, traj, frames = built
    events, restore = timed_events()
    fc.reset_launches()
    try:
        slam = SlamSystem(cfg)
        ready, frame_ms = [], []
        for f in frames:
            ready.append(bool(slam.loop.vocab_ready))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            slam.feed(*f)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t1) * 1e3)
        slam.flush()
        torch.cuda.synchronize()
    finally:
        restore()
    reloc = [i for i, r in enumerate(slam.metrics) if "reloc_ok" in r]
    report = hold_events(name, slam, traj, len(frames), dict(fc.LAUNCHES),
                         fc, ready, dict(
                             reloc_frame_ms={str(i): frame_ms[i] for i in reloc},
                             event_ms=dict(events),
                             frame_ms_median=float(np.median(frame_ms))))
    return report, slam, traj


def hold_events(name, slam, traj, n_frames, launches, fc, ready=None,
                extra=None):
    """Phases 5 and 6: the events of ``slam``'s run over sequence ``name``
    (relocalizations, their paths by ``ready``, each frame's
    ``vocab_ready``; lost frames; closed loops), its ATE and the kernels'
    ``launches`` over its ``n_frames``, held to the JAX reference's.
    Returns the report (``extra`` added)."""
    import numpy as np
    import torch

    from boslam_tpu_torch.geometry import align

    ref = JAX_REFERENCE[name]
    _, est = slam.trajectory()
    m = slam.metrics
    reloc = [i for i, r in enumerate(m) if "reloc_ok" in r]
    got = dict(
        reloc_frames=reloc,
        reloc_ok_frames=[i for i in reloc if m[i]["reloc_ok"]],
        reloc_paths=["unknown" if ready is None else
                     "bow" if ready[i] else "global" for i in reloc],
        lost_frames=[i for i, r in enumerate(m) if r["lost"]],
        n_loops_closed=slam.n_loops_closed,
        loop_closed_frames=[i for i, r in enumerate(m)
                            if r.get("event") == "loop_closed"],
    )
    rmse, _ = align.ate_rmse(
        torch.from_numpy(est[:, 4:].astype(np.float32)),
        torch.from_numpy(traj.poses_twc[:, 4:].astype(np.float32)))
    ate = float(rmse)
    n_global = got["reloc_paths"].count("global")
    report = dict(got, ate_m=ate, jax_reference_ate_m=ref["ate_m"],
                  launches=launches, global_reloc_attempts=n_global,
                  **(extra or {}))
    print(f"[{name}] {json.dumps(report)}", flush=True)
    if not np.all(np.isfinite(est)) or est.shape != (n_frames, 7):
        fail(f"{name}: trajectory not finite or wrong shape {est.shape}")
    for k, v in got.items():
        if k in REPORTED_ONLY:
            print(f"[{name}] {k}: port {v}, JAX reference {ref[k]}"
                  f"{'' if v == ref[k] else ' (they differ; see REPORTED_ONLY)'}",
                  flush=True)
        elif v != ref[k]:
            fail(f"{name}: {k} {v}, the JAX reference has {ref[k]}")
    bound = ATE_FACTOR * ref["ate_m"] + ATE_SLACK_M
    if not ate <= bound:
        fail(f"{name}: ATE {ate:.5f} m above the bound {bound:.5f} m")
    for k in fc.FRONTEND_KERNELS:
        if launches[k] != n_frames:
            fail(f"{name}: {k}: {launches[k]} launches, expected one per "
                 f"frame, {n_frames}")
    if launches["fused_match"] != n_global:
        fail(f"{name}: fused_match launched {launches['fused_match']} times "
             f"for {n_global} whole-map relocalization attempts")
    return report


def gba_problem(dev):
    """Phase 7a's input: the bench's synthetic problem, moved to ``dev``."""
    import numpy as np

    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.io import synthetic
    from boslam_tpu_torch.mapping.map_state import MapState

    cfg = SlamConfig.from_dict(dict(map=dict(max_keyframes=256,
                                             max_points=65536),
                                    orb=dict(n_features=512)))
    p = GBA_PROBLEM
    st, gt_poses, _ = synthetic.synthetic_ba_problem(
        cfg, np.random.default_rng(0), n_kf=p["n_kf"], n_pts=p["n_pts"],
        obs_per_kf=p["obs_per_kf"])
    return cfg, MapState(*(t.to(dev) for t in st)), gt_poses.to(dev)


def cg_bytes_ops(terms, x):
    """(bytes, operations) of one CG application (``_schur_matvec``) from
    its inputs' shapes: every input read once (the camera-order and sorted
    Jacobians and weights, the schedule's permutations, point ids and
    ranges, the damped blocks, x), y written once; per edge 36 (Jc x) + 3
    (w) + 18 (J_pt^T u) + 3 (the point sum) + 18 (J_pt z) + 3 (w) + 36
    (Jc^T c) + 6 (the camera sum) operations, per point 18 (H_pp^-1 t) and
    per camera 72 + 6 (H_cc x - cross)."""
    Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d, Hpp_inv, sched = terms
    tensors = [Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d, Hpp_inv, sched.perm,
               sched.inv_perm, sched.pt_sorted, sched.starts, sched.ends, x, x]
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    E, P, K = w.shape[0], Hpp_inv.shape[0], x.shape[0]
    return float(n_bytes), float(123 * E + 18 * P + 78 * K)


def check_global_ba(dev, card):
    """Phase 7a: the synthetic problem against the JAX reference's numbers,
    timed; one CG application's device time and bound.  ``card``: the
    card's name and power limit, printed beside the times.  Returns a
    report."""
    import numpy as np
    import torch

    from boslam_tpu_torch.geometry import se3
    from boslam_tpu_torch.solvers import global_ba as gba
    from boslam_tpu_torch.tracking.tracker import HostSync

    t0 = time.perf_counter()
    cfg, st, gt_poses = gba_problem(dev)
    print(f"[gba] synthetic problem built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    p = GBA_PROBLEM

    def solve(sync):
        return gba.global_bundle_adjustment(
            cfg, st, lm_iters=p["lm_iters"], cg_iters=p["cg_iters"], sync=sync)

    st2, stats = solve(HostSync())  # warm-up
    torch.cuda.synchronize()
    times, steps, reads = [], None, 0
    for _ in range(3):
        sync = HostSync()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st2, stats = solve(sync)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
        steps, reads = stats.pcg_steps, sync.count
    ms = float(np.median(times))
    n_kf = p["n_kf"]
    _, terr = se3.pose_distance(st2.kf_pose[:n_kf], gt_poses)
    got = dict(n_edges=int(stats.n_edges),
               n_landmarks=int(st.pt_valid.sum()),
               cost0=float(stats.cost0), cost1=float(stats.cost1),
               max_pose_err_m=float(terr.max()))

    # One CG application on the first LM iteration's system.
    P = st.pt_xyz.shape[0]
    K, N = st.kf_obs_pt.shape
    edges = gba.build_global_edges(cfg, st)
    sched = gba._point_schedule(edges, P)
    mask = st.kf_valid & (torch.arange(K, device=dev) > 0)
    (_, Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d, _, Hpp_inv, _) = gba._assemble(
        cfg, st.kf_pose, st.pt_xyz, edges, sched, mask,
        torch.tensor(1e-4, device=dev), cfg.local_ba.huber_delta, K, N)
    x = torch.randn(K, 6, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0)) * mask[:, None]
    args = (Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d, Hpp_inv, edges, sched, K, N)
    cg_ms = device_ms(lambda: gba._schur_matvec(x, *args))
    cg_eager = call_ms(lambda: gba._schur_matvec(x, *args))
    n_bytes, n_ops = cg_bytes_ops(
        (Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d, Hpp_inv, sched), x)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    report = dict(got, jax_reference=JAX_GBA, card=card, solve_ms=ms,
                  solve_ms_all=times,
                  lm_iters_per_s=p["lm_iters"] / (ms / 1e3),
                  pcg_steps_per_lm_iter=list(steps), host_reads=reads,
                  cg_application_device_ms=cg_ms,
                  cg_application_eager_ms=cg_eager,
                  cg_application_bytes=n_bytes, cg_application_ops=n_ops,
                  cg_application_bound_ms=max(t_bytes, t_ops),
                  cg_application_bound_by="bytes" if t_bytes >= t_ops
                  else "operations")
    print(f"[gba] synthetic {json.dumps(report)}", flush=True)
    for k in ("n_edges", "n_landmarks"):
        if got[k] != JAX_GBA[k]:
            fail(f"global BA: {k} {got[k]}, the JAX reference has {JAX_GBA[k]}")
    for k, rtol in (("cost0", GBA_COST0_RTOL), ("cost1", GBA_COST1_RTOL)):
        if not abs(got[k] - JAX_GBA[k]) <= rtol * JAX_GBA[k]:
            fail(f"global BA: {k} {got[k]} not within {rtol} of the JAX "
                 f"reference's {JAX_GBA[k]}")
    bound = GBA_POSE_ERR_FACTOR * JAX_GBA["max_pose_err_m"] + GBA_POSE_ERR_SLACK_M
    if not got["max_pose_err_m"] <= bound:
        fail(f"global BA: largest pose error {got['max_pose_err_m']} m above "
             f"{bound} m")
    if not all(1 <= k <= p["cg_iters"] for k in steps):
        fail(f"global BA: CG iterations per LM iteration {steps}")
    return report


def check_engine_gba(slam, traj):
    """Phase 7b: ``run_global_ba()`` on the engine phase 6 left."""
    import numpy as np
    import torch

    from boslam_tpu_torch.geometry import align

    def ate():
        _, est = slam.trajectory()
        if not np.all(np.isfinite(est)):
            fail("global BA: trajectory not finite")
        rmse, _ = align.ate_rmse(
            torch.from_numpy(est[:, 4:].astype(np.float32)),
            torch.from_numpy(traj.poses_twc[:, 4:].astype(np.float32)))
        return float(rmse)

    before = ate()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = slam.run_global_ba()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    after = ate()
    report = dict(keyframes=slam.n_keyframes, points=slam.n_points,
                  edges=rec["gba_edges"], cost0=rec["gba_cost0"],
                  cost1=rec["gba_cost1"], ate_before_m=before,
                  ate_after_m=after,
                  jax_reference_ate_after_m=JAX_GBA_LOOP_ATE_AFTER_M,
                  synchronized_ms=ms)
    print(f"[gba] loop {json.dumps(report)}", flush=True)
    if not rec["gba_cost1"] <= rec["gba_cost0"]:
        fail(f"global BA on loop: cost {rec['gba_cost0']} -> {rec['gba_cost1']}")
    bound = ATE_FACTOR * JAX_GBA_LOOP_ATE_AFTER_M + ATE_SLACK_M
    if not after <= bound:
        fail(f"global BA on loop: ATE after {after:.5f} m above the bound "
             f"{bound:.5f} m")
    return report


def host_clock():
    """Wrap ``SlamSystem.feed`` and ``flush`` in host clocks (no device
    synchronization): per frame the ms of its ``feed`` without the flush
    inside it and its start time, per flush its ms.  Returns (record,
    restore)."""
    from boslam_tpu_torch.slam import SlamSystem

    feed0, flush0 = SlamSystem.feed, SlamSystem.flush
    rec = dict(frame_ms=[], start=[], flush_ms=[])
    inner = [0.0]

    def feed(self, *a):
        inner[0] = 0.0
        t0 = time.perf_counter()
        feed0(self, *a)
        rec["frame_ms"].append((time.perf_counter() - t0) * 1e3 - inner[0])
        rec["start"].append(t0)

    def flush(self):
        t0 = time.perf_counter()
        flush0(self)
        dt = (time.perf_counter() - t0) * 1e3
        rec["flush_ms"].append(dt)
        inner[0] += dt

    SlamSystem.feed, SlamSystem.flush = feed, flush

    def restore():
        SlamSystem.feed, SlamSystem.flush = feed0, flush0
    return rec, restore


def run_mode(cfg, traj, frames, mode, fc):
    """One run of phase 8 over ``frames``: ``inline`` and ``async`` through
    ``run_sequence``, ``stream`` as ``SlamSystem(mapping_device=0)`` fed
    frame by frame.  Returns (engine, report, anchored trajectory)."""
    import numpy as np
    import torch

    from boslam_tpu_torch.geometry import align
    from boslam_tpu_torch.slam import SlamSystem, run_sequence

    clock, restore = host_clock()
    fc.reset_launches()
    torch.cuda.synchronize()
    try:
        if mode == "stream":
            slam = SlamSystem(cfg, mapping_device=0)
            for f in frames:
                slam.feed(*f)
            slam.flush()
        else:
            slam = run_sequence(cfg, frames, async_mapping=mode == "async")
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        restore()
    launches = dict(fc.LAUNCHES)
    n = len(frames)
    _, est = slam.trajectory()
    rmse, _ = align.ate_rmse(
        torch.from_numpy(est[:, 4:].astype(np.float32)),
        torch.from_numpy(traj.poses_twc[:, 4:].astype(np.float32)))
    m = slam.metrics
    kf = [i for i, r in enumerate(m) if r.get("event") == "keyframe"]
    kf_ms = [clock["frame_ms"][i] for i in kf]
    landed = [r for r in m if r.get("event") == "keyframe"
              and r["ba_edges"] > 0 and not r.get("ba_dropped")]
    report = dict(
        mode=mode, frames=n,
        fps_after_warmup=(n - WARMUP) / (t_end - clock["start"][WARMUP]),
        kf_frame_host_ms_median=float(np.median(kf_ms)),
        kf_frame_host_ms_max=max(kf_ms),
        other_frame_host_ms_median=float(np.median(
            [t for i, t in enumerate(clock["frame_ms"]) if i not in kf])),
        flush_host_ms_median=float(np.median(clock["flush_ms"])),
        flush_host_ms_max=max(clock["flush_ms"]),
        flushes=len(clock["flush_ms"]),
        host_syncs_per_frame=slam.sync.count / n,
        ate_m=float(rmse), lost=sum(1 for r in m if r["lost"]),
        kf_events=sum(1 for r in m if r.get("event") in ("init", "keyframe")),
        kf_event_frames=[i for i, r in enumerate(m)
                         if r.get("event") in ("init", "keyframe")],
        landed_solves=len(landed),
        solves_cost_down=sum(1 for r in landed
                             if r["ba_cost1"] <= r["ba_cost0"]),
        dropped_solves=sum(1 for r in m if r.get("ba_dropped")),
        keyframes=slam.n_keyframes, points=slam.n_points, launches=launches)
    print(f"[async] {json.dumps(report)}", flush=True)
    if not np.all(np.isfinite(est)) or est.shape != (n, 7):
        fail(f"async {mode}: trajectory not finite or wrong shape {est.shape}")
    if report["lost"]:
        fail(f"async {mode}: {report['lost']} lost frames")
    for k in fc.FRONTEND_KERNELS:
        if launches[k] != n:
            fail(f"async {mode}: {k}: {launches[k]} launches, expected one "
                 f"per frame, {n}")
    return slam, report, est


def check_graph_replay(cfg, slam):
    """The CUDA graphs of local BA against the eager solves on one snapshot
    (the map ``slam`` ended with, around its latest keyframe): the graph
    the async run captured against ``deferred_local_ba``, and the
    process's inline graph for ``cfg`` (captured by the inline run before)
    against ``inline_local_ba``; every output bit-equal."""
    import torch

    from boslam_tpu_torch.mapping.map_state import latest_kf_slot
    from boslam_tpu_torch.solvers import local_ba

    if slam._ba_graph is None:
        fail("async: the deferred solve was not captured in a CUDA graph")
    center = latest_kf_slot(slam.map)
    checks = {
        "deferred": (local_ba.DeferredBaResult._fields[:-1],
                     local_ba.deferred_local_ba(cfg, slam.map, center),
                     slam._ba_graph(slam.map, center)),
        "inline": (("kf_pose", "pt_xyz"),
                   local_ba.inline_local_ba(cfg, slam.map, center),
                   local_ba.inline_graph(cfg, slam.map)(slam.map, center)),
    }
    torch.cuda.synchronize()
    for mode, (names, eager, replay) in checks.items():
        pairs = zip(names + local_ba.LocalBaStats._fields,
                    list(eager[:-1]) + list(eager[-1]),
                    list(replay[:-1]) + list(replay[-1]))
        differ = [name for name, a, b in pairs if not torch.equal(a, b)]
        stats = eager[-1]
        print(f"[async] {mode} graph replay vs eager solve on one snapshot: "
              f"{'bit-equal' if not differ else 'differ in ' + str(differ)}; "
              f"cost {float(stats.cost0):.3f} -> {float(stats.cost1):.3f}, "
              f"{int(stats.n_edges)} edges", flush=True)
        if differ:
            fail(f"{mode} local BA: the CUDA graph's replay differs from the "
                 f"eager solve in {differ}")


def check_async(cfg, traj, frames, fc, card):
    """Phase 8a and 8b on phase 3's sequence; the inline run beside them
    for the host clocks.  Returns the reports."""
    import numpy as np

    reports = {}
    _, reports["inline"], _ = run_mode(cfg, traj, frames, "inline", fc)
    asy, reports["async"], est_a = run_mode(cfg, traj, frames, "async", fc)
    check_graph_replay(cfg, asy)
    a = reports["async"]
    bound = ATE_FACTOR * JAX_REFERENCE_ASYNC_ATE_M + ATE_SLACK_M
    if not a["ate_m"] <= bound:
        fail(f"async: ATE {a['ate_m']:.5f} m above the bound {bound:.5f} m")
    if a["kf_events"] != JAX_REFERENCE_ASYNC_KF_EVENTS:
        fail(f"async: {a['kf_events']} keyframe events, the JAX reference "
             f"has {JAX_REFERENCE_ASYNC_KF_EVENTS}")
    if a["solves_cost_down"] < 1:
        fail("async: no landed solve with cost1 <= cost0")
    if a["dropped_solves"]:
        fail(f"async: {a['dropped_solves']} solves dropped without a loop")
    strm, reports["stream"], est_s = run_mode(cfg, traj, frames, "stream", fc)
    if strm._mapping_stream is None:
        fail("async+stream: the solves did not run on a second stream")

    def events(slam):
        return [(r.get("event"), r["status"], r.get("kf_id"), r.get("ba_edges"),
                 bool(r.get("ba_dropped"))) for r in slam.metrics]

    diff = float(np.abs(est_s[:, 4:] - est_a[:, 4:]).max())
    same_events = events(strm) == events(asy)
    print(f"[async] second stream against the same stream: events "
          f"{'equal' if same_events else 'differ'}, largest position "
          f"difference {diff!r} m, bit-equal poses: "
          f"{bool(np.array_equal(est_s, est_a))}; card {card}", flush=True)
    if not same_events:
        fail("async+stream: events differ from the same-stream run")
    if not diff <= STREAM_POSE_ATOL_M:
        fail(f"async+stream: poses differ by {diff} m from the same-stream "
             f"run (> {STREAM_POSE_ATOL_M})")
    return reports


def run_cli(args, what):
    """``python -m boslam_tpu_torch.main ARGS``; returns (summary dict,
    completed process)."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "boslam_tpu_torch.main", *args],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        print(res.stderr[-3000:], flush=True)
        fail(f"CLI {what}: exit {res.returncode}")
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"[cli] {what} in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(summary)}", flush=True)
    return summary, res


def check_cli():
    """Phase 8c: the CLI with async mapping on the second stream, metrics,
    checkpoints and a profile, then resumed from its last checkpoint: as the
    reference's CLI does, the restored engine is fed the sequence again from
    frame 0, so it writes the checkpoint's frames followed by all 60 (their
    timestamps bit-equal to the first run's) and reports its lost frames."""
    import glob
    import re
    import shutil

    import numpy as np

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    os.makedirs(CLI_DIR)
    ck, prof = os.path.join(CLI_DIR, "ck"), os.path.join(CLI_DIR, "prof")
    jsonl = os.path.join(CLI_DIR, "run.jsonl")
    base = ["--synthetic", str(CLI_FRAMES), "--async-mapping",
            "--mapping-device", "0"]
    first, _ = run_cli(base + ["--out", os.path.join(CLI_DIR, "a.txt"),
                               "--metrics", jsonl, "--checkpoint-every", "5",
                               "--checkpoint-dir", ck, "--profile", prof],
                       "async + metrics + checkpoints + profile")
    with open(jsonl) as f:
        n_lines = sum(1 for _ in f)
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    kernels = 0
    for t in traces:
        with open(t) as f:
            kernels += f.read().count('"cat": "kernel"')
    print(f"[cli] {n_lines} JSONL lines, traces {[(os.path.basename(t), os.path.getsize(t)) for t in traces]} "
          f"with {kernels} device kernel events, checkpoint "
          f"{os.path.exists(os.path.join(ck, 'state.pt'))}", flush=True)
    if first["n_frames"] != CLI_FRAMES or first["lost"]:
        fail(f"CLI: {first['n_frames']} frames, {first['lost']} lost")
    if n_lines != CLI_FRAMES:
        fail(f"CLI: {n_lines} JSONL lines for {CLI_FRAMES} frames")
    if not traces:
        fail("CLI: no trace in the profile dir")
    if not os.path.exists(os.path.join(ck, "state.pt")):
        fail("CLI: no checkpoint written")
    resumed, res = run_cli(base + ["--out", os.path.join(CLI_DIR, "b.txt"),
                                   "--resume", ck], "resumed")
    done = re.search(r"resumed from .*: (\d+) keyframes, (\d+) frames",
                     res.stderr)
    if not done:
        fail("CLI resumed: no 'resumed from' line")
    n_saved = int(done[2])
    a, b = (np.loadtxt(os.path.join(CLI_DIR, f)) for f in ("a.txt", "b.txt"))
    diff = float(np.abs(a[:n_saved, 1:4] - b[:n_saved, 1:4]).max())
    print(f"[cli] resumed after frame {n_saved - 1}, fed frames 0-"
          f"{CLI_FRAMES - 1} again: {resumed['frames']} poses, "
          f"{resumed['lost']} lost frames; the checkpoint's frames re-anchored "
          f"on the resumed map against the first run's, largest position "
          f"difference {diff!r} m", flush=True)
    if (n_saved < 1 or resumed["frames"] != n_saved + CLI_FRAMES
            or resumed["n_frames"] != CLI_FRAMES or len(b) != len(a) + n_saved):
        fail(f"CLI resumed: {resumed['n_frames']} new frames after {n_saved}, "
             f"{resumed['frames']} poses")
    if not (np.array_equal(b[:n_saved, 0], a[:n_saved, 0])
            and np.array_equal(b[n_saved:, 0], a[:, 0])):
        fail("CLI resumed: timestamps differ from the first run's")
    return dict(first=first, resumed=resumed, jsonl_lines=n_lines,
                trace_kernel_events=kernels, resumed_pose_diff_m=diff)


def kidnap_from_orbit(orbit_frames):
    """``kidnap``'s (cfg, trajectory, frames) from phase 3's frames: the same
    orbit, rendered alike, with its blanks."""
    import sequences
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.io import synthetic

    seq = sequences.SEQUENCES["kidnap"]
    return (SlamConfig.from_dict(seq["cfg"]),
            getattr(synthetic, seq["trajectory"][0])(**seq["trajectory"][1]),
            sequences.blank_frames(orbit_frames, seq["blank"]))


def check_batched(orbit_frames, fc, single_fps, kidnap_est, card):
    """Phase 9a: ``run_sequences`` over ``sequences.BATCH`` on the one card.
    ``kidnap``'s frames are phase 3's with its blanks; the other three are
    rendered.  Returns the report."""
    import numpy as np
    import torch

    import sequences
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.geometry import align
    from boslam_tpu_torch.io import synthetic
    from boslam_tpu_torch.parallel import multi

    t0 = time.perf_counter()
    runs = [("kidnap", *kidnap_from_orbit(orbit_frames))]
    # The other three rendered side by side, one process each (numpy only).
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            3, mp_context=multiprocessing.get_context("spawn")) as pool:
        rendered = list(pool.map(render_sequence, sequences.BATCH[1:]))
    runs += [(name, *built) for name, built in zip(sequences.BATCH[1:],
                                                   rendered)]
    if any(r[1] != runs[0][1] for r in runs):
        fail("batched: the sequences' configurations differ")
    cfg = runs[0][1]
    lengths = [len(r[3]) for r in runs]
    print(f"[batched] {sum(lengths)} frames {lengths} ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # Host clocks around the engine's feed, and when the flushes train
    # sequence 0's vocabulary (whole-map relocalization before that).
    feed0, flush0 = multi.BatchedSlamSystem.feed, multi.BatchedSlamSystem.flush
    stamps, flushes = [], []

    def feed(self, *a, **k):
        stamps.append(time.perf_counter())
        feed0(self, *a, **k)

    def flush(self):
        flush0(self)
        flushes.append((len(self.metrics[0]), self._vocab_trained_at[0] >= 0))

    multi.BatchedSlamSystem.feed, multi.BatchedSlamSystem.flush = feed, flush
    fc.reset_launches()
    torch.cuda.synchronize()
    try:
        eng = multi.run_sequences(cfg, [r[3] for r in runs])
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        multi.BatchedSlamSystem.feed = feed0
        multi.BatchedSlamSystem.flush = flush0
    launches = dict(fc.LAUNCHES)
    after = sum(max(0, n - WARMUP) for n in lengths)
    agg_fps = after / (t_end - stamps[WARMUP])
    vocab_from = min([c for c, trained in flushes if trained],
                     default=lengths[0])
    per_seq = {}
    for s, (name, _, traj, frames) in enumerate(runs):
        _, est = eng.trajectory(s)
        rmse, _ = align.ate_rmse(
            torch.from_numpy(est[:, 4:].astype(np.float32)),
            torch.from_numpy(traj.poses_twc[:, 4:].astype(np.float32)))
        if not np.all(np.isfinite(est)) or est.shape != (len(frames), 7):
            fail(f"batched {name}: trajectory not finite or wrong shape "
                 f"{est.shape}")
        per_seq[name] = dict(ate_m=float(rmse), keyframes=eng.n_keyframes(s),
                             points=eng.n_points(s),
                             records=len(eng.metrics[s]),
                             **sequences.batch_events(eng.metrics[s]))
        if name == "kidnap":
            per_seq[name]["pose_diff_vs_single_engine_m"] = float(
                np.abs(est[:, 4:] - kidnap_est[:, 4:]).max())
    n_global = sum(1 for i in per_seq["kidnap"]["reloc_frames"]
                   if i < vocab_from)
    report = dict(sequences=per_seq, frames=sum(lengths),
                  aggregate_fps_after_warmup=agg_fps,
                  single_engine_fps_after_warmup=single_fps,
                  host_syncs_per_sequence_frame=sum(
                      h.count for h in eng.sync) / sum(lengths),
                  vocab_trained_from_frame=vocab_from,
                  global_reloc_attempts=n_global, launches=launches, card=card,
                  jax_reference=JAX_BATCHED)
    print(f"[batched] {json.dumps(report)}", flush=True)
    for name, got in per_seq.items():
        ref = JAX_BATCHED[name]
        n = lengths[sequences.BATCH.index(name)]
        if got["records"] != n or len(eng.timestamps[
                sequences.BATCH.index(name)]) != n:
            fail(f"batched {name}: {got['records']} records for {n} frames")
        for k in BATCH_EVENTS:
            if got[k] != ref[k]:
                fail(f"batched {name}: {k} {got[k]}, the JAX reference has "
                     f"{ref[k]}")
        bound = ATE_FACTOR * ref["ate_m"] + ATE_SLACK_M
        if not got["ate_m"] <= bound:
            fail(f"batched {name}: ATE {got['ate_m']:.5f} m above the bound "
                 f"{bound:.5f} m")
    for k in fc.FRONTEND_KERNELS:
        if launches[k] != sum(lengths):
            fail(f"batched: {k}: {launches[k]} launches, expected one per "
                 f"active sequence-frame, {sum(lengths)}")
    if launches["fused_match"] != n_global or n_global < 1:
        fail(f"batched: fused_match launched {launches['fused_match']} times "
             f"for {n_global} whole-map relocalization attempts")
    return report


def render_sequence(name):
    """(cfg, trajectory, frames) of ``tools/sequences.py``'s ``name``."""
    import sequences
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.io import synthetic

    return sequences.build(name, SlamConfig, synthetic)


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def timed_dgba(cfg, mesh, st, reps: int = 3):
    """``distributed_global_ba`` on ``st`` after a warm-up: (new state,
    (cost0, cost1, n_edges), median ms, host reads)."""
    import numpy as np
    import torch

    from boslam_tpu_torch.parallel.sharded_global_ba import (
        distributed_global_ba,
    )
    from boslam_tpu_torch.tracking.tracker import HostSync

    p = GBA_PROBLEM
    distributed_global_ba(cfg, mesh, st, p["lm_iters"], p["cg_iters"])
    times = []
    for _ in range(reps):
        sync = HostSync()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stats = distributed_global_ba(cfg, mesh, st, p["lm_iters"],
                                           p["cg_iters"], sync=sync)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, stats, float(np.median(times)), sync.count


def dgba_rank(rank: int, world: int, rdzv: str, out: str) -> None:
    """One rank of phase 9b(ii), run as ``chip_smoke.py --dgba-rank RANK
    WORLD RDZV OUT``: gloo over the one card, results saved to OUT."""
    import numpy as np
    import torch

    os.environ.update(BOSLAM_COORDINATOR=f"file://{rdzv}",
                      BOSLAM_NUM_PROCESSES=str(world),
                      BOSLAM_PROCESS_ID=str(rank))
    from boslam_tpu_torch.parallel.distributed import maybe_initialize
    from boslam_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    if not maybe_initialize(device="cuda:0", backend="gloo", timeout=300.0):
        sys.exit(3)
    mesh = make_mesh()
    cfg, st, _ = gba_problem(torch.device("cuda:0"))
    new, (c0, c1, n_edges), ms, reads = timed_dgba(cfg, mesh, st)
    np.savez(out, kf_pose=new.kf_pose.cpu().numpy(),
             pt_xyz=new.pt_xyz.cpu().numpy(), cost0=c0, cost1=c1,
             n_edges=n_edges, ms=ms, host_reads=reads,
             pt=mesh.shape["pt"])
    torch.distributed.destroy_process_group()


def hold_dgba(what, got, c0, c1, n_edges, ref_state, ref_stats, kf_valid,
              pt_valid):
    """Distributed against single-device global BA, with
    tests/test_parallel.py's tolerances.  Returns the largest errors."""
    import numpy as np

    kf = np.asarray(got["kf_pose"])
    pt = np.asarray(got["pt_xyz"])
    pose_err = float(np.abs(kf[:, 4:] - ref_state.kf_pose[:, 4:].cpu().numpy())
                     [kf_valid].max())
    point_err = float(np.linalg.norm(pt - ref_state.pt_xyz.cpu().numpy(),
                                     axis=-1)[pt_valid].max())
    ref_c0 = float(ref_stats.cost0)
    if n_edges != int(ref_stats.n_edges):
        fail(f"distributed global BA {what}: {n_edges} edges, the "
             f"single-device solver has {int(ref_stats.n_edges)}")
    if not abs(c0 - ref_c0) < DGBA_COST0_RTOL * max(ref_c0, 1.0):
        fail(f"distributed global BA {what}: cost0 {c0} against {ref_c0}")
    if not c1 < c0:
        fail(f"distributed global BA {what}: cost {c0} -> {c1}")
    if not pose_err < DGBA_POSE_ATOL_M:
        fail(f"distributed global BA {what}: poses {pose_err} m apart")
    if not point_err < DGBA_POINT_ATOL_M:
        fail(f"distributed global BA {what}: points {point_err} m apart")
    return pose_err, point_err


def check_distributed_gba(dev, card):
    """Phase 9b on phase 7a's problem.  Returns the report."""
    import shutil

    import numpy as np
    import torch

    from boslam_tpu_torch.parallel.distributed import (
        maybe_initialize, runtime_info,
    )
    from boslam_tpu_torch.parallel.mesh import make_mesh
    from boslam_tpu_torch.solvers.global_ba import global_bundle_adjustment

    p = GBA_PROBLEM
    cfg, st, _ = gba_problem(dev)
    global_bundle_adjustment(cfg, st, p["lm_iters"], p["cg_iters"])
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_state, ref_stats = global_bundle_adjustment(
            cfg, st, p["lm_iters"], p["cg_iters"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms0 = float(np.median(times))
    kf_valid = st.kf_valid.cpu().numpy()
    pt_valid = st.pt_valid.cpu().numpy()

    # (i) one rank over NCCL, in this process.
    env = dict(BOSLAM_COORDINATOR=f"localhost:{free_port()}",
               BOSLAM_NUM_PROCESSES="1", BOSLAM_PROCESS_ID="0")
    os.environ.update(env)
    try:
        if not maybe_initialize(device="cuda:0"):
            fail("distributed: the one-rank NCCL group did not come up")
    finally:
        for k in env:
            os.environ.pop(k)
    info = runtime_info()
    backend = torch.distributed.get_backend()
    new, (c0, c1, n_edges), ms1, reads1 = timed_dgba(cfg, make_mesh(), st)
    torch.distributed.destroy_process_group()
    one = dict(kf_pose=new.kf_pose.cpu().numpy(),
               pt_xyz=new.pt_xyz.cpu().numpy())
    err1 = hold_dgba("one rank", one, c0, c1, n_edges, ref_state, ref_stats,
                     kf_valid, pt_valid)

    # (ii) two ranks on the one card over gloo, as subprocesses.
    shutil.rmtree(DGBA_DIR, ignore_errors=True)
    os.makedirs(DGBA_DIR)
    rdzv = os.path.abspath(os.path.join(DGBA_DIR, "rdzv"))
    outs = [os.path.join(DGBA_DIR, f"rank{r}.npz") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dgba-rank", str(r),
         "2", rdzv, outs[r]], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    for r, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail("distributed global BA two ranks: timed out")
        if proc.returncode != 0:
            print(err[-3000:], flush=True)
            fail(f"distributed global BA rank {r}: exit {proc.returncode}")
    wall = time.perf_counter() - t0
    ranks = [dict(np.load(o)) for o in outs]
    for k in ("kf_pose", "pt_xyz", "cost0", "cost1", "n_edges"):
        if not np.array_equal(ranks[0][k], ranks[1][k]):
            fail(f"distributed global BA two ranks: {k} differs between ranks")
    r0 = ranks[0]
    if int(r0["pt"]) != 2:
        fail(f"distributed global BA two ranks: pt={int(r0['pt'])}")
    err2 = hold_dgba("two ranks", r0, float(r0["cost0"]), float(r0["cost1"]),
                     int(r0["n_edges"]), ref_state, ref_stats, kf_valid,
                     pt_valid)
    report = dict(
        card=card, runtime_info=info, backend=backend, edges=n_edges,
        single_device=dict(cost0=float(ref_stats.cost0),
                           cost1=float(ref_stats.cost1), ms=ms0,
                           lm_iters_per_s=p["lm_iters"] / (ms0 / 1e3)),
        one_rank=dict(cost0=c0, cost1=c1, ms=ms1,
                      lm_iters_per_s=p["lm_iters"] / (ms1 / 1e3),
                      host_reads=reads1, pose_err_m=err1[0],
                      point_err_m=err1[1]),
        two_ranks_gloo=dict(cost0=float(r0["cost0"]),
                            cost1=float(r0["cost1"]),
                            ms=[float(r["ms"]) for r in ranks],
                            lm_iters_per_s=p["lm_iters"] / (float(r0["ms"]) / 1e3),
                            host_reads=int(r0["host_reads"]),
                            pose_err_m=err2[0], point_err_m=err2[1],
                            ranks_bit_equal=True, wall_s=wall))
    print(f"[dgba] {json.dumps(report)}", flush=True)
    print("[note] dgba two_ranks_gloo: two processes on the ONE card, their "
          "collectives over gloo, which stages the CUDA tensors through the "
          "host; not a multi-card number", flush=True)
    return report


def check_cli_distributed():
    """Phase 9c: ``--synthetic 60 --distributed --global-ba`` as one rank."""
    import math

    env = dict(os.environ, BOSLAM_COORDINATOR=f"localhost:{free_port()}",
               BOSLAM_NUM_PROCESSES="1", BOSLAM_PROCESS_ID="0")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "boslam_tpu_torch.main", "--synthetic",
         str(CLI_FRAMES), "--distributed", "--global-ba", "--out",
         os.path.join(CLI_DIR, "dist.txt")],
        capture_output=True, text=True, timeout=600, env=env)
    if res.returncode != 0:
        print(res.stderr[-3000:], flush=True)
        fail(f"CLI --distributed: exit {res.returncode}")
    line = [x for x in res.stderr.splitlines() if x.startswith("[distributed]")]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"[cli] --distributed --global-ba in {time.perf_counter() - t0:.1f} "
          f"s: {line} {json.dumps(summary)}", flush=True)
    if not line or "'initialized': True" not in line[0]:
        fail("CLI --distributed: the process group did not come up")
    if "global BA: cost" not in res.stderr:
        fail("CLI --distributed: no global BA line")
    if not math.isfinite(summary.get("ate_rmse_m", float("nan"))):
        fail("CLI --distributed: no ATE")
    return dict(summary=summary, distributed_line=line[0])


def check_feed_batch(cfg, frames, est3, fc):
    """Phase 9d: ``run_sequence(batch=8)`` on phase 3's frames."""
    import numpy as np
    import torch

    from boslam_tpu_torch.slam import run_sequence

    fc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam = run_sequence(cfg, frames, batch=FEED_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)
    _, est = slam.trajectory()
    diff = float(np.abs(est[:, 4:] - est3[:, 4:]).max())
    report = dict(batch=FEED_BATCH, frames=len(frames), wall_s=wall,
                  fps=len(frames) / wall, max_pose_diff_vs_phase3_m=diff,
                  batch_mode_records=sum(1 for m in slam.metrics
                                         if m.get("batch_mode")),
                  launches=launches)
    print(f"[feed_batch] {json.dumps(report)}", flush=True)
    if not diff <= STREAM_POSE_ATOL_M:
        fail(f"feed_batch: poses {diff} m from phase 3's")
    for k in fc.FRONTEND_KERNELS:
        if launches[k] != len(frames):
            fail(f"feed_batch: {k}: {launches[k]} launches for "
                 f"{len(frames)} frames")
    return report


def check_bench(loop_built, fc, card):
    """Phases 6 and 10: the bench's phase functions on ``loop``'s frames at
    full width; phase 6's checks hold the stream pass's engine.  Returns
    (report, {kernel: launches} of the stream and batch passes, the stream
    pass's engine)."""
    import numpy as np
    import torch

    from boslam_tpu_torch import bench

    cfg, traj, raw = loop_built
    if cfg != bench._tracking_cfg(2):
        fail("bench: loop's configuration is not the bench's _tracking_cfg")
    frames = [bench._wire(cfg, *f) for f in raw]
    events, restore = timed_events()
    fc.reset_launches()
    torch.cuda.synchronize()
    try:
        extras, engines = bench.bench_tracking(
            cfg, frames, traj, budget=bench.Budget(900.0), device="cuda",
            n_passes=1, n_batch_passes=1)
    finally:
        restore()
    launches = dict(fc.LAUNCHES)
    # Phase 6: the stream pass against the JAX reference's events.
    hold_events("loop", engines["stream"], traj, len(frames),
                {k: extras[f"{k}_launches_per_frame"] * len(frames)
                 for k in launches}, fc,
                extra=dict(event_ms=dict(events), fps=extras["fps_stream"]))
    _, est_s = engines["stream"].trajectory()
    _, est_b = engines["batch"].trajectory()
    batch_diff = float(np.abs(est_s[:, 4:] - est_b[:, 4:]).max())
    stream_ate = bench._ate(engines["stream"], traj)
    extras.update(bench.bench_error_budget_cheap(cfg, frames, traj,
                                                 device="cuda"))
    kf_rate = sum(1 for r in engines["stream"].metrics
                  if r.get("event") == "keyframe") / len(frames)
    extras.update(bench.bench_device_path(
        cfg, frames, warm=BENCH_DEVICE_WARM, kf_events_per_frame=kf_rate,
        device="cuda", n_frames=BENCH_DEVICE_FRAMES))
    extras.update(bench.bench_stages(
        cfg, frames, warm=BENCH_DEVICE_WARM, device="cuda",
        n_frames=BENCH_DEVICE_FRAMES))
    gba = bench.bench_global_ba(GBA_PROBLEM["n_pts"], device="cuda")
    print(f"[bench] {json.dumps(bench._line(dict(extras, card=card)))}",
          flush=True)
    report = dict(stream_ate_m=stream_ate, batch_pose_diff_m=batch_diff,
                  launches=launches, global_ba=gba)
    print(f"[bench] phase 10: {json.dumps(report)}", flush=True)

    bound = ATE_FACTOR * JAX_REFERENCE["loop"]["ate_m"] + ATE_SLACK_M
    if not stream_ate <= bound:
        fail(f"bench: stream ATE {stream_ate:.5f} m above the bound {bound:.5f}")
    bound = ATE_FACTOR * JAX_REFERENCE_LOOP_OFF_ATE_M + ATE_SLACK_M
    if not extras["ate_loop_off_m"] <= bound:
        fail(f"bench: loop-off ATE {extras['ate_loop_off_m']:.5f} m above "
             f"the bound {bound:.5f}")
    if extras["loops_closed"] != 1 or extras["lost_frames"]:
        fail(f"bench: {extras['loops_closed']} loops, "
             f"{extras['lost_frames']} lost frames")
    if not batch_diff <= STREAM_POSE_ATOL_M:
        fail(f"bench: the batch pass's poses {batch_diff} m from the stream's")
    for k in fc.FRONTEND_KERNELS:
        if extras[f"{k}_launches_per_frame"] != 1.0 or \
                launches[k] != 2 * len(frames):
            fail(f"bench: {k}: {extras[f'{k}_launches_per_frame']} launches "
                 f"per frame, {launches[k]} in the stream and batch passes")
    shares = {k: v for k, v in extras.items()
              if "_util_" in k or k == "device_idle_share"}
    if "step_util_flops" not in shares or len(shares) < 2:
        fail(f"bench: shares missing, got {sorted(shares)}")
    if not all(0.0 <= v <= 1.0 for v in shares.values()):
        fail(f"bench: a share outside [0, 1]: {shares}")
    from boslam_tpu_torch.utils.timing import NO_LAUNCH, NO_SPAN

    ops = extras["stages_device_ops"]
    outside = ops.get(NO_SPAN, 0.0) + ops.get(NO_LAUNCH, 0.0)
    if not outside <= 0.05 * sum(ops.values()):
        fail(f"bench: {outside} of {sum(ops.values())} device operations a "
             f"frame launched outside every span")
    for k, ref in (("ba_edges", JAX_GBA["n_edges"]),
                   ("ba_landmarks", JAX_GBA["n_landmarks"])):
        if gba[k] != ref:
            fail(f"bench: global BA {k} {gba[k]}, phase 7a's is {ref}")
    return report, launches, engines["stream"]


def main() -> None:
    if sys.argv[1:2] == ["--dgba-rank"]:
        dgba_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])
        return
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    import numpy as np

    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.geometry import align
    from boslam_tpu_torch.io import synthetic
    from boslam_tpu_torch.ops import frontend_cuda as fc
    from boslam_tpu_torch.slam import run_sequence

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. card and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[card] {smi}", flush=True)
    print(f"[torch] {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    fc.build_kernels(verbose=True)
    print(f"[build] {len(fc.KERNELS)} kernels and the empty launch_floor in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 2. kernels against their plain versions --------------------------
    cfg = SlamConfig()
    orb, cam = cfg.orb, cfg.camera
    fast, patch = check_frontend(dev, cfg)
    pose = check_pose_gn(dev)

    # ---- 3. end to end -----------------------------------------------------
    traj = orbit_traj = synthetic.orbit_trajectory(N_FRAMES, radius=0.6,
                                                   yaw_amplitude=0.3)
    t0 = time.perf_counter()
    frames = orbit_frames = synthetic.render_sequence(cam, traj,
                                                      depth_noise=0.01, seed=0)
    print(f"[e2e] rendered {N_FRAMES} frames {cam.width}x{cam.height} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    stamps = []

    def timed(frames):
        for f in frames:
            stamps.append(time.perf_counter())
            yield f

    fc.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            slam = run_sequence(cfg, timed(frames), device="cuda")
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    t_end = time.perf_counter()
    launches = dict(fc.LAUNCHES)
    sync_sites = collections.Counter(
        f"{w.filename.rsplit('/', 2)[-1]}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    sync_warnings = sum(sync_sites.values())
    print(f"[e2e] synchronizing calls by site: "
          f"{json.dumps(dict(sync_sites.most_common(12)))}", flush=True)
    fps = (N_FRAMES - WARMUP) / (t_end - stamps[WARMUP])
    ts, est = slam.trajectory()
    est3 = est
    rmse, _ = align.ate_rmse(
        torch.from_numpy(est[:, 4:].astype(np.float32)),
        torch.from_numpy(traj.poses_twc[:, 4:].astype(np.float32)))
    ate = float(rmse)
    n_lost = sum(1 for m in slam.metrics if m.get("lost", False))
    n_kf_events = sum(1 for m in slam.metrics
                      if m.get("event") in ("init", "keyframe"))
    e2e = {
        "frames": N_FRAMES, "fps_after_warmup": fps,
        "ms_per_frame": 1e3 / fps, "keyframes": slam.n_keyframes,
        "points": slam.n_points, "kf_events": n_kf_events, "lost": n_lost,
        "host_syncs_per_frame": slam.sync.count / N_FRAMES,
        "sync_warnings_per_frame": sync_warnings / N_FRAMES,
        "ate_m": ate, "jax_reference_ate_m": JAX_REFERENCE_ATE_M,
        "launches": launches,
    }
    print(f"[e2e] {json.dumps(e2e)}", flush=True)
    if not np.all(np.isfinite(est)) or est.shape != (N_FRAMES, 7):
        fail(f"trajectory not finite or wrong shape {est.shape}")
    if n_lost:
        fail(f"{n_lost} lost frames")
    for name in fc.FRONTEND_KERNELS:
        if launches[name] != N_FRAMES:
            fail(f"{name}: {launches[name]} launches, expected one per "
                 f"frame, {N_FRAMES}")
    bound = ATE_FACTOR * JAX_REFERENCE_ATE_M + ATE_SLACK_M
    if not ate <= bound:
        fail(f"ATE {ate:.5f} m above the bound {bound:.5f} m")

    # ``loop``'s 320 frames render in a side process during phases 4 and 5;
    # ``kidnap`` is phase 3's orbit with its blanks.
    import concurrent.futures
    import multiprocessing

    t0 = time.perf_counter()
    render_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        loop_built = render_pool.submit(render_sequence, "loop")

        # ---- 4. kernel B3 against its plain version -------------------------
        match = check_matcher(dev, fast["floor"])

        # ---- 5. relocalization ----------------------------------------------
        captured, restore = capture_first_match()
        try:
            report, slam, _ = run_events("kidnap", fc,
                                         kidnap_from_orbit(orbit_frames))
        finally:
            restore()
        kidnap_est = slam.trajectory()[1]
        match["launches"] = report["launches"]["fused_match"]
        if match["launches"] < 1:
            fail("kidnap: fused_match was never launched")
        match.update(check_captured(captured, fast["floor"]))
        loop_frames = loop_built.result()
        print(f"[loop] {len(loop_frames[2])} frames rendered aside, ready "
              f"{time.perf_counter() - t0:.1f} s after the render began",
              flush=True)
    finally:
        render_pool.shutdown(cancel_futures=True)

    # ---- 6, 10. loop closing on the bench's path --------------------------------
    _, bench_launches, slam = check_bench(loop_frames, fc, smi)

    # ---- 7. global BA ---------------------------------------------------------
    check_engine_gba(slam, loop_frames[1])  # the engine of phase 6, ``loop``
    del slam
    check_global_ba(dev, smi)

    # ---- 8. asynchronous local mapping, the CLI ---------------------------------
    asy = check_async(cfg, orbit_traj, orbit_frames, fc, smi)
    check_cli()
    print(f"[time] phases 1-8 and 10 in {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # ---- 9. the parallel layer ------------------------------------------------
    bat = check_batched(orbit_frames, fc, fps, kidnap_est, smi)
    check_distributed_gba(dev, smi)
    check_cli_distributed()
    fbat = check_feed_batch(cfg, orbit_frames, est3, fc)

    def bound_of(bytes_, ops):
        t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    f_bound, f_by = bound_of(fast["bytes"], fast["ops"])
    p_bound, p_by = bound_of(patch["bytes"], 0.0)
    kernels = [
        {"name": "fast_rank", "route": "cuda",
         "source": "boslam_tpu_torch/csrc/fast_rank.cu",
         "replaces": "boslam_tpu/ops/frontend_pallas.py:132",
         "launches": launches["fast_rank"], "max_abs_err": fast["err"],
         "ms": fast["ms"], "plain_ms": fast["plain"], "bound_ms": f_bound,
         "bound_by": f_by, "library_ms": None,
         "async_launches": asy["async"]["launches"]["fast_rank"],
         "async_stream_launches": asy["stream"]["launches"]["fast_rank"],
         "batched_launches": bat["launches"]["fast_rank"],
         "feed_batch_launches": fbat["launches"]["fast_rank"],
         "bench_launches": bench_launches["fast_rank"]},
        {"name": "extract_patches", "route": "cuda",
         "source": "boslam_tpu_torch/csrc/describe_patches.cu",
         "replaces": "boslam_tpu/ops/frontend_pallas.py:195",
         "launches": launches["extract_patches"], "max_abs_err": patch["err"],
         "ms": patch["ms"], "plain_ms": patch["plain"], "bound_ms": p_bound,
         "bound_by": p_by, "library_ms": patch["lib"],
         "async_launches": asy["async"]["launches"]["extract_patches"],
         "async_stream_launches": asy["stream"]["launches"]["extract_patches"],
         "batched_launches": bat["launches"]["extract_patches"],
         "feed_batch_launches": fbat["launches"]["extract_patches"],
         "bench_launches": bench_launches["extract_patches"]},
        {"name": "fused_match", "route": "cuda",
         "source": "boslam_tpu_torch/csrc/fused_match.cu",
         "replaces": "boslam_tpu/ops/hamming_pallas.py:145",
         "launches": match["launches"],
         "max_abs_err": max(match["err"], match["captured_err"]),
         "ms": match["ms"], "plain_ms": match["plain"],
         "bound_ms": match["bound"], "bound_by": match["bound_by"],
         "library_ms": None, "visible_columns": match["visible"],
         "bound_bf16_all_columns_ms": match["bound_bf16_all"],
         "eager_ms": match["eager"],
         "live_map_ms": match["live_map_ms"],
         "live_map_bound_ms": match["live_map_bound"],
         "live_map_visible_columns": match["live_map_visible"],
         "captured_ms": match["captured_ms"],
         "captured_bound_ms": match["captured_bound"],
         "captured_visible_columns": match["visible_columns"],
         "batched_launches": bat["launches"]["fused_match"],
         "bench_launches": bench_launches["fused_match"]},
        {"name": "pose_gn", "route": "cuda",
         "source": "boslam_tpu_torch/csrc/pose_gn.cu",
         "replaces": None, "stands_for": "boslam_tpu/solvers/pose_opt.py:115",
         "launches": launches["pose_gn"],
         "max_abs_err": max(max(c["dq"], c["dt"])
                            for c in pose["cases"].values()),
         "ms": pose["cases"]["track512"]["ms"],
         "plain_ms": pose["cases"]["track512"]["plain_ms"],
         "bound_ms": pose["cases"]["track512"]["bound_ms"],
         "bound_by": pose["cases"]["track512"]["bound_by"],
         "library_ms": None, "cases": pose["cases"], "hall": pose["hall"],
         "ptxas": pose["ptxas"],
         "async_launches": asy["async"]["launches"]["pose_gn"],
         "batched_launches": bat["launches"]["pose_gn"],
         "feed_batch_launches": fbat["launches"]["pose_gn"],
         "bench_launches": bench_launches["pose_gn"]},
    ]
    print("[note] fast_rank: one launch over the 8 levels of one 640x480 "
          "frame (plain_ms: the plain version level by level); "
          "extract_patches: gather + orientation + BRIEF of the frame's 512 "
          "keypoints in one launch (plain_ms: extract_patches_plain -> "
          "orient_and_brief; library_ms: the 8 advanced-indexing gathers, "
          "patches only); launches from phase 3, async_launches and "
          "async_stream_launches from phase 8a and 8b, batched_launches from "
          "phase 9a (four sequences, 310 sequence-frames), "
          "feed_batch_launches from phase 9d, bench_launches from phase 10's "
          "stream and batch passes (640 frames); fused_match: one call at "
          "512 x 65536 without a window, 80% of the columns visible "
          "(bound_ms over the visible columns at the int8 rate; eager_ms: "
          "host ms per eager call), live_map_*: the lowest 600 slots "
          "visible, captured_*: the input of kidnap's first whole-map call, "
          "launches from phase 5; pose_gn: one tracking pass at 512 edges "
          "(cases: every shape of phase 2b; replaces no Pallas kernel, "
          "stands for the reference's lax.scan Gauss-Newton loops); ms, plain_ms "
          "and library_ms are device times from CUDA-graph replay",
          flush=True)
    print(f"[time] phases 1-10 in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
