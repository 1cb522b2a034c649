"""The kidnap cell's pieces on the CPU: the whole-map match against the
reference, the pass the mix describes, a rehearsal of ``kidnap.reloc``
that reaches both covers, and the faults its check has to catch.

The rehearsal runs the mix's ``rehearsal`` pass (81 positions of the
path with both covers) on the plain path; each fault runs the part of a
pass it needs.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import core
import kidnap
from reference import relocalization as ref_reloc

CPU = torch.device("cpu")
SEED = 2**31 + 33


def _random_map(seed, n=128, slots=4096, live=3000):
    """Frame rows and a map whose first live slots hold copies of frame
    rows, 0-60 bits off, at one relative rotation (the rest scattered),
    and random descriptors elsewhere; ``pt_xyz[:, 0]`` is the slot."""
    rng = np.random.default_rng(seed)
    da = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    db = rng.integers(0, 2**32, (slots, 8), dtype=np.uint64).astype(np.uint32)
    copies = rng.choice(live, n, replace=False)
    src = rng.permutation(n)
    flips = rng.random((n, 256)) < rng.uniform(0.0, 0.24, (n, 1))
    db[copies] = da[src] ^ np.packbits(flips, 1, bitorder="little").view(
        np.uint32)
    db[copies[: n // 8]] = db[copies[n // 8: n // 4]]  # ties between slots
    ang_a = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    ang_b = rng.uniform(0, 2 * np.pi, slots).astype(np.float32)
    turn = rng.random(n) < 0.8
    ang_b[copies[turn]] = (ang_a[src[turn]] - 0.7) % (2 * np.pi)
    pt_valid = np.zeros(slots, bool)
    pt_valid[:live] = rng.random(live) < 0.95
    xyz = np.zeros((slots, 3), np.float32)
    xyz[:, 0] = np.arange(slots)
    t = torch.from_numpy
    feats = SimpleNamespace(
        desc=t(da.view(np.int32)), valid=t(rng.random(n) < 0.9),
        has_depth=t(rng.random(n) < 0.9), angle=t(ang_a),
        uv=t(rng.uniform(0, 640, (n, 2)).astype(np.float32)))
    pts = SimpleNamespace(pt_desc=t(db.view(np.int32)), pt_valid=t(pt_valid),
                          pt_angle=t(ang_b), pt_xyz=t(xyz))
    return feats, pts


@pytest.mark.parametrize("route", ["matrix", "fused"])
@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_whole_map_match_is_the_references(monkeypatch, route, seed):
    """``_global_candidates`` (the matrix route below the fused size, the
    fused route's CPU twin above it) and the reference: equal indices and
    masks, after rotation consistency."""
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.tracking import tracker

    if route == "fused":
        monkeypatch.setattr(tracker, "FUSED_MATCH_MIN_POINTS", 1024)
    slam_cfg = core.load_json("configs", "tum_kidnap1000")["slam"]
    cfg = SlamConfig.from_dict(slam_cfg)
    feats, m = _random_map(seed)
    pts, ok_r = tracker._global_candidates(cfg, m, feats)
    ok = ok_r[0]
    idx = torch.where(ok, pts[0, :, 0].round().to(torch.int32), -1)
    ref_idx, ref_ok = ref_reloc.whole_map(
        feats.desc, feats.valid, feats.has_depth, feats.angle, m.pt_desc,
        m.pt_valid, m.pt_angle, slam_cfg["matcher"]["hamming_low"])
    assert torch.equal(ok, ref_ok) and torch.equal(idx, ref_idx)
    assert 20 < int(ok.sum()) < int((feats.valid & feats.has_depth).sum())
    # Rotation consistency dropped matches that the Hamming test kept.
    inf = torch.full((128,), float("inf"))
    _, pre = ref_reloc.match(feats.desc, feats.uv, inf,
                             feats.valid & feats.has_depth, m.pt_desc,
                             torch.zeros((4096, 2)), m.pt_valid, 50, 0.85,
                             True)
    assert int(pre.sum()) > int(ok.sum())


def test_reference_match_follows_the_programs_ties_window_and_ratio():
    from boslam_tpu_torch.ops.hamming_cuda import fused_match_top2

    feats, m = _random_map(5, n=64, slots=512, live=512)
    r = torch.rand(64, generator=torch.Generator().manual_seed(1)) * 300
    uv_b = torch.rand(512, 2, generator=torch.Generator().manual_seed(2)) * 640
    for kw in (dict(max_dist=50, ratio=0.85, mutual=True),
               dict(max_dist=90, ratio=1.0, mutual=False)):
        args = (feats.desc, feats.uv, r, feats.valid, m.pt_desc, uv_b,
                m.pt_valid)
        idx, ok, _ = fused_match_top2(*args, **kw)
        ref_idx, ref_ok = ref_reloc.match(*args, **kw)
        assert ref_reloc.row_mismatch(idx, ok, ref_idx, ref_ok) == 0.0
        assert int(ok.sum()) > 5


def _frames(n, shape=(6, 8)):
    return [(i / 30.0, np.full(shape, i % 250 + 1, np.uint8),
             np.full(shape, i + 1, np.uint16)) for i in range(n)]


@pytest.mark.parametrize("which", ["timed", "rehearsal"])
def test_the_pass_positions_blanks_and_truth(which):
    tr = core.load_json("traffic", "kidnap_replay_chunk1")
    plan = tr if which == "timed" else tr["rehearsal"]
    n_path = 400
    poses = np.arange(n_path * 7, dtype=np.float64).reshape(n_path, 7)
    ps = kidnap.build_pass(_frames(n_path), poses, plan["pass"], tr["fps"])
    if which == "rehearsal":
        assert len(ps.frames) == 36 + 5 + 32 + 8
        assert ps.covers == [(8, 10), (36, 41)]
        return
    assert len(ps.frames) == 355
    assert ps.covers == [(8, 10), (120, 135)]
    assert kidnap.stretches(ps) == [(10, 120), (135, 355)]
    assert np.array_equal(np.flatnonzero(ps.blank),
                          [8, 9] + list(range(120, 135)))
    for p, path in ((0, 0), (8, 8), (119, 119), (135, 210), (324, 399),
                    (325, 0), (354, 29)):
        assert np.array_equal(ps.truth[p], poses[path]), p
        assert ps.frames[p][0] == p / 30.0
        if not ps.blank[p]:
            assert ps.frames[p][1][0, 0] == path % 250 + 1
    assert np.isnan(ps.truth[120:135]).all()
    for p in (8, 9, 120, 134):
        assert not ps.frames[p][1].any() and not ps.frames[p][2].any()


def _run(spec, seed=SEED):
    res = kidnap.run(spec, seed=seed, seconds=0, trace=False, device=CPU,
                     rehearsal=True, control=None, t_start=time.perf_counter())
    ok, checks = core.judge(res["values"], spec["limits"])
    return ok, checks, res


def _cut(segments, frames):
    """The cell with its rehearsal pass replaced, on the path's first
    ``frames`` frames."""
    spec = core.cell("kidnap.reloc")
    tr = spec["traffic_spec"]
    spec["traffic_spec"] = dict(tr, rehearsal=dict(
        tr["rehearsal"], frames=frames, **{"pass": segments}))
    return spec


def test_rehearsal_reaches_both_covers_and_is_correct():
    ok, checks, res = _run(core.cell("kidnap.reloc"))
    assert ok, checks
    rc = res["run"]["reloc_counts"]
    assert rc["covers"] == 2 and rc["ok"] >= 2 and rc["whole_map"] >= 1
    assert rc["ok"] - rc["whole_map"] >= 1 or rc["tries"] > rc["whole_map"]
    assert res["failed"] == 0 and res["attempted"] == 81
    assert res["run"]["reloc_frame_s"]
    assert res["run"]["match_call"]["n"] == 1000
    assert res["run"]["match_call"]["m"] == 65536
    assert core.metric_module("reloc_tries_per_kidnap").read(res["run"]) \
        == rc["tries"] / 2


def _reloc_fails(monkeypatch):
    """Relocalization always failing: the track stays lost."""
    import boslam_tpu_torch.slam as slam

    orig = slam.relocalize

    def broken(cfg, map_state, loop_state, track, *args, **kw):
        new, good, n_inl = orig(cfg, map_state, loop_state, track, *args, **kw)
        return (track._replace(frame_idx=new.frame_idx),
                torch.zeros_like(good), n_inl)

    monkeypatch.setattr(slam, "relocalize", broken)


def _no_ratio(monkeypatch):
    """The whole-map matcher with its ratio test dropped."""
    from boslam_tpu_torch.tracking import tracker

    orig = tracker.fused_match_top2

    def broken(*args, **kw):
        return orig(*args, **dict(kw, ratio=1.0))

    monkeypatch.setattr(tracker, "fused_match_top2", broken)


def _no_refine(monkeypatch):
    """Relocalization keeping RANSAC's pose without the refine."""
    from boslam_tpu_torch.tracking import tracker

    def broken(cfg, pts_w, feats, ok, key):
        res = tracker.ransac_pnp(
            cfg, pts_w, feats.uv, feats.xyz, feats.has_depth, ok, key,
            n_hypotheses=cfg.tracker.ransac_iters,
            min_inliers=cfg.tracker.min_inliers)
        need = max(cfg.tracker.min_inliers, cfg.tracker.reloc_min_inliers)
        return res.ok & (res.n_inliers >= need), res.pose, res.n_inliers

    monkeypatch.setattr(tracker, "_reloc_solve", broken)


def _reloc_kf_pose(monkeypatch):
    """Relocalization recovering its reference keyframe's pose in place of
    the solved one."""
    import boslam_tpu_torch.slam as slam

    orig = slam.relocalize

    def broken(cfg, map_state, loop_state, track, *args, **kw):
        new, good, n_inl = orig(cfg, map_state, loop_state, track, *args, **kw)
        pose = torch.where(good, map_state.kf_pose[new.last_kf.long()],
                           new.pose_cw)
        return new._replace(pose_cw=pose), good, n_inl

    monkeypatch.setattr(slam, "relocalize", broken)


# The cold start's cover and the whole-map relocalization after it.
COLD = ([{"path": [0, 14], "covered": [8, 9]}], 14)
# fault -> (plant, the number it has to fail, the rehearsal pass it needs)
KIDNAP_FAULTS = {
    "reloc_fails": (_reloc_fails, "kidnaps_unrecovered", COLD),
    "no_ratio": (_no_ratio, "reloc_match_mismatch", COLD),
    "no_refine": (_no_refine, "reloc_refine_gap", None),
    "reloc_kf_pose": (_reloc_kf_pose, "reloc_pose_err_m", COLD),
}


@pytest.mark.parametrize("fault", sorted(KIDNAP_FAULTS))
def test_planted_faults_fail_their_number(monkeypatch, fault):
    plant, number, cut = KIDNAP_FAULTS[fault]
    plant(monkeypatch)
    ok, checks, _ = _run(_cut(*cut) if cut else core.cell("kidnap.reloc"))
    assert not ok
    assert checks[number]["value"] > checks[number]["limit"], checks


def test_fused_match_roofline_reads_both_launches_of_a_call():
    import kernels_match

    card = "NVIDIA H100 80GB HBM3"
    run = {"card": card, "match_call": {"n": 1000, "m": 65536, "v": 1340},
           "profile_cold": {"by_name": {
               "(anonymous namespace)::match_kernel(unsigned int const*, "
               "float2 const*)": [3, 30e-6],
               "(anonymous namespace)::merge_kernel(int const*, uint2 const*)":
                   [3, 15e-6],
               "void at::native::reduce_kernel<512, 1>(float)": [40, 1e-3]}}}
    least = kernels_match.least_time_s(1000, 65536, 1340, card)
    ops, nbytes = kernels_match.counts(1000, 65536, 1340)
    assert least == max(ops / 1979e12, nbytes / 3.35e12)
    pct = core.metric_module("roofline.fused_match").read(run)
    assert pct == pytest.approx(100 * least / 15e-6)
    for gone in ("card", "match_call", "profile_cold"):
        assert core.metric_module("roofline.fused_match").read(
            {k: v for k, v in run.items() if k != gone}) is None


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_refine_gap_is_zero_at_the_programs_refine_only(seed):
    """Motion-only BA (the plain version) from a pose 5 cm and ~1 degree
    off: the reference's float64 cost cannot improve on its output, and
    improves on the starting pose by far more than the limit."""
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.solvers.pose_opt import optimize_pose_plain
    from reference.geometry import exp, pose_compose, pose_inv, rotate, quat_to_mat

    slam_cfg = core.load_json("configs", "tum_kidnap1000")["slam"]
    cfg = SlamConfig.from_dict(slam_cfg)
    c = slam_cfg["camera"]
    g = torch.Generator().manual_seed(seed)
    n = 400
    xc = torch.stack([torch.rand(n, generator=g) * 8 - 4,
                      torch.rand(n, generator=g) * 6 - 3,
                      torch.rand(n, generator=g) * 9 + 1], -1).double()
    true = exp(torch.randn(6, generator=g, dtype=torch.float64) * 0.3)
    inv = pose_inv(true)
    pts_w = rotate(quat_to_mat(inv[:4]), xc) + inv[4:]
    uv = torch.stack([c["fx"] * xc[:, 0] / xc[:, 2] + c["cx"],
                      c["fy"] * xc[:, 1] / xc[:, 2] + c["cy"]], -1)
    uv = uv + torch.randn(n, 2, generator=g, dtype=torch.float64) * 0.7
    depth = xc[:, 2] * (1 + 0.01 * torch.randn(n, generator=g, dtype=torch.float64))
    uv[:20] += 40.0  # outliers
    hd = torch.rand(n, generator=g) < 0.8
    ok = torch.rand(n, generator=g) < 0.9
    octave = torch.randint(0, 8, (n,), generator=g, dtype=torch.int32)
    start = pose_compose(exp(torch.tensor([0.01, -0.015, 0.01, 0.05, -0.03, 0.02],
                                          dtype=torch.float64)), true)
    f32 = [t.float() for t in (start, pts_w, uv, depth)]
    out = optimize_pose_plain(cfg, f32[0], f32[1], f32[2], f32[3], hd & ok, ok,
                              octave)
    args = (pts_w.float(), uv.float(), depth.float(), hd, ok, octave)
    refined, _ = ref_reloc.refine_gap(slam_cfg, out.pose, *args)
    unrefined, edges = ref_reloc.refine_gap(slam_cfg, start.float(), *args)
    limit = core.cell("kidnap.reloc")["limits"]["reloc_refine_gap"]
    assert refined < limit / 10, refined
    assert unrefined > limit * 10 and edges > 50, unrefined
