"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a machine with PyTorch
alone; the tests' conftest imports JAX, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: ``fast_rank`` raw/rank at rtol 1e-5 / atol 1e-3 with identical
corner support, and bit-identical; ``extract_patches`` bit-exact;
``describe_patches`` under ``frontend_cuda.describe_report``'s contract (angle
within 1e-4, descriptors exact wherever the angle bin agrees, bins differing
only at a bin edge or at ill-conditioned moments: the moments' summation
order differs); ``fused_match_top2`` indices, masks and matched distances
exact; async mapping's CUDA-graph solve and its second-stream placement
bit-equal to the eager solve and to the same-stream run; inline engines
with local BA replayed from the process's CUDA graph bit-equal to one
solving eagerly; the multi-sequence
engine bit-equal to single engines on the card; one-rank distributed global
BA within tests/test_parallel.py's tolerances of the single-device solver;
``pose_gn`` against ``optimize_pose_plain`` on the same CUDA inputs at the
three callers' shapes, quaternion within 1e-5 and translation within 1e-4 m,
inlier masks equal but on edges within 1e-3 (relative) of their chi2 bound
(float32 with the sums over edges in another order; see the test)."""

import numpy as np
import pytest
import torch

import _match_cases
import _pose_cases
from boslam_tpu_torch.config import CameraConfig, SlamConfig
from boslam_tpu_torch.features import frontend
from boslam_tpu_torch.features.frontend import _BOOST_HI, _LEVEL_BORDER
from boslam_tpu_torch.io import synthetic
from boslam_tpu_torch.ops import frontend_cuda as fc
from boslam_tpu_torch.ops import hamming_cuda as hc
from boslam_tpu_torch.slam import to_gray_u8
from boslam_tpu_torch.solvers import pose_opt, robust

RTOL, ATOL = 1e-5, 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _gray(device):
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=160.0, cy=120.0)
    rgb, _ = synthetic.render_frame(cam, np.array([1.0, 0, 0, 0, 0.1, -0.1, 0.2]))
    return torch.from_numpy(to_gray_u8(rgb)).float().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [240, 230, 97])
def test_fast_rank_kernel_matches_plain(cuda_device, rows):
    lvl = _gray(cuda_device)[:rows].contiguous()
    rank, raw = fc.fast_rank(lvl, 20.0, 7.0, _BOOST_HI, _LEVEL_BORDER)
    rank_p, raw_p = fc.fast_rank_plain(lvl, 20.0, 7.0, _BOOST_HI, _LEVEL_BORDER)
    torch.cuda.synchronize()
    assert torch.equal(rank > 0, rank_p > 0)
    assert int((rank > 0).sum()) > 10
    torch.testing.assert_close(raw, raw_p, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(rank, rank_p, rtol=RTOL, atol=ATOL)


def _pyramid(device, ragged):
    """8 full-width levels (640x480 ... 179x134), or 3 with odd shapes."""
    if ragged:
        g = _gray(device)
        return [g[:233, :317].contiguous(), g[:97, :131].contiguous(),
                g[:64, :70].contiguous()]
    cfg = SlamConfig()
    rgb, _ = synthetic.render_frame(
        cfg.camera, np.array([1.0, 0, 0, 0, 0.1, -0.1, 0.2]))
    gray = torch.from_numpy(to_gray_u8(rgb)).float().to(device)
    return frontend.build_pyramid(gray, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True])
def test_fast_rank_levels_is_bit_equal_to_plain(cuda_device, ragged):
    levels = _pyramid(cuda_device, ragged)
    fc.reset_launches()
    maps = fc.fast_rank_levels(levels, 20.0, 7.0, _BOOST_HI, _LEVEL_BORDER)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["fast_rank"] == 1 and len(maps) == len(levels)
    for lvl, (rank, raw) in zip(levels, maps):
        rank_p, raw_p = fc.fast_rank_plain(lvl, 20.0, 7.0, _BOOST_HI,
                                           _LEVEL_BORDER)
        assert rank.shape == lvl.shape and rank.data_ptr() % 16 == 0
        assert torch.equal(rank, rank_p) and torch.equal(raw, raw_p)
    assert int((maps[0][0] > 0).sum()) > 10


def _keypoints(device, levels, k, seed=0):
    """Random keypoints per level, the four image corners among them."""
    rng = np.random.default_rng(seed)
    ys, xs = [], []
    for lvl in levels:
        h, w = lvl.shape
        y = np.concatenate([rng.integers(-5, h + 5, k), [0, 0, h - 1, h - 1]])
        x = np.concatenate([rng.integers(-5, w + 5, k), [0, w - 1, 0, w - 1]])
        ys.append(torch.from_numpy(y.astype(np.int32)).to(device))
        xs.append(torch.from_numpy(x.astype(np.int32)).to(device))
    return ys, xs


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True])
def test_describe_patches_meets_the_bin_contract(cuda_device, ragged):
    kern = frontend._frontend_constants(cuda_device)[0]
    blurred = [frontend._blur(l, kern) for l in _pyramid(cuda_device, ragged)]
    ys, xs = _keypoints(cuda_device, blurred, 60)
    fc.reset_launches()
    angle, desc = fc.describe_patches(blurred, ys, xs)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["extract_patches"] == 1
    assert angle.shape == (64 * len(blurred),) and desc.shape == (angle.shape[0], 8)
    report = fc.describe_report(blurred, ys, xs, angle, desc)
    assert not report["violations"], report
    # The same launch again gives the same bits: the sums have a fixed order.
    angle2, desc2 = fc.describe_patches(blurred, ys, xs)
    assert torch.equal(angle, angle2) and torch.equal(desc, desc2)


@pytest.mark.cuda
def test_describe_patches_on_a_constant_patch(cuda_device):
    """The kernel's moments of a constant patch are exactly 0: angle 0, bin
    0, and every comparison v < v false.  (The plain version's moments are
    rounding noise there, so only the kernel is asserted.)"""
    img = torch.full((64, 80), 37.25, device=cuda_device)
    idx = torch.full((3,), 30, dtype=torch.int32, device=cuda_device)
    angle, desc = fc.describe_patches([img], [idx], [idx])
    torch.cuda.synchronize()
    assert torch.equal(angle, torch.zeros_like(angle))
    assert torch.equal(desc, torch.zeros_like(desc))


@pytest.mark.cuda
def test_extract_patches_kernel_is_bit_exact(cuda_device):
    gray = _gray(cuda_device)
    rng = np.random.default_rng(0)
    # Keypoints anywhere, borders included: both sides clip the same way.
    ys = torch.from_numpy(rng.integers(-5, 250, 300).astype(np.int32)).to(cuda_device)
    xs = torch.from_numpy(rng.integers(-5, 330, 300).astype(np.int32)).to(cuda_device)
    out = fc.extract_patches(gray, ys, xs)
    torch.cuda.synchronize()
    assert torch.equal(out, fc.extract_patches_plain(gray, ys, xs))
    empty = fc.extract_patches(gray, ys[:0], xs[:0])
    assert empty.shape == (0, fc.PATCH, fc.PATCH)


@pytest.mark.cuda
def test_wrappers_count_launches_and_reject_mixed_devices(cuda_device):
    gray = _gray(cuda_device)
    fc.reset_launches()
    fc.fast_rank(gray, 20.0, 7.0, _BOOST_HI, _LEVEL_BORDER)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    fc.extract_patches(gray, idx, idx)
    assert fc.LAUNCHES == {"fast_rank": 1, "extract_patches": 1, "fused_match": 0,
                           "pose_gn": 0, "local_ba_graph": 0,
                           "local_ba_capture": 0}
    fc.fast_rank_plain(gray, 20.0, 7.0, _BOOST_HI, _LEVEL_BORDER)
    assert fc.LAUNCHES["fast_rank"] == 1
    fc.fast_rank_levels([gray, gray[:100].contiguous()], 20.0, 7.0, _BOOST_HI,
                        _LEVEL_BORDER)
    fc.describe_patches([gray, gray], [idx, idx], [idx, idx])
    assert fc.LAUNCHES == {"fast_rank": 2, "extract_patches": 2, "fused_match": 0,
                           "pose_gn": 0, "local_ba_graph": 0,
                           "local_ba_capture": 0}
    with pytest.raises(ValueError):
        fc.extract_patches(gray, idx.cpu(), idx.cpu())
    with pytest.raises(ValueError):
        fc.fast_rank_levels([gray, gray.cpu()], 20.0, 7.0, _BOOST_HI,
                            _LEVEL_BORDER)
    with pytest.raises(ValueError):
        fc.describe_patches([gray, gray.cpu()], [idx, idx], [idx, idx])


def _match_problem(device, n, m, seed=0, r_inf=False):
    """Map descriptors a quarter of which are frame descriptors with one bit
    flipped, placed 3 px from their keypoints."""
    rng = np.random.default_rng(seed)
    da = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    db = rng.integers(0, 2**32, size=(m, 8), dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, n, size=m // 4)
    db[: m // 4] = da[idx] ^ (np.uint32(1) << rng.integers(0, 32, (m // 4, 8)).astype(np.uint32))
    ua = rng.uniform(0, (640.0, 480.0), size=(n, 2)).astype(np.float32)
    ub = rng.uniform(0, (640.0, 480.0), size=(m, 2)).astype(np.float32)
    ub[: m // 4] = ua[idx] + 3.0
    r = np.full(n, np.inf, np.float32) if r_inf else \
        rng.uniform(8.0, 40.0, size=n).astype(np.float32)
    arrays = [da.view(np.int32), ua, r, rng.random(n) < 0.9, db.view(np.int32), ub,
              rng.random(m) < 0.8]
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("m,r_inf", [(4096, False), (4096 - 77, False), (4096, True),
                                     (100, False)])
@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("ratio", [1.0, 0.85])
def test_fused_match_kernel_matches_plain(cuda_device, m, r_inf, mutual, ratio):
    prob = _match_problem(cuda_device, 512, m, r_inf=r_inf)
    idx, ok, dist = hc.fused_match_top2(*prob, max_dist=64, ratio=ratio, mutual=mutual)
    idx_p, ok_p, dist_p = hc.fused_match_top2_plain(*prob, max_dist=64, ratio=ratio,
                                                   mutual=mutual)
    torch.cuda.synchronize()
    assert torch.equal(ok, ok_p) and torch.equal(idx, idx_p)
    assert torch.equal(dist[ok_p], dist_p[ok_p])
    if ratio == 1.0:
        assert int(ok_p.sum()) > min(20, m // 25)


@pytest.mark.cuda
def test_fused_match_at_relocalizations_size(cuda_device):
    """Relocalization's whole-map call at ORB-SLAM2's 1000 features against
    a 65,536-slot pool: no window, ``max_dist`` 50, ratio 0.85, mutual.
    1000 rows are 7 full 128-row chunks and a ragged one of 104."""
    n, m = 1000, 65536
    prob = _match_problem(cuda_device, n, m, seed=5, r_inf=True)
    # One copy of each frame row, 1-40 bits off, so that the ratio test
    # keeps most rows (the planted quarter holds ~16 copies of each).
    rng = np.random.default_rng(6)
    da = prob[0].cpu().numpy().view(np.uint32)
    db = rng.integers(0, 2**32, size=(m, 8), dtype=np.uint64).astype(np.uint32)
    cols = rng.permutation(m)[:n]
    flips = rng.random((n, 256)) < rng.uniform(0.004, 0.16, (n, 1))
    db[cols] = da ^ np.packbits(flips, axis=1, bitorder="little").view(np.uint32)
    prob[4] = torch.from_numpy(db.view(np.int32)).to(cuda_device)
    kw = dict(max_dist=50, ratio=0.85, mutual=True)
    idx, ok, dist = hc.fused_match_top2(*prob, **kw)
    idx_p, ok_p, dist_p = hc.fused_match_top2_plain(*prob, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ok, ok_p) and torch.equal(idx, idx_p)
    assert torch.equal(dist[ok_p], dist_p[ok_p])
    assert int(ok_p[896:].sum()) > 0  # matches in the ragged chunk too


@pytest.mark.cuda
@pytest.mark.parametrize("setting", _match_cases.SETTINGS,
                         ids=lambda s: f"mutual{int(s['mutual'])}-ratio{s['ratio']}")
@pytest.mark.parametrize("name", list(_match_cases.CASES))
def test_fused_match_kernel_matches_plain_on_edge_cases(cuda_device, name, setting):
    """tests/_match_cases.py: a sparse map, none visible, ties, edges."""
    arrays, max_dist = _match_cases.case(name)
    prob = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
            .to(cuda_device) for a in arrays]
    idx, ok, dist = hc.fused_match_top2(*prob, max_dist=max_dist, **setting)
    idx_p, ok_p, dist_p = hc.fused_match_top2_plain(*prob, max_dist=max_dist,
                                                   **setting)
    torch.cuda.synchronize()
    assert torch.equal(ok, ok_p) and torch.equal(idx, idx_p)
    assert torch.equal(dist[ok_p], dist_p[ok_p])
    _match_cases.expect(name, idx.cpu().numpy(), ok.cpu().numpy(),
                        dist.cpu().numpy(), **setting)


@pytest.mark.cuda
def test_fused_match_counts_launches_and_rejects_bad_inputs(cuda_device):
    prob = _match_problem(cuda_device, 64, 300)
    fc.reset_launches()
    out = hc.fused_match_top2(*prob, max_dist=64)
    plain = hc.fused_match_top2_plain(*prob, max_dist=64)
    assert fc.LAUNCHES["fused_match"] == 1
    for a, b in zip(out, plain):
        assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
    with pytest.raises(ValueError):
        hc.fused_match_top2(prob[0].long(), *prob[1:], max_dist=64)
    with pytest.raises(ValueError):
        hc.fused_match_top2(prob[0], *prob[1:4], prob[4].cpu(), *prob[5:], max_dist=64)


# pose_gn against optimize_pose_plain on the same CUDA inputs.  Both run in
# float32; the kernel sums over edges in another order, so the poses agree
# to rounding where the problem is well conditioned: the quaternion within
# 1e-5 and the translation within 1e-4 m (the plain version in float32
# against float64 differs there by < 4e-7 on these cases).  An edge whose
# chi2 lies within CHI2_EDGE_RTOL of its bound may fall on either side.
POSE_Q_ATOL, POSE_T_ATOL, CHI2_EDGE_RTOL = 1e-5, 1e-4, 1e-3
# ``few_edges``: two edges fix five of the pose's six degrees of freedom;
# along the sixth the damped step is rounding amplified by 1 / damping (the
# plain version in float32 against float64 differs by up to 1e-3 m there),
# so its poses are held by the residuals they give the observed edges,
# within FEW_EDGES_RES_ATOL (float32 against float64: up to 6.3e-4).
FEW_EDGES_RES_ATOL = 1e-2


def _edge_chi2(cfg, pose, args, kwargs):
    """Each edge's chi2 at ``pose`` and its bound, as optimize_pose gates."""
    _, pts, uv, depth, hd, _ = args
    r, _ = pose_opt.pose_residuals(cfg, pose, pts, uv, depth, hd)
    info = robust.octave_inv_sigma2(kwargs["octave"], cfg.orb.scale_factor)
    bound = torch.where(hd, cfg.tracker.chi2_3d, cfg.tracker.chi2_2d)
    return torch.sum(r * r, dim=-1) * info, bound, r


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_pose_cases.CASES))
def test_pose_gn_kernel_matches_plain(cuda_device, name):
    cfg, args, kwargs = _pose_cases.problem(name, seed=7, device=cuda_device)
    before = fc.LAUNCHES["pose_gn"]
    got = pose_opt.optimize_pose(cfg, *args, **kwargs)
    assert fc.LAUNCHES["pose_gn"] == before + 1
    ref = pose_opt.optimize_pose_plain(cfg, *args, **kwargs)
    torch.cuda.synchronize()
    for field in ref._fields:
        a, b = getattr(got, field), getattr(ref, field)
        assert a.shape == b.shape and a.dtype == b.dtype, field
    chi2, bound, _ = _edge_chi2(cfg, ref.pose, args, kwargs)
    near = (chi2 - bound).abs() <= CHI2_EDGE_RTOL * bound
    differ = got.inliers != ref.inliers
    assert not bool((differ & ~near).any())
    assert bool(((got.n_inliers - ref.n_inliers).abs()
                 <= (near & args[5]).sum(-1)).all())
    assert torch.equal(got.n_inliers, got.inliers.sum(-1).to(torch.int32))
    assert bool(torch.isfinite(got.pose).all())
    if name == "few_edges":
        obs = args[5]
        r_got = _edge_chi2(cfg, got.pose, args, kwargs)[2][obs]
        r_ref = _edge_chi2(cfg, ref.pose, args, kwargs)[2][obs]
        torch.testing.assert_close(r_got, r_ref, rtol=0, atol=FEW_EDGES_RES_ATOL)
        torch.testing.assert_close(got.pose[..., :4].norm(dim=-1),
                                   torch.ones(got.pose.shape[:-1], device=cuda_device))
    else:
        torch.testing.assert_close(got.pose[..., :4], ref.pose[..., :4],
                                   rtol=0, atol=POSE_Q_ATOL)
        torch.testing.assert_close(got.pose[..., 4:], ref.pose[..., 4:],
                                   rtol=0, atol=POSE_T_ATOL)
    if not bool(differ.any()):
        # The last robust cost: float32 sums of <= 1024 terms in another
        # order, at poses equal within the tolerances above.
        torch.testing.assert_close(got.chi2, ref.chi2, rtol=1e-4, atol=1e-3,
                                   equal_nan=True)
    if name == "no_mask":
        assert int(got.n_inliers) == 0 and float(got.chi2) == 0.0


@pytest.mark.cuda
def test_pose_gn_refuses_mixed_devices_and_wrong_dtypes(cuda_device):
    cfg, args, kwargs = _pose_cases.problem("reloc", seed=1, device=cuda_device)
    before = dict(fc.LAUNCHES)
    pose0, pts, uv, depth, hd, ok = args
    with pytest.raises(ValueError, match="is on"):
        pose_opt.optimize_pose(cfg, pose0, pts, uv.cpu(), depth, hd, ok, **kwargs)
    with pytest.raises(ValueError, match="float32"):
        pose_opt.optimize_pose(cfg, pose0, pts.double(), uv, depth, hd, ok,
                               **kwargs)
    with pytest.raises(ValueError, match="bool"):
        pose_opt.optimize_pose(cfg, pose0, pts, uv, depth, hd.float(), ok,
                               **kwargs)
    assert fc.LAUNCHES == before


def _async_run(cfg, frames, mapping_device):
    from boslam_tpu_torch.slam import SlamSystem

    slam = SlamSystem(cfg, chunk=8, async_mapping=True,
                      mapping_device=mapping_device)
    for f in frames:
        slam.feed(*f)
    return slam, slam.trajectory()[1]


@pytest.mark.cuda
def test_async_mapping_on_a_second_stream_matches_the_same_stream(cuda_device):
    """Async mapping at a small size: the deferred solves replayed from the
    CUDA graph on a second stream give the same-stream run's events and
    poses bit for bit, and the graph's replay equals the eager solve on one
    snapshot."""
    from boslam_tpu_torch.mapping.map_state import latest_kf_slot
    from boslam_tpu_torch.solvers.local_ba import deferred_local_ba

    cfg = SlamConfig.from_dict(dict(
        camera=dict(width=320, height=240, fx=130.0, fy=130.0, cx=160.0,
                    cy=120.0),
        orb=dict(n_features=256, n_levels=4),
        map=dict(max_keyframes=32, max_points=4096)))
    traj = synthetic.orbit_trajectory(24, radius=0.5, yaw_amplitude=0.2)
    frames = synthetic.render_sequence(cfg.camera, traj)
    same, est_same = _async_run(cfg, frames, None)
    side, est_side = _async_run(cfg, frames, 0)
    assert same._mapping_stream is None and side._mapping_stream is not None
    assert same._ba_graph is not None and side._ba_graph is not None
    events = [[(m.get("event"), m.get("ba_edges"), m.get("ba_cost1"))
               for m in s.metrics] for s in (same, side)]
    assert events[0] == events[1]
    assert sum(1 for e in events[0] if e[0] == "keyframe" and e[1]) >= 4
    np.testing.assert_array_equal(est_side, est_same)

    center = latest_kf_slot(same.map)
    eager = deferred_local_ba(cfg, same.map, center)
    replay = same._ba_graph(same.map, center)
    for a, b in zip(list(eager[:-1]) + list(eager.stats),
                    list(replay[:-1]) + list(replay.stats)):
        assert torch.equal(a, b)


def _inline_run(cfg, frames, rows):
    from boslam_tpu_torch import slam as slam_mod

    step = slam_mod.frame_step_core

    def recorded(*args):
        out = step(*args)
        rows.append(out[-1].clone())
        return out

    slam_mod.frame_step_core = recorded
    try:
        slam = slam_mod.SlamSystem(cfg, chunk=8)
        for f in frames:
            slam.feed(*f)
        slam.flush()
    finally:
        slam_mod.frame_step_core = step
    return slam, slam.trajectory()[1]


@pytest.mark.cuda
def test_inline_local_ba_graph_matches_the_eager_solve(cuda_device,
                                                       monkeypatch):
    """Inline engines at a small size with local BA replayed from the
    process's CUDA graph, against one with the solve enqueued eagerly: the
    packed rows, the trajectory and the map's poses and points bit-equal;
    one capture for two engines of one configuration and one more for
    another configuration, one replay per keyframe event; a map returned
    by one replay unchanged by the next."""
    import dataclasses

    from boslam_tpu_torch.mapping.map_state import latest_kf_slot
    from boslam_tpu_torch.solvers import local_ba

    cfg = SlamConfig.from_dict(dict(
        camera=dict(width=320, height=240, fx=130.0, fy=130.0, cx=160.0,
                    cy=120.0),
        orb=dict(n_features=256, n_levels=4),
        map=dict(max_keyframes=32, max_points=4096)))
    traj = synthetic.orbit_trajectory(24, radius=0.5, yaw_amplitude=0.2)
    frames = synthetic.render_sequence(cfg.camera, traj)
    monkeypatch.setattr(local_ba, "_INLINE_GRAPHS", {})
    before = dict(fc.LAUNCHES)
    rows = {"graph": [], "graph2": [], "eager": []}
    a, est_a = _inline_run(cfg, frames, rows["graph"])
    b, est_b = _inline_run(cfg, frames, rows["graph2"])
    solves = sum(1 for m in a.metrics if m.get("event") == "keyframe")
    assert solves >= 4
    assert fc.LAUNCHES["local_ba_capture"] - before["local_ba_capture"] == 1
    assert fc.LAUNCHES["local_ba_graph"] - before["local_ba_graph"] == \
        2 * solves
    with monkeypatch.context() as m:
        m.setattr(local_ba, "inline_graph", lambda cfg, state: None)
        eager, est_e = _inline_run(cfg, frames, rows["eager"])
    assert fc.LAUNCHES["local_ba_graph"] - before["local_ba_graph"] == \
        2 * solves
    for run, est, slam in (("graph", est_a, a), ("graph2", est_b, b)):
        assert torch.equal(torch.stack(rows[run]), torch.stack(rows["eager"]))
        np.testing.assert_array_equal(est, est_e)
        assert torch.equal(slam.map.kf_pose, eager.map.kf_pose)
        assert torch.equal(slam.map.pt_xyz, eager.map.pt_xyz)

    center = latest_kf_slot(a.map)
    st1, stats1 = local_ba.local_bundle_adjustment(cfg, a.map, center)
    kept = [t.clone() for t in (st1.kf_pose, st1.pt_xyz, *stats1)]
    st2, _ = local_ba.local_bundle_adjustment(
        cfg, a.map._replace(pt_xyz=a.map.pt_xyz + 0.01), center)
    assert not torch.equal(st2.pt_xyz, st1.pt_xyz)
    for k, t in zip(kept, (st1.kf_pose, st1.pt_xyz, *stats1)):
        assert torch.equal(k, t)

    other = cfg.replace(local_ba=dataclasses.replace(cfg.local_ba,
                                                     lm_lambda0=2e-4))
    local_ba.local_bundle_adjustment(other, a.map, center)
    assert fc.LAUNCHES["local_ba_capture"] - before["local_ba_capture"] == 2
    assert len(local_ba._INLINE_GRAPHS) == 2


@pytest.mark.cuda
def test_run_sequences_on_the_card_matches_single_engines(cuda_device):
    """Two sequences of unequal length on the one card: each equals its
    single engine's run on the card bit for bit, the finished sequence
    leaves no record, and each frontend kernel runs once per active
    sequence-frame."""
    from boslam_tpu_torch.parallel.multi import run_sequences
    from boslam_tpu_torch.slam import run_sequence

    cfg = SlamConfig.from_dict(dict(
        camera=dict(width=320, height=240, fx=130.0, fy=130.0, cx=160.0,
                    cy=120.0),
        orb=dict(n_features=256, n_levels=4),
        map=dict(max_keyframes=32, max_points=4096)))
    lengths = [16, 9]
    frame_lists = [synthetic.render_sequence(cfg.camera,
                                             synthetic.orbit_trajectory(
                                                 n, radius=0.4 + 0.1 * s))
                   for s, n in enumerate(lengths)]
    fc.reset_launches()
    eng = run_sequences(cfg, frame_lists)
    assert all(m.kf_pose.is_cuda for m in eng.map)
    for k in fc.FRONTEND_KERNELS:
        assert fc.LAUNCHES[k] == sum(lengths)
    for s, n in enumerate(lengths):
        single = run_sequence(cfg, frame_lists[s], seed=s, chunk=8)
        _, est = eng.trajectory(s)
        _, est_one = single.trajectory()
        assert len(eng.metrics[s]) == n
        np.testing.assert_array_equal(est, est_one)
        assert eng.n_keyframes(s) == single.n_keyframes


@pytest.mark.cuda
def test_one_rank_distributed_global_ba_on_the_card(cuda_device):
    """``distributed_global_ba`` on a one-rank mesh on the card against the
    single-device solver on a tracked map: the edge count exact, cost0
    within 1e-2, cost1 < cost0, poses within 2 mm, points within 5 mm."""
    from boslam_tpu_torch.geometry import se3
    from boslam_tpu_torch.parallel.mesh import make_mesh
    from boslam_tpu_torch.parallel.sharded_global_ba import (
        distributed_global_ba,
    )
    from boslam_tpu_torch.slam import run_sequence
    from boslam_tpu_torch.solvers.global_ba import global_bundle_adjustment

    cfg = SlamConfig.from_dict(dict(
        camera=dict(width=160, height=120, fx=70.0, fy=70.0, cx=80.0,
                    cy=60.0),
        orb=dict(n_features=128, n_levels=3),
        map=dict(max_keyframes=16, max_points=2048)))
    traj = synthetic.orbit_trajectory(15, radius=0.3, yaw_amplitude=0.15)
    slam = run_sequence(cfg, synthetic.render_sequence(cfg.camera, traj))
    st_a, stats = global_bundle_adjustment(cfg, slam.map, lm_iters=5,
                                           cg_iters=30)
    st_b, (c0, c1, n_edges) = distributed_global_ba(
        cfg, make_mesh(1), slam.map, lm_iters=5, cg_iters=30)
    assert st_b.kf_pose.is_cuda
    assert n_edges == int(stats.n_edges) > 100
    assert abs(c0 - float(stats.cost0)) < 1e-2 * max(float(stats.cost0), 1.0)
    assert c1 < c0
    _, dt = se3.pose_distance(st_a.kf_pose, st_b.kf_pose)
    assert float(dt[slam.map.kf_valid].max()) < 2e-3
    perr = (st_a.pt_xyz - st_b.pt_xyz).norm(dim=-1)[slam.map.pt_valid]
    assert float(perr.max()) < 5e-3


@pytest.mark.cuda
def test_spans_attribute_the_card_work(cuda_device):
    """The engine's spans over the device trace on the card.  ``hall``'s
    configuration (``bench._tracking_cfg``) on the bench's clover, 8 frames
    traced after 24: every launch of the two frontend kernels goes to
    ``frame.frontend``, at least 95 % of the device operations to some span,
    and the clock's mapping keeps the runtime calls of every host read
    inside its ``sync.read`` span.  One traced global-BA solve at a small
    size (16 keyframes, 2,000 points, 128 observations each): every CG
    application launches the same number of device operations."""
    import bisect

    from boslam_tpu_torch import bench
    from boslam_tpu_torch.slam import SlamSystem
    from boslam_tpu_torch.solvers.global_ba import global_bundle_adjustment
    from boslam_tpu_torch.tracking.tracker import HostSync
    from boslam_tpu_torch.utils import timing

    cfg = bench._tracking_cfg(2)
    traj = synthetic.clover_trajectory(450, n_petals=3, radius=2.5,
                                       yaw_amplitude=0.4)
    frames = list(bench._render(cfg.camera, type(traj)(
        traj.poses_twc[:32], traj.timestamps[:32]), 0.025, 3, 2.5))
    slam = SlamSystem(cfg, chunk=1, trace=True)
    for f in frames[:24]:
        slam.feed(*f)
    slam.sync.drain()

    def run():
        for f in frames[24:]:
            slam.feed(*f)

    got = timing.profile_spans(run, slam.sync)
    to_clock, launched = got["to_clock"], timing.launch_times(got["calls"])
    front = [(to_clock(s.t0), to_clock(s.t1)) for s in got["spans"]
             if s.name == "frame.frontend"]
    kernels = [op for op in got["device_ops"] if "fast_rank_kernel" in op[2]
               or "describe_patches_kernel" in op[2]]
    assert len(front) == 8 and len(kernels) == 16
    for op in kernels:
        assert any(a <= launched[op[3]] <= b for a, b in front), op[2]
    ops = got["ops_by_span"]
    outside = sum(ops.get(k, [0])[0] for k in (timing.NO_SPAN,
                                               timing.NO_LAUNCH))
    assert outside <= 0.05 * sum(v[0] for v in ops.values())
    slack = got["slack"]
    assert slack["reads"] >= 8 and slack["empty"] == 0
    assert slack["before_ns"] >= 0 and slack["after_ns"] >= 0

    gcfg = SlamConfig.from_dict(dict(map=dict(max_keyframes=16,
                                              max_points=4096),
                                     orb=dict(n_features=128)))
    st, _, _ = synthetic.synthetic_ba_problem(
        gcfg, np.random.default_rng(0), n_kf=16, n_pts=2000, obs_per_kf=128)
    st = type(st)(*(t.to(cuda_device) for t in st))
    global_bundle_adjustment(gcfg, st, lm_iters=2, cg_iters=10)
    sync = HostSync(trace=True)
    got = timing.profile_spans(
        lambda: global_bundle_adjustment(gcfg, st, lm_iters=6, cg_iters=40,
                                         sync=sync), sync)
    to_clock, launched = got["to_clock"], timing.launch_times(got["calls"])
    starts = sorted(launched[op[3]] for op in got["device_ops"])
    per_apply = [bisect.bisect_right(starts, to_clock(s.t1))
                 - bisect.bisect_left(starts, to_clock(s.t0))
                 for s in got["spans"] if s.name == "gba.cg_apply"]
    assert len(per_apply) > 6 and len(set(per_apply)) == 1 and per_apply[0]
