"""Loop-closure parity of the port (``loopclosure/``, ``matching/bow.py``,
``solvers/pose_graph.py``) against the JAX package, on the JAX engine's
state at its first loop request on a closed 320x240 orbit.

Random streams are not reproducible across frameworks: verification gets
JAX's own Gumbel noise for the key the JAX function receives.

Tolerances: vocabulary words, word ids, matches, edge lists, streaks and
observation tables exact; idf and BoW rows 1e-6; BoW scores 1e-5; poses and
point positions 1e-4 (float32 solvers, another summation order);
Jacobians 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from boslam_tpu.loopclosure import detect as j_detect
from boslam_tpu.loopclosure import vocab as j_vocab
from boslam_tpu.matching import bow as j_bow
from boslam_tpu.mapping.map_state import MapState as JMapState
from boslam_tpu.solvers import pose_graph as j_pg
from boslam_tpu_torch import convert
from boslam_tpu_torch.io import synthetic
from boslam_tpu_torch.loopclosure import detect, vocab
from boslam_tpu_torch.matching import bow
from boslam_tpu_torch.solvers import pose_graph as pg

LOOP = dict(tp.SMALL, loop=dict(min_gap_kf=8, consistency=2, min_score_matches=25),
            tracker=dict(kf_min_interval=2, kf_tracked_ratio=0.75))
EXACT, SOFT, POSE = 1e-6, 1e-5, 1e-4


@pytest.fixture(scope="module")
def lc():
    """(cfg_j, cfg_t, JAX map, JAX loop state, key, requests) at the JAX
    engine's first flush with consistent loop candidates."""
    from boslam_tpu.slam import SlamSystem

    cfg_j, cfg_t = tp.configs(LOOP)
    traj = synthetic.orbit_trajectory(48, radius=0.8, yaw_amplitude=0.5, loop=True)
    frames = synthetic.render_sequence(cfg_t.camera, traj)
    seen = {}

    class Capture(SlamSystem):
        def _dispatch_verify(self, loop_requests):
            if loop_requests and not seen:
                seen.update(state=(tp.np_dict(self.map), tp.np_dict(self.loop)),
                            key=self.key,
                            reqs=[(k, c) for k, c, _ in loop_requests])

    slam = Capture(cfg_j)
    for f in frames:
        slam.feed(*f)
        if seen:
            break
    assert seen, "no loop request on the closed orbit"
    ms, ls = seen["state"]
    jmap = JMapState(**{k: jnp.asarray(v) for k, v in ms.items()})
    jloop = j_vocab.LoopState(**{k: jnp.asarray(v) for k, v in ls.items()})
    return cfg_j, cfg_t, jmap, jloop, seen["key"], seen["reqs"]


def _port(jmap, jloop=None):
    m = tp.port_state(jmap, convert.map_state_from_numpy)
    if jloop is None:
        return m
    return m, tp.port_state(jloop, convert.loop_state_from_numpy)


def test_train_vocab_matches_jax(lc):
    cfg_j, cfg_t, jmap, _, _, _ = lc
    ref = j_vocab.train_vocab(cfg_j, j_vocab.empty_loop_state(cfg_j), jmap)
    got = vocab.train_vocab(cfg_t, vocab.empty_loop_state(cfg_t, "cpu"), _port(jmap))
    assert bool(got.vocab_ready)
    np.testing.assert_array_equal(got.vocab.numpy().view(np.uint32), np.asarray(ref.vocab))
    np.testing.assert_allclose(got.idf.numpy(), np.asarray(ref.idf), atol=EXACT)
    np.testing.assert_allclose(got.kf_bow.numpy(), np.asarray(ref.kf_bow), atol=EXACT)


def test_compute_bow_and_word_ids_match_jax(lc):
    cfg_j, cfg_t, jmap, jloop, _, reqs = lc
    m, ls = _port(jmap, jloop)
    kf = reqs[0][0]
    ref = j_vocab.compute_bow(cfg_j, jloop._replace(kf_bow=jnp.zeros_like(jloop.kf_bow)),
                              jmap, jnp.asarray(kf, jnp.int32))
    got = vocab.compute_bow(cfg_t, ls._replace(kf_bow=torch.zeros_like(ls.kf_bow)),
                            m, torch.tensor(kf, dtype=torch.int32))
    np.testing.assert_allclose(got.kf_bow.numpy(), np.asarray(ref.kf_bow), atol=EXACT)
    w_ref = j_vocab.word_ids(jloop.vocab, jmap.kf_desc[kf], jmap.kf_kp_valid[kf])
    w = vocab.word_ids(ls.vocab, m.kf_desc[kf], m.kf_kp_valid[kf])
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))
    b_ref = j_vocab.bow_vector(cfg_j, jloop.vocab, jmap.kf_desc[kf], jmap.kf_kp_valid[kf])
    b = vocab.bow_vector(cfg_t, ls.vocab, m.kf_desc[kf], m.kf_kp_valid[kf])
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), atol=EXACT)


@pytest.mark.parametrize("angles", [False, True])
def test_search_by_bow_matches_jax(lc, angles):
    _, _, jmap, jloop, _, reqs = lc
    m, ls = _port(jmap, jloop)
    a, b_ = reqs[0]
    kw_j = dict(angle_a=jmap.kf_angle[a], angle_b=jmap.kf_angle[b_]) if angles else {}
    kw_t = dict(angle_a=m.kf_angle[a], angle_b=m.kf_angle[b_]) if angles else {}
    ref = j_bow.search_by_bow(jloop.vocab, jmap.kf_desc[a], jmap.kf_kp_valid[a],
                              jmap.kf_desc[b_], jmap.kf_kp_valid[b_], 100, **kw_j)
    got = bow.search_by_bow(ls.vocab, m.kf_desc[a], m.kf_kp_valid[a],
                            m.kf_desc[b_], m.kf_kp_valid[b_], 100, **kw_t)
    assert int(np.sum(ref[1])) > 10
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # A batch of B sides gives each what the unbatched call gives it.
    got2 = bow.search_by_bow(ls.vocab, m.kf_desc[a], m.kf_kp_valid[a],
                             m.kf_desc[[b_, a]], m.kf_kp_valid[[b_, a]], 100)
    ref0 = bow.search_by_bow(ls.vocab, m.kf_desc[a], m.kf_kp_valid[a],
                             m.kf_desc[b_], m.kf_kp_valid[b_], 100)
    for g, r in zip(got2, ref0):
        assert torch.equal(g[0], r)


def test_detect_loop_streaks_match_jax(lc):
    """detect_loop over the last keyframes in insertion order, each carrying
    the streak state the previous call left."""
    cfg_j, cfg_t, jmap, jloop, _, _ = lc
    m, ls = _port(jmap, jloop)
    seq = np.asarray(jmap.kf_seq)
    order = [int(k) for k in np.argsort(seq) if seq[k] >= 0 and jmap.kf_valid[k]][-6:]
    for kf in order:
        jloop, det_j = j_detect.detect_loop(cfg_j, jloop, jmap, jnp.asarray(kf, jnp.int32))
        ls, det = detect.detect_loop(cfg_t, ls, m, torch.tensor(kf, dtype=torch.int32))
        np.testing.assert_array_equal(ls.streak_kf.numpy(), np.asarray(jloop.streak_kf))
        np.testing.assert_array_equal(ls.streak_len.numpy(), np.asarray(jloop.streak_len))
        assert int(det.candidate) == int(det_j.candidate)
        assert bool(det.consistent) == bool(det_j.consistent)
        assert float(det.score) == pytest.approx(float(det_j.score), abs=SOFT)
    assert np.asarray(jloop.streak_len).max() >= 2


def _noise(key, n, cfg):
    return np.array(jax.random.gumbel(key, (cfg.tracker.ransac_iters, n)))


def _verify_close(got, ref):
    ok, pose, n_inl, idx, inl = got
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(n_inl.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(ref[4]))
    np.testing.assert_allclose(pose.numpy(), np.asarray(ref[1]), atol=POSE)


def test_verify_loop_with_injected_noise(lc):
    cfg_j, cfg_t, jmap, _, key, reqs = lc
    m = _port(jmap)
    kf, cand = reqs[0]
    ref = j_detect.verify_loop(cfg_j, jmap, jnp.asarray(kf, jnp.int32),
                               jnp.asarray(cand, jnp.int32), key)
    got = detect.verify_loop(cfg_t, m, torch.tensor(kf, dtype=torch.int32),
                             torch.tensor(cand, dtype=torch.int32),
                             torch.from_numpy(_noise(key, cfg_t.orb.n_features, cfg_t)))
    assert int(ref[2]) > 12
    _verify_close(got, ref)


def test_verify_loops_batch_with_injected_noise(lc):
    cfg_j, cfg_t, jmap, _, key, reqs = lc
    m = _port(jmap)
    pairs = (reqs + reqs)[:3]
    keys = jax.random.split(key, len(pairs))
    curs = np.array([p[0] for p in pairs], np.int32)
    cands = np.array([p[1] for p in pairs], np.int32)
    ref = j_detect.verify_loops_batch(cfg_j, jmap, jnp.asarray(curs), jnp.asarray(cands), keys)
    noise = np.stack([_noise(k, cfg_t.orb.n_features, cfg_t) for k in keys])
    got = detect.verify_loops_batch(cfg_t, m, torch.from_numpy(curs),
                                    torch.from_numpy(cands), torch.from_numpy(noise))
    _verify_close(got, ref)


def _with_loop_edge(jmap, reqs):
    """The map with a loop edge between the first request's keyframes."""
    kf, cand = reqs[0]
    t_rel = j_pg.se3.pose_compose(jmap.kf_pose[kf], j_pg.se3.pose_inv(jmap.kf_pose[cand]))
    t_rel = t_rel.at[4].add(0.03)  # a measured loop offset to correct
    return j_pg.add_loop_edge(jmap, jnp.asarray(kf, jnp.int32),
                              jnp.asarray(cand, jnp.int32), t_rel), t_rel


def test_build_essential_edges_matches_jax(lc):
    cfg_j, cfg_t, jmap, _, _, reqs = lc
    jm, _ = _with_loop_edge(jmap, reqs)
    ref = j_pg.build_essential_edges(cfg_j, jm)
    got = pg.build_essential_edges(cfg_t, _port(jm))
    for f in ("i", "j", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(ref.weight))
    np.testing.assert_allclose(got.t_meas.numpy(), np.asarray(ref.t_meas), atol=SOFT)
    assert int(np.sum(ref.valid)) > cfg_j.map.max_keyframes // 4


def test_edge_jacobians_match_jax():
    rng = np.random.default_rng(0)

    def poses(n):
        q = rng.normal(size=(n, 4)) + np.array([3.0, 0, 0, 0])
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        return np.concatenate([q, rng.normal(size=(n, 3))], 1).astype(np.float32)

    Ti, Tj = poses(16), poses(16)
    tm = np.asarray(j_pg.se3.pose_compose(jnp.asarray(Ti), j_pg.se3.pose_inv(jnp.asarray(Tj))))
    tm = np.concatenate([tm[:8], poses(8)])  # consistent and inconsistent edges

    def residual_at(xi_i, xi_j, a, b, m):
        return j_pg._edge_residual(m, j_pg.se3.retract(a, xi_i), j_pg.se3.retract(b, xi_j))

    z = jnp.zeros((16, 6))
    Ji_r, Jj_r = jax.vmap(jax.jacfwd(residual_at, argnums=(0, 1)))(
        z, z, jnp.asarray(Ti), jnp.asarray(Tj), jnp.asarray(tm))
    Ji, Jj = pg.edge_jacobians(torch.from_numpy(Ti), torch.from_numpy(Tj), torch.from_numpy(tm))
    np.testing.assert_allclose(Ji.numpy(), np.asarray(Ji_r), atol=POSE)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(Jj_r), atol=POSE)


def test_block_sum_matches_index_add():
    """The pose graph's block sums: index_add's sums over the chosen rows,
    absent keys zero, the same bits on a second call."""
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(0, 7, 40))
    vals = torch.from_numpy(rng.normal(size=(40, 6, 6)).astype(np.float32))
    sel = torch.arange(0, 40, 3)
    plan = pg._block_sum_plan(keys[sel], sel)
    got = pg._block_sum(vals, plan, 9)
    want = torch.zeros(9, 6, 6, dtype=torch.float64).index_add_(
        0, keys[sel], vals[sel].double())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(got, pg._block_sum(vals, plan, 9))
    empty = pg._block_sum_plan(keys[:0], sel[:0])
    assert torch.equal(pg._block_sum(vals, empty, 9), torch.zeros(9, 6, 6))


def test_optimize_pose_graph_matches_jax(lc):
    cfg_j, cfg_t, jmap, _, _, reqs = lc
    jm, t_rel = _with_loop_edge(jmap, reqs)
    kf, cand = reqs[0]
    init = jm.kf_pose.at[kf].set(j_pg.se3.pose_compose(t_rel, jm.kf_pose[cand]))
    fixed = jnp.zeros(init.shape[0], bool).at[0].set(True).at[cand].set(True)
    edges = j_pg.build_essential_edges(cfg_j, jm)
    ref = j_pg.optimize_pose_graph(cfg_j, init, jm.kf_valid, edges, fixed)
    m = _port(jm)
    got = pg.optimize_pose_graph(cfg_t, torch.from_numpy(np.array(init)), m.kf_valid,
                                 pg.build_essential_edges(cfg_t, m),
                                 torch.from_numpy(np.array(fixed)))
    assert float(np.abs(np.asarray(ref) - np.asarray(init)).max()) > 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=POSE)


def _verified(lc):
    cfg_j, cfg_t, jmap, _, key, reqs = lc
    kf, cand = reqs[0]
    ok, t_rel, _, midx, mok = j_detect.verify_loop(
        cfg_j, jmap, jnp.asarray(kf, jnp.int32), jnp.asarray(cand, jnp.int32), key)
    return kf, cand, t_rel, midx, mok


def test_fuse_loop_points_matches_jax(lc):
    cfg_j, cfg_t, jmap, _, _, _ = lc
    kf, cand, _, midx, mok = _verified(lc)
    assert int(np.sum(mok)) > 5
    ref = j_pg.fuse_loop_points(cfg_j, jmap, jnp.asarray(kf), jnp.asarray(cand), midx, mok)
    got = pg.fuse_loop_points(cfg_t, _port(jmap), torch.tensor(kf), torch.tensor(cand),
                              torch.from_numpy(np.array(midx)),
                              torch.from_numpy(np.array(mok)))
    for f in ("kf_obs_pt", "pt_valid", "covis"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    assert not np.array_equal(np.asarray(ref.kf_obs_pt), np.asarray(jmap.kf_obs_pt))


def test_close_loop_update_matches_jax(lc):
    cfg_j, cfg_t, jmap, _, _, _ = lc
    kf, cand, t_rel, midx, mok = _verified(lc)
    ref, pose_ref = j_pg.close_loop_update(cfg_j, jmap, jnp.asarray(kf, jnp.int32),
                                           jnp.asarray(cand, jnp.int32), t_rel, midx, mok)
    got, pose = pg.close_loop_update(
        cfg_t, _port(jmap), torch.tensor(kf, dtype=torch.int32),
        torch.tensor(cand, dtype=torch.int32), torch.from_numpy(np.array(t_rel)),
        torch.from_numpy(np.array(midx)), torch.from_numpy(np.array(mok)))
    tp.assert_state_close(ref, got, atol=POSE)
    np.testing.assert_allclose(pose.numpy(), np.asarray(pose_ref), atol=POSE)


def test_loop_state_round_trips_uint32_words(lc):
    _, _, _, jloop, _, _ = lc
    d = tp.np_dict(jloop)
    d["vocab"] = np.random.default_rng(0).integers(
        0, 2**32, d["vocab"].shape, dtype=np.uint64).astype(np.uint32)
    ls = convert.loop_state_from_numpy(d, "cpu")
    assert ls.vocab.dtype == torch.int32
    back = convert.loop_state_to_numpy(ls)
    for k, v in d.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
