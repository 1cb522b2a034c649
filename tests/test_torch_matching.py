"""Matching parity of the port: popcount / bit packing / Hamming matrices /
match_top2 / rotation consistency / search_by_projection against the JAX
package.  Everything here is integer or mask logic: indices, masks and
distances must agree exactly."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import _torch_parity as tp
from boslam_tpu.matching import hamming as j_ham
from boslam_tpu.matching import projection as j_proj
from boslam_tpu.matching.rotation import rotation_consistency as j_rot
from boslam_tpu_torch import convert
from boslam_tpu_torch.matching import hamming, projection
from boslam_tpu_torch.matching.rotation import rotation_consistency


def _eq(got, ref):
    got = got.numpy()
    ref = np.asarray(ref)
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, ref)


def test_bit_ops_match_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (96, 8), dtype=np.uint32)
    a[0] = 0xFFFFFFFF  # all sign bits set
    ta, tb = tp.t(a), tp.t(b)
    _eq(hamming.popcount_u32(ta), j_ham.popcount_u32(jnp.asarray(a)))
    _eq(hamming.unpack_bits(ta), j_ham.unpack_bits(jnp.asarray(a)))
    _eq(hamming.pack_bits(hamming.unpack_bits(ta)), a)
    _eq(hamming.hamming_matrix(ta, tb), j_ham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    _eq(hamming.hamming_matrix_mxu(ta, tb),
        j_ham.hamming_matrix_mxu(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("ratio,mutual", [(1.0, True), (0.9, True), (0.8, False)])
def test_match_top2_matches_jax(ratio, mutual):
    rng = np.random.default_rng(1)
    dist = rng.integers(0, 40, (80, 200)).astype(np.int32)  # many ties
    va = rng.random(80) < 0.9
    vb = rng.random(200) < 0.8
    mask = rng.random((80, 200)) < 0.3
    ref = j_ham.match_top2(jnp.asarray(dist), jnp.asarray(va), jnp.asarray(vb),
                           max_dist=20, ratio=ratio, mutual=mutual,
                           extra_mask=jnp.asarray(mask))
    got = hamming.match_top2(torch.from_numpy(dist), torch.from_numpy(va),
                             torch.from_numpy(vb), max_dist=20, ratio=ratio,
                             mutual=mutual, extra_mask=torch.from_numpy(mask))
    for g, r in zip(got, ref):
        _eq(g, r)


def test_rotation_consistency_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    b = (a - 0.3 + rng.normal(0, 0.05, 300)).astype(np.float32)
    b[:60] = rng.uniform(-np.pi, np.pi, 60)
    ok = rng.random(300) < 0.7
    for n in (300, 10):  # above and below min_matches
        _eq(rotation_consistency(torch.from_numpy(a[:n]), torch.from_numpy(b[:n]),
                                 torch.from_numpy(ok[:n])),
            j_rot(jnp.asarray(a[:n]), jnp.asarray(b[:n]), jnp.asarray(ok[:n])))


@pytest.fixture(scope="module")
def scene():
    return tp.scenario(tp.SMALL, 6)


@pytest.mark.parametrize("gated", [False, True])
def test_search_by_projection_matches_jax(scene, gated):
    cfg_j, cfg_t, slam, feats_j = scene
    ms = slam.map
    pose = np.array(slam.track.pose_cw)
    kw_j = dict(radius=15.0, max_dist=100, ratio=0.9)
    kw_t = dict(kw_j)
    if gated:
        kw_j.update(pt_angle=ms.pt_angle, pt_dir_sum=ms.pt_dir_sum,
                    pt_dmin=ms.pt_dmin, pt_dmax=ms.pt_dmax)
        kw_t.update(pt_angle=tp.t(ms.pt_angle), pt_dir_sum=tp.t(ms.pt_dir_sum),
                    pt_dmin=tp.t(ms.pt_dmin), pt_dmax=tp.t(ms.pt_dmax))
    ref = j_proj.search_by_projection(cfg_j, feats_j, jnp.asarray(pose), ms.pt_xyz,
                                      ms.pt_desc, ms.pt_valid, **kw_j)
    feats_t = tp.port_state(feats_j, convert.frame_features_from_numpy)
    got = projection.search_by_projection(
        cfg_t, feats_t, torch.from_numpy(pose), tp.t(ms.pt_xyz), tp.t(ms.pt_desc),
        tp.t(ms.pt_valid), **kw_t)
    assert int(np.sum(np.asarray(ref[1]))) > 20
    for g, r in zip(got, ref):
        _eq(g, r)
