"""The port's kernels: their plain PyTorch twins against the JAX package's
golden twins and Pallas kernels (interpret mode), and the CPU dispatch of
the wrappers.  Each kernel against its twin on a CUDA card is in
tests/test_torch_cuda.py.

Tolerances: ``fast_rank`` raw/rank at rtol 1e-5 / atol 1e-3 with identical
corner support (the bar of tests/test_ops_pallas.py); ``extract_patches``
bit-exact; ``fused_match_top2`` indices and masks exact, matched distances
exact."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import _torch_parity  # noqa: F401  (thread cap, TF32 off)
from boslam_tpu.config import CameraConfig
from boslam_tpu.features.frontend import (
    _BOOST_HI, _extract_patches_jnp, _fast_rank_maps, rgb_to_gray,
)
from boslam_tpu.io import synthetic
from boslam_tpu.ops.frontend_pallas import extract_patches_pallas, fast_rank_pallas
from boslam_tpu.ops.hamming_pallas import fused_match_top2 as j_fused_match
from boslam_tpu_torch.ops import frontend_cuda as fc
from boslam_tpu_torch.ops import hamming_cuda as hc

RTOL, ATOL = 1e-5, 1e-3


def _frame():
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=160.0, cy=120.0)
    rgb, _ = synthetic.render_frame(cam, np.array([1.0, 0, 0, 0, 0.1, -0.1, 0.2]))
    return rgb_to_gray(rgb).astype(np.float32)


@pytest.mark.parametrize("rows", [240, 230])
def test_fast_rank_plain_matches_jax(rows):
    gray = _frame()[:rows]
    rank_j, raw_j = _fast_rank_maps(jnp.asarray(gray), 20.0, 7.0, 17)
    rank_p, raw_p = fast_rank_pallas(jnp.asarray(gray), 20.0, 7.0, _BOOST_HI, 17,
                                     interpret=True)
    rank, raw = fc.fast_rank(torch.from_numpy(gray), 20.0, 7.0, _BOOST_HI, 17)
    assert rank.shape == (rows, 320)
    for ref_rank, ref_raw in ((rank_j, raw_j), (rank_p, raw_p)):
        ref_rank, ref_raw = np.asarray(ref_rank), np.asarray(ref_raw)
        np.testing.assert_array_equal(rank.numpy() > 0, ref_rank > 0)
        np.testing.assert_allclose(raw.numpy(), ref_raw, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(rank.numpy(), ref_rank, rtol=RTOL, atol=ATOL)


def test_fast_rank_plain_on_random_levels():
    """Integer-valued and fractional levels (the pyramid's), odd shapes."""
    rng = np.random.default_rng(3)
    for shape, frac in (((97, 131), False), ((64, 70), True)):
        lvl = rng.integers(0, 256, shape).astype(np.float32)
        if frac:
            lvl = lvl + rng.random(shape, dtype=np.float32)
        rank_j, raw_j = _fast_rank_maps(jnp.asarray(lvl), 20.0, 7.0, 17)
        rank, raw = fc.fast_rank_plain(torch.from_numpy(lvl), 20.0, 7.0,
                                       _BOOST_HI, 17)
        np.testing.assert_array_equal(raw.numpy(), np.asarray(raw_j))
        np.testing.assert_array_equal(rank.numpy(), np.asarray(rank_j))


def test_extract_patches_plain_matches_jax():
    gray = _frame()
    rng = np.random.default_rng(0)
    # Include coordinates the clip moves: the border and beyond.
    ys = np.concatenate([rng.integers(17, 240 - 17, size=60), [0, 5, 239, 230]])
    xs = np.concatenate([rng.integers(17, 320 - 17, size=60), [319, 2, 0, 310]])
    ys, xs = ys.astype(np.int32), xs.astype(np.int32)
    ref = np.asarray(_extract_patches_jnp(jnp.asarray(gray), jnp.asarray(ys),
                                          jnp.asarray(xs)))
    pal = np.asarray(extract_patches_pallas(jnp.asarray(gray), jnp.asarray(ys),
                                            jnp.asarray(xs), interpret=True))
    out = fc.extract_patches(torch.from_numpy(gray), torch.from_numpy(ys),
                             torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, pal)


def test_cpu_tensors_take_the_plain_path():
    """A CPU tensor never reaches a kernel: the launch counters stay put."""
    before = dict(fc.LAUNCHES)
    gray = torch.from_numpy(_frame())
    fc.fast_rank(gray, 20.0, 7.0, _BOOST_HI, 17)
    idx = torch.full((4,), 40, dtype=torch.int32)
    fc.extract_patches(gray, idx, idx)
    assert fc.LAUNCHES == before


def test_wrappers_reject_bad_inputs():
    gray = torch.from_numpy(_frame())
    with pytest.raises(ValueError):
        fc.fast_rank(gray.double(), 20.0, 7.0, _BOOST_HI, 17)
    with pytest.raises(ValueError):
        fc.fast_rank(gray.t(), 20.0, 7.0, _BOOST_HI, 17)  # not contiguous
    idx = torch.full((4,), 40, dtype=torch.int64)
    with pytest.raises(ValueError):
        fc.extract_patches(gray, idx, idx)
    small = torch.zeros((16, 16))
    idx32 = idx.to(torch.int32)
    with pytest.raises(ValueError):
        fc.extract_patches(small, idx32, idx32)


def _match_problem(rng, n=128, m=512, img=(640.0, 480.0)):
    """The random windowed problem of tests/test_ops_pallas.py: map
    descriptors a quarter of which are copies of frame descriptors placed
    3 px from their keypoints."""
    desc_a = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    desc_b = rng.integers(0, 2**32, size=(m, 8), dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, n, size=m // 4)
    desc_b[: m // 4] = desc_a[idx]
    uv_a = rng.uniform(0, img, size=(n, 2)).astype(np.float32)
    uv_b = rng.uniform(0, img, size=(m, 2)).astype(np.float32)
    uv_b[: m // 4] = uv_a[idx] + 3.0
    r_a = rng.uniform(8.0, 40.0, size=(n,)).astype(np.float32)
    return [desc_a, uv_a, r_a, rng.random(n) < 0.9, desc_b, uv_b, rng.random(m) < 0.8]


def _match_both(prob, **kw):
    ref = j_fused_match(*(jnp.asarray(a) for a in prob), m_tile=128,
                        interpret=True, **kw)
    got = hc.fused_match_top2(*(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                                 else a) for a in prob), **kw)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("ratio", [1.0, 0.9])
def test_fused_match_twin_matches_pallas(mutual, ratio):
    ref, got = _match_both(_match_problem(np.random.default_rng(0)),
                           max_dist=64, ratio=ratio, mutual=mutual)
    assert ref[1].sum() > 10
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2][ref[1]], ref[2][ref[1]])


def test_fused_match_twin_infinite_radius():
    """r = inf, the relocalization call: a plain brute-force match."""
    prob = _match_problem(np.random.default_rng(1))
    prob[2] = np.full_like(prob[2], np.inf)
    ref, got = _match_both(prob, max_dist=80, ratio=0.95, mutual=True)
    assert ref[1].sum() > 10
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], ref[0])


def test_fused_match_cpu_takes_the_twin_and_checks_inputs():
    prob = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
            for a in _match_problem(np.random.default_rng(2), n=16, m=64)]
    before = dict(fc.LAUNCHES)
    hc.fused_match_top2(*prob, max_dist=64)
    assert fc.LAUNCHES == before and hc.LAUNCHES is fc.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        hc.fused_match_tiles(*prob)


def test_kernel_build_is_keyed_by_source():
    """Each source builds into its own library under build/, named by a
    hash of source and flags, so a stale build is never loaded."""
    paths = {name: fc._lib_path(name) for name in fc.KERNELS}
    assert len(set(paths.values())) == len(fc.KERNELS)
    for name, p in paths.items():
        assert p.parent == fc.BUILD_DIR and p.name.startswith(f"lib{name}.")
    assert "arch=compute_90a,code=sm_90a" in fc.NVCC_FLAGS
