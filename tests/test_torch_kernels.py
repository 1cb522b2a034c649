"""The port's two frontend kernels: their plain PyTorch twins against the
JAX package's golden twins and Pallas kernels (interpret mode), and the CPU
dispatch of the wrappers.  Each kernel against its twin on a CUDA card is
in tests/test_torch_cuda.py.

Tolerances: ``fast_rank`` raw/rank at rtol 1e-5 / atol 1e-3 with identical
corner support (the bar of tests/test_ops_pallas.py); ``extract_patches``
bit-exact."""

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
from boslam_tpu_torch.ops import frontend_cuda as fc

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


def test_kernel_build_is_keyed_by_source():
    """Each source builds into its own library under build/, named by a
    hash of source and flags, so a stale build is never loaded."""
    paths = {name: fc._lib_path(name) for name in fc.KERNELS}
    assert len(set(paths.values())) == len(fc.KERNELS)
    for name, p in paths.items():
        assert p.parent == fc.BUILD_DIR and p.name.startswith(f"lib{name}.")
    assert "arch=compute_90a,code=sm_90a" in fc.NVCC_FLAGS
