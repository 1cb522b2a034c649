"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a machine with PyTorch
alone; the tests' conftest imports JAX, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: ``fast_rank`` raw/rank at rtol 1e-5 / atol 1e-3 with identical
corner support; ``extract_patches`` bit-exact."""

import numpy as np
import pytest
import torch

from boslam_tpu_torch.config import CameraConfig
from boslam_tpu_torch.features.frontend import _BOOST_HI, _LEVEL_BORDER
from boslam_tpu_torch.io import synthetic
from boslam_tpu_torch.ops import frontend_cuda as fc
from boslam_tpu_torch.slam import to_gray_u8

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
    assert fc.LAUNCHES == {"fast_rank": 1, "extract_patches": 1}
    fc.fast_rank_plain(gray, 20.0, 7.0, _BOOST_HI, _LEVEL_BORDER)
    assert fc.LAUNCHES["fast_rank"] == 1
    with pytest.raises(ValueError):
        fc.extract_patches(gray, idx.cpu(), idx.cpu())
