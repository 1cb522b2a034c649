"""The frontend's two hand-written CUDA kernels and their plain twins.

``fast_rank`` (FAST-9 hi/lo score + 3x3 NMS + rank fusion, ``csrc/
fast_rank.cu``) and ``extract_patches`` (32x32 patch gather, ``csrc/
extract_patches.cu``) replace the JAX package's Pallas kernels
``fast_rank_pallas`` and ``extract_patches_pallas``.  Each wrapper launches
its kernel for a CUDA tensor and runs its plain PyTorch twin for a CPU
tensor; there is no other route.  ``LAUNCHES`` counts kernel launches only.

The sources are built and bound by ``ops.build`` (``nvcc`` for ``sm_90a``,
a plain C interface, ``ctypes``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from boslam_tpu_torch.ops.build import (  # noqa: F401  (re-exported)
    BUILD_DIR, KERNELS, LAUNCHES, NVCC_FLAGS, _lib_path, build_kernels,
    check_launch, kernel_fn, reset_launches,
)

# FAST radius-3 Bresenham circle, (dx, dy), clockwise from 12 o'clock.
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
HALF = 15
PATCH = 2 * HALF + 2

# The kernels of this module; ``KERNELS`` and ``LAUNCHES`` (ops.build) name
# every kernel of the port.
FRONTEND_KERNELS = ("fast_rank", "extract_patches")


def _check_f32_2d(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 [H, W] "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# FAST-9 + NMS + rank fusion
# ---------------------------------------------------------------------------


def _contig9(mask: torch.Tensor) -> torch.Tensor:
    """int32 circle bitmask (bits 0..15) -> True iff >= 9 contiguous
    (circular) bits are set.  int32 holds the uint32 bits: bits 0..15 of
    ``dup >> s`` for s <= 8 never see the arithmetic shift's sign fill."""
    dup = mask | (mask << 16)
    acc = dup
    for s in range(1, 9):
        acc = acc & (dup >> s)
    return (acc & 0xFFFF) != 0


def fast_rank_plain(level, t_hi: float, t_lo: float, boost_hi: float,
                    border: int):
    """FAST-9 hi/lo score + 3x3 NMS + rank fusion in plain PyTorch (the
    reference's ``_fast_rank_maps``, op for op).  Returns (rank, raw)."""
    h, w = level.shape
    p = F.pad(level, (4, 4, 4, 4))
    th, tw = h + 2, w + 2  # compute region: 1 NMS halo each side
    center = p[3:3 + th, 3:3 + tw]
    zf = torch.zeros((th, tw), dtype=level.dtype, device=level.device)
    zi = torch.zeros((th, tw), dtype=torch.int32, device=level.device)
    mb_hi, md_hi, mb_lo, md_lo = zf, zf, zf, zf
    kb_hi, kd_hi, kb_lo, kd_lo = zi, zi, zi, zi
    zero = torch.zeros((), dtype=torch.int32, device=level.device)
    for k, (dx, dy) in enumerate(CIRCLE):
        d = p[3 + dy:3 + dy + th, 3 + dx:3 + dx + tw] - center
        nd = -d
        bit = torch.full((), 1 << k, dtype=torch.int32, device=level.device)
        mb_hi = mb_hi + torch.clamp_min(d - t_hi, 0.0)
        md_hi = md_hi + torch.clamp_min(nd - t_hi, 0.0)
        mb_lo = mb_lo + torch.clamp_min(d - t_lo, 0.0)
        md_lo = md_lo + torch.clamp_min(nd - t_lo, 0.0)
        kb_hi = kb_hi | torch.where(d > t_hi, bit, zero)
        kd_hi = kd_hi | torch.where(nd > t_hi, bit, zero)
        kb_lo = kb_lo | torch.where(d > t_lo, bit, zero)
        kd_lo = kd_lo | torch.where(nd > t_lo, bit, zero)

    score_hi = torch.maximum(torch.where(_contig9(kb_hi), mb_hi, 0.0),
                             torch.where(_contig9(kd_hi), md_hi, 0.0))
    score_lo = torch.maximum(torch.where(_contig9(kb_lo), mb_lo, 0.0),
                             torch.where(_contig9(kd_lo), md_lo, 0.0))

    def nms(score):
        mx = score[0:h, 0:w]
        for ddy in range(3):
            for ddx in range(3):
                mx = torch.maximum(mx, score[ddy:ddy + h, ddx:ddx + w])
        inner = score[1:1 + h, 1:1 + w]
        return torch.where((inner >= mx) & (inner > 0.0), inner, 0.0)

    nms_hi = nms(score_hi)
    nms_lo = nms(score_lo)
    rows = torch.arange(h, device=level.device)[:, None]
    cols = torch.arange(w, device=level.device)[None, :]
    inb = ((rows >= border) & (rows < h - border)
           & (cols >= border) & (cols < w - border))
    rank = torch.where(nms_hi > 0, nms_hi + boost_hi, nms_lo)
    rank = torch.where(inb, rank, 0.0)
    raw_hi = score_hi[1:1 + h, 1:1 + w]
    raw_lo = score_lo[1:1 + h, 1:1 + w]
    raw = torch.where(raw_hi > 0, raw_hi, raw_lo)
    return rank, raw


def fast_rank(level, t_hi: float, t_lo: float, boost_hi: float, border: int):
    """(rank [H, W], raw [H, W]) for one pyramid level: ``rank`` is the
    NMS'd, border-masked ranking map with hi-threshold corners boosted by
    ``boost_hi``; ``raw`` is the pre-NMS score (hi where present, else lo).
    CUDA tensor -> the ``fast_rank`` kernel; CPU tensor -> the plain twin."""
    _check_f32_2d("fast_rank", level)
    if level.device.type == "cpu":
        return fast_rank_plain(level, t_hi, t_lo, boost_hi, border)
    if level.device.type != "cuda":
        raise ValueError(f"fast_rank: unsupported device {level.device}")
    h, w = level.shape
    rank = torch.empty_like(level)
    raw = torch.empty_like(level)
    fn = kernel_fn("fast_rank")
    with torch.cuda.device(level.device):
        stream = torch.cuda.current_stream(level.device).cuda_stream
        err = fn(level.data_ptr(), rank.data_ptr(), raw.data_ptr(), h, w,
                 float(t_hi), float(t_lo), float(boost_hi), int(border),
                 stream)
    check_launch("fast_rank", err)
    LAUNCHES["fast_rank"] += 1
    return rank, raw


# ---------------------------------------------------------------------------
# Patch gather
# ---------------------------------------------------------------------------


def patch_index(h: int, w: int, ys, xs):
    """Row/column index grids [K, 32, 1] / [K, 1, 32] of the clipped patches."""
    ar = torch.arange(PATCH, device=ys.device)
    y0 = torch.clamp(ys.long(), HALF, h - HALF - 2) - HALF
    x0 = torch.clamp(xs.long(), HALF, w - HALF - 2) - HALF
    return (y0[:, None] + ar[None, :])[:, :, None], \
        (x0[:, None] + ar[None, :])[:, None, :]


def extract_patches_plain(img, ys, xs):
    """[K, 32, 32] patches at (ys, xs) in plain PyTorch (the reference's
    ``_extract_patches_jnp``: clip, then one 32x32 window per keypoint)."""
    h, w = img.shape
    rows, cols = patch_index(h, w, ys, xs)
    return img[rows, cols]


def extract_patches(img, ys, xs):
    """[K, 32, 32] patches of ``img`` [H, W] f32 at int32 (ys, xs).
    CUDA tensor -> the ``extract_patches`` kernel; CPU -> the plain twin."""
    _check_f32_2d("extract_patches", img)
    h, w = img.shape
    if h < PATCH or w < PATCH:
        raise ValueError(f"extract_patches: image {h}x{w} smaller than a patch")
    if (ys.dtype != torch.int32 or xs.dtype != torch.int32 or ys.dim() != 1
            or ys.shape != xs.shape):
        raise ValueError("extract_patches: ys/xs must be int32 [K] tensors")
    if img.device.type == "cpu":
        return extract_patches_plain(img, ys, xs)
    if img.device.type != "cuda" or ys.device != img.device \
            or xs.device != img.device:
        raise ValueError("extract_patches: img, ys and xs must share one "
                         "CUDA device")
    ys, xs = ys.contiguous(), xs.contiguous()
    k = ys.shape[0]
    out = torch.empty((k, PATCH, PATCH), dtype=img.dtype, device=img.device)
    fn = kernel_fn("extract_patches")
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), ys.data_ptr(), xs.data_ptr(), out.data_ptr(),
                 k, h, w, stream)
    check_launch("extract_patches", err)
    LAUNCHES["extract_patches"] += 1
    return out
