"""The frontend's two hand-written CUDA kernels and their plain twins.

``fast_rank`` (FAST-9 hi/lo score + 3x3 NMS + rank fusion, ``csrc/
fast_rank.cu``) replaces the JAX package's Pallas kernel
``fast_rank_pallas``; ``extract_patches`` (32x32 patch gather fused with
orientation and rotated BRIEF, ``csrc/describe_patches.cu``) replaces
``extract_patches_pallas`` and the tensor code that consumed its patches.
Each kernel takes every pyramid level of a frame in one launch
(``fast_rank_levels``, ``describe_patches``); ``fast_rank`` and
``extract_patches`` are one-level calls of the same kernels.  A wrapper
launches its kernel for CUDA tensors and runs its plain PyTorch twin for CPU
tensors; there is no other route.  ``LAUNCHES`` counts kernel launches only.

The kernels find their level in a small table of pointers and shapes that
the wrapper builds from Python ints and ``data_ptr()``s and the C entry
copies into the launch as a by-value kernel parameter: no host-to-device
copy, no synchronisation.

The sources are built and bound by ``ops.build`` (``nvcc`` for ``sm_90a``,
a plain C interface, ``ctypes``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
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

MAX_LEVELS = 16        # rows of the kernels' level tables
FAST_TILE = (30, 30)   # output tile (w, h): OX, OY of csrc/fast_rank.cu
_ALIGN = 4             # floats: every output view starts 16-byte aligned

# The fused patch kernel against its plain twin (``describe_report``): the
# moments' summation order moves the angle by float rounding, and a bin edge
# within that flips the bin.
DESC_ANGLE_ATOL, BIN_EDGE_TOL, ILL_COND = 1e-4, 1e-3, 1e-4


def _check_f32_2d(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 [H, W] "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def _check_levels(name: str, levels) -> torch.device:
    """A non-empty list of at most MAX_LEVELS contiguous f32 [H, W] tensors
    on one device; returns the device."""
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{name}: {len(levels)} levels, the kernel's table "
                         f"holds 1 to {MAX_LEVELS}")
    for t in levels:
        _check_f32_2d(name, t)
        if t.device != levels[0].device:
            raise ValueError(f"{name}: levels on {levels[0].device} and "
                             f"{t.device}")
    dev = levels[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


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


# The level table of csrc/fast_rank.cu (FastLevel, FastTable).
class _FastLevel(ctypes.Structure):
    _fields_ = [("img", ctypes.c_void_p), ("rank", ctypes.c_void_p),
                ("raw", ctypes.c_void_p), ("h", ctypes.c_int),
                ("w", ctypes.c_int), ("tile0", ctypes.c_int),
                ("tiles_x", ctypes.c_int)]


class _FastTable(ctypes.Structure):
    _fields_ = [("lv", _FastLevel * MAX_LEVELS), ("n", ctypes.c_int),
                ("n_tiles", ctypes.c_int)]


def fast_tiles(shapes):
    """The flat tile grid of one launch over levels of ``shapes`` [(h, w)]:
    ([(tile0, tiles_x, tiles_y)] per level, total tiles).  Level l owns tile
    indices tile0 .. tile0 + tiles_x * tiles_y - 1, row-major."""
    tw, th = FAST_TILE
    out, n = [], 0
    for h, w in shapes:
        tx, ty = -(-w // tw), -(-h // th)
        out.append((n, tx, ty))
        n += tx * ty
    return out, n


def view_offsets(sizes, align=_ALIGN):
    """Offsets (in elements) of consecutive views of ``sizes`` elements in
    one allocation, each a multiple of ``align``; and the total."""
    offs, n = [], 0
    for size in sizes:
        offs.append(n)
        n += -(-size // align) * align
    return offs, n


@functools.lru_cache(maxsize=32)
def _fast_plan(shapes):
    """What one launch over levels of ``shapes`` needs besides pointers:
    (rank offsets, raw offsets, elements to allocate, tiles, grid size)."""
    offs, total = view_offsets([h * w for h, w in shapes] * 2)
    tiles, n_tiles = fast_tiles(shapes)
    n = len(shapes)
    return offs[:n], offs[n:], total, tiles, n_tiles


def _launch_fast_rank(levels, t_hi, t_lo, boost_hi, border):
    """One launch of the ``fast_rank`` kernel over CUDA ``levels``; [(rank,
    raw)] as views of one allocation."""
    dev = levels[0].device
    shapes = tuple(tuple(t.shape) for t in levels)
    rank_offs, raw_offs, total, tiles, n_tiles = _fast_plan(shapes)
    buf = torch.empty(total, dtype=torch.float32, device=dev)
    base = buf.data_ptr()
    table = _FastTable(n=len(levels), n_tiles=n_tiles)
    out = []
    for l, (lvl, (h, w)) in enumerate(zip(levels, shapes)):
        out.append((buf.as_strided((h, w), (w, 1), rank_offs[l]),
                    buf.as_strided((h, w), (w, 1), raw_offs[l])))
        table.lv[l] = _FastLevel(lvl.data_ptr(), base + 4 * rank_offs[l],
                                 base + 4 * raw_offs[l], h, w, tiles[l][0],
                                 tiles[l][1])
    fn = kernel_fn("fast_rank")
    with torch.cuda.device(dev):
        err = fn(ctypes.addressof(table), float(t_hi), float(t_lo),
                 float(boost_hi), int(border),
                 torch.cuda.current_stream(dev).cuda_stream)
    check_launch("fast_rank", err)
    LAUNCHES["fast_rank"] += 1
    return out


def fast_rank_levels(levels, t_hi: float, t_lo: float, boost_hi: float,
                     border: int):
    """[(rank [H, W], raw [H, W])] for every level of a pyramid: ``rank`` is
    the NMS'd, border-masked ranking map with hi-threshold corners boosted
    by ``boost_hi``; ``raw`` is the pre-NMS score (hi where present, else
    lo).  CUDA levels -> ONE launch of the ``fast_rank`` kernel, the maps
    being views of one allocation; CPU levels -> the plain twin per level."""
    levels = list(levels)
    dev = _check_levels("fast_rank", levels)
    for t in levels:
        if min(t.shape) < 2 * border + 1:
            raise ValueError(f"fast_rank: level {tuple(t.shape)} has no "
                             f"pixel inside a border of {border}")
    if dev.type == "cpu":
        return [fast_rank_plain(t, t_hi, t_lo, boost_hi, border)
                for t in levels]
    return _launch_fast_rank(levels, t_hi, t_lo, boost_hi, border)


def fast_rank(level, t_hi: float, t_lo: float, boost_hi: float, border: int):
    """(rank, raw) of one level: ``fast_rank_levels`` on a one-level pyramid."""
    return fast_rank_levels([level], t_hi, t_lo, boost_hi, border)[0]


# ---------------------------------------------------------------------------
# Patch gather + orientation + rotated BRIEF
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


def describe_patches_plain(blurred_levels, ys_levels, xs_levels):
    """(angle [K], desc [K, 8]) in plain PyTorch: the patches of every level,
    concatenated, through ``features.frontend.orient_and_brief``."""
    from boslam_tpu_torch.features.frontend import orient_and_brief

    return orient_and_brief(torch.cat([
        extract_patches_plain(img, ys, xs)
        for img, ys, xs in zip(blurred_levels, ys_levels, xs_levels)]))


def describe_report(blurred_levels, ys_levels, xs_levels, angle, desc):
    """Hold a (angle, desc) of ``describe_patches`` over the given levels to
    the plain twin (``extract_patches_plain`` -> ``orient_and_brief``).

    The contract: angle within DESC_ANGLE_ATOL (as an angle: pi and -pi are
    one direction); descriptors bit-exact wherever the bin agrees; the bin
    may differ only where the plain twin's angle * 32 / 2 pi lies within
    BIN_EDGE_TOL of a half-integer, or where the moments are ill-conditioned
    (|m10| + |m01| < ILL_COND * sum |w v|: a nearly symmetric patch, where
    the plain twin's own angle is rounding noise and is not compared).
    Returns the counts and a list of violations (empty when it holds)."""
    from boslam_tpu_torch.features import frontend

    patches = torch.cat([
        extract_patches_plain(img, ys, xs)
        for img, ys, xs in zip(blurred_levels, ys_levels, xs_levels)])
    angle_p, desc_p = frontend.orient_and_brief(patches)
    flat = patches.reshape(patches.shape[0], -1)
    wts = frontend._frontend_constants(flat.device)[1]
    ill = ((flat @ wts).abs().sum(1)
           < ILL_COND * (flat.abs() @ wts.abs()).sum(1))
    c = frontend.N_ANGLE_BINS / (2.0 * math.pi)
    t = angle_p * c
    edge = ((t - torch.floor(t)) - 0.5).abs() < BIN_EDGE_TOL
    bins = torch.remainder(torch.round(angle * c).long(), frontend.N_ANGLE_BINS)
    bins_p = torch.remainder(torch.round(t).long(), frontend.N_ANGLE_BINS)
    differ = bins != bins_p
    d = (angle - angle_p).abs()
    d = torch.minimum(d, 2.0 * math.pi - d)
    err = float(d[~ill].max()) if bool((~ill).any()) else 0.0
    same_desc = (desc == desc_p).all(1)
    bad = []
    if not err <= DESC_ANGLE_ATOL:
        bad.append(f"angle differs by {err}")
    if bool((~differ & ~same_desc).any()):
        bad.append(f"{int((~differ & ~same_desc).sum())} descriptors differ "
                   f"at an equal bin")
    if bool((differ & ~edge & ~ill).any()):
        bad.append(f"{int((differ & ~edge & ~ill).sum())} bins differ away "
                   f"from a bin edge at well-conditioned moments")
    return dict(keypoints=int(angle.shape[0]), max_angle_err=err,
                bins_differ_at_edge=int((differ & edge & ~ill).sum()),
                bins_differ_ill_conditioned=int((differ & ill).sum()),
                ill_conditioned=int(ill.sum()), violations=bad)


def brief_table_np() -> np.ndarray:
    """[32, 512] uint16: for each angle bin the flat patch index (row * 32 +
    col, < 1024) of the 512 rotated pattern points, from the package's own
    ``features.frontend._brief_index_np``."""
    from boslam_tpu_torch.features.frontend import _brief_index_np

    idx = _brief_index_np()
    if idx.min() < 0 or idx.max() >= PATCH * PATCH:
        raise ValueError("rotated pattern leaves the patch")
    return idx.astype(np.uint16)


@functools.lru_cache(maxsize=8)
def _brief_table(device: torch.device) -> torch.Tensor:
    """``brief_table_np`` on ``device`` (int16 storage of the uint16 bits)."""
    return torch.from_numpy(brief_table_np().view(np.int16)).to(device)


# The level table of csrc/describe_patches.cu (PatchLevel, PatchTable).
class _PatchLevel(ctypes.Structure):
    _fields_ = [("img", ctypes.c_void_p), ("ys", ctypes.c_void_p),
                ("xs", ctypes.c_void_p), ("h", ctypes.c_int),
                ("w", ctypes.c_int), ("k0", ctypes.c_int),
                ("pad_", ctypes.c_int)]


class _PatchTable(ctypes.Structure):
    _fields_ = [("lv", _PatchLevel * MAX_LEVELS), ("n", ctypes.c_int),
                ("n_kp", ctypes.c_int)]


def _check_patch_inputs(name, imgs, ys_levels, xs_levels) -> torch.device:
    """Lists of levels, rows and columns the patch kernel takes; returns
    their one device."""
    dev = _check_levels(name, imgs)
    if not len(imgs) == len(ys_levels) == len(xs_levels):
        raise ValueError(f"{name}: {len(imgs)} levels, {len(ys_levels)} ys, "
                         f"{len(xs_levels)} xs")
    for img, ys, xs in zip(imgs, ys_levels, xs_levels):
        h, w = img.shape
        if h < PATCH or w < PATCH:
            raise ValueError(f"{name}: image {h}x{w} smaller than a patch")
        if (ys.dtype != torch.int32 or xs.dtype != torch.int32
                or ys.dim() != 1 or ys.shape != xs.shape):
            raise ValueError(f"{name}: ys/xs must be int32 [K] tensors")
        if ys.device != dev or xs.device != dev:
            raise ValueError(f"{name}: img, ys and xs must share one device")
    return dev


def _launch_describe(imgs, ys_levels, xs_levels, want_patches: bool):
    """One launch of the fused kernel over CUDA levels: (angle [K], desc
    [K, 8], patches [K, 32, 32] or None), K the keypoints of all levels."""
    dev = imgs[0].device
    ys_levels = [t.contiguous() for t in ys_levels]
    xs_levels = [t.contiguous() for t in xs_levels]
    # Level l's keypoints are rows offs[l] .. of the frame's outputs.
    offs, k = view_offsets([t.shape[0] for t in ys_levels], align=1)
    angle = torch.empty(k, dtype=torch.float32, device=dev)
    desc = torch.empty((k, 8), dtype=torch.int32, device=dev)
    patches = (torch.empty((k, PATCH, PATCH), dtype=torch.float32, device=dev)
               if want_patches else None)
    if k == 0:
        return angle, desc, patches
    table = _PatchTable(n=len(imgs), n_kp=k)
    for l, (img, ys, xs) in enumerate(zip(imgs, ys_levels, xs_levels)):
        table.lv[l] = _PatchLevel(img.data_ptr(), ys.data_ptr(), xs.data_ptr(),
                                  img.shape[0], img.shape[1], offs[l], 0)
    brief = _brief_table(dev)
    fn = kernel_fn("extract_patches")
    with torch.cuda.device(dev):
        err = fn(ctypes.addressof(table), brief.data_ptr(), angle.data_ptr(),
                 desc.data_ptr(),
                 patches.data_ptr() if want_patches else None,
                 torch.cuda.current_stream(dev).cuda_stream)
    check_launch("extract_patches", err)
    LAUNCHES["extract_patches"] += 1
    return angle, desc, patches


def describe_patches(blurred_levels, ys_levels, xs_levels):
    """(angle [K] f32, desc [K, 8] int32) of a frame's keypoints, level after
    level: for keypoint (y, x) of level l the clipped 32x32 window of
    ``blurred_levels[l]``, its intensity-centroid angle, and the rotated-
    BRIEF descriptor sampled at the angle's bin.  CUDA tensors -> ONE launch
    of the ``extract_patches`` kernel (the patches stay in shared memory);
    CPU tensors -> ``describe_patches_plain``."""
    imgs, ys, xs = list(blurred_levels), list(ys_levels), list(xs_levels)
    dev = _check_patch_inputs("describe_patches", imgs, ys, xs)
    if dev.type == "cpu":
        return describe_patches_plain(imgs, ys, xs)
    angle, desc, _ = _launch_describe(imgs, ys, xs, want_patches=False)
    return angle, desc


def extract_patches(img, ys, xs):
    """[K, 32, 32] patches of ``img`` [H, W] f32 at int32 (ys, xs): a
    one-level call of the ``extract_patches`` kernel with its patch output
    on.  CPU tensors -> the plain twin."""
    dev = _check_patch_inputs("extract_patches", [img], [ys], [xs])
    if dev.type == "cpu":
        return extract_patches_plain(img, ys, xs)
    return _launch_describe([img], [ys], [xs], want_patches=True)[2]
