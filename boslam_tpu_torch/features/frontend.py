"""ORB-style feature frontend on torch tensors.

8-level image pyramid, FAST-9 corner score at two thresholds with 3x3 NMS,
per-level grid-distributed top-k with a fixed feature budget, intensity-
centroid orientation, rotated-BRIEF 256-bit descriptors packed into eight
32-bit words, and per-keypoint depth backprojection — the computation of
``boslam_tpu.features.frontend``.

Everything is static-shape: exactly ``cfg.orb.n_features`` keypoint slots per
frame, invalid slots masked.  Descriptor words are int32 tensors holding the
uint32 bits of the reference.

Two stages run as hand-written CUDA kernels on a CUDA tensor, one launch
per frame each, and as their plain twins on a CPU tensor
(``ops.frontend_cuda``): FAST + NMS + rank fusion over the whole pyramid,
and patch gather + orientation + rotated BRIEF over all keypoints
(``orient_and_brief`` below is that kernel's plain version).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple

import numpy as np
import torch

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.features.pattern import HALF, PATTERN
from boslam_tpu_torch.geometry import camera as cam_mod
from boslam_tpu_torch.ops import frontend_cuda
from boslam_tpu_torch.ops.frontend_cuda import PATCH as _PATCH
from boslam_tpu_torch.utils.tensor_ops import top_k

_LEVEL_BORDER = 17  # circle radius 3 + descriptor patch half 15 (rounded up)
N_ANGLE_BINS = 32   # rotated-BRIEF angle quantization (ORB paper: 12° bins)

# Rank boosts for the grid-distributed selection.  Raw FAST scores are
# intensity margins < 16*255 = 4080, so these separate cleanly in f32.
_BOOST_HI = float(1 << 17)    # high-threshold corner beats any low-threshold one
_BOOST_CELL = float(1 << 18)  # per-cell best beats everything (>=1 kp/cell)

# The plain twins of the two kernels, under the reference's names.
_fast_rank_maps = frontend_cuda.fast_rank_plain
_extract_patches = frontend_cuda.extract_patches_plain


class FrameFeatures(NamedTuple):
    """Per-frame feature set; all tensors have leading dim n_features."""

    uv: torch.Tensor        # [N, 2] f32, level-0 pixel coords
    xyz: torch.Tensor       # [N, 3] f32, camera-frame backprojection (0 if no depth)
    depth: torch.Tensor     # [N] f32 metres (0 if invalid)
    desc: torch.Tensor      # [N, 8] int32 holding the packed uint32 descriptor bits
    angle: torch.Tensor     # [N] f32 radians
    octave: torch.Tensor    # [N] i32 pyramid level
    response: torch.Tensor  # [N] f32 FAST score
    valid: torch.Tensor     # [N] bool
    has_depth: torch.Tensor # [N] bool


def distribute_features(n: int, n_levels: int, scale: float) -> List[int]:
    """Per-level keypoint budgets, geometric decay by 1/scale (ORB policy)."""
    inv = [1.0 / scale**l for l in range(n_levels)]
    total = sum(inv)
    ks = [max(8, int(round(n * w / total))) for w in inv]
    ks[0] += n - sum(ks)
    return ks


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    return [
        (max(int(round(h / scale**l)), 64), max(int(round(w / scale**l)), 64))
        for l in range(n_levels)
    ]


def _gauss7(sigma: float = 2.0) -> np.ndarray:
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _resize_weights_np(m: int, n: int) -> np.ndarray:
    """[m, n] f32 antialiased triangle weights of ``jax.image.resize(...,
    "linear")`` from m to n samples.  The sample positions take one rounding
    from a fused multiply-add, as the reference's compiled weights do."""
    f32 = np.float32
    inv = f32(1.0 / (n / m))
    kernel_scale = max(inv, f32(1.0))
    centers = np.arange(n, dtype=f32) + f32(0.5)
    sample = (centers.astype(np.float64) * np.float64(inv) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    tot = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(tot != 0, tot, 1), 0).astype(f32)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


@functools.lru_cache(maxsize=64)
def _resize_weights(m: int, n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_weights_np(m, n)).to(device)


def resize_linear(level: torch.Tensor, hl: int, wl: int) -> torch.Tensor:
    """Separable antialiased triangle resize, ``W_h^T @ level @ W_w``."""
    h, w = level.shape
    if (h, w) == (hl, wl):
        return level
    wh = _resize_weights(h, hl, level.device)
    ww = _resize_weights(w, wl, level.device)
    return (wh.T @ level) @ ww


def build_pyramid(gray: torch.Tensor, cfg: SlamConfig) -> List[torch.Tensor]:
    """Level 0 is ``gray``; level l is level l-1 resized to its shape."""
    shapes = pyramid_shapes(cfg.camera.height, cfg.camera.width,
                            cfg.orb.n_levels, cfg.orb.scale_factor)
    levels = [gray]
    for hl, wl in shapes[1:]:
        levels.append(resize_linear(levels[-1], hl, wl))
    return levels


def _blur(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable 7-tap Gaussian, SAME padding (edge replicate)."""
    h, w = img.shape
    p = torch.cat([img[:1].expand(3, w), img, img[-1:].expand(3, w)], 0)
    acc = kernel[0] * p[0:h, :]
    for i in range(1, 7):
        acc = acc + kernel[i] * p[i:i + h, :]
    p = torch.cat([acc[:, :1].expand(h, 3), acc, acc[:, -1:].expand(h, 3)], 1)
    out = kernel[0] * p[:, 0:w]
    for i in range(1, 7):
        out = out + kernel[i] * p[:, i:i + w]
    return out


def _grid_select(rank: torch.Tensor, k: int, rows: int, cols: int):
    """Spatially distributed top-k: per grid cell the top-q candidates, each
    cell's best boosted by _BOOST_CELL so every occupied cell places one
    keypoint before any places two, then global top-k.

    Returns (ys [k], xs [k], chosen_rank [k])."""
    h, w = rank.shape
    n_cells = rows * cols
    ch = -(-h // rows)
    cw = -(-w // cols)
    q = min(max(2, -(-2 * k // n_cells)), k)
    padded = torch.zeros((rows * ch, cols * cw), dtype=rank.dtype,
                         device=rank.device)
    padded[:h, :w] = rank
    cells = padded.reshape(rows, ch, cols, cw).permute(0, 2, 1, 3).reshape(
        n_cells, ch * cw
    )
    topv, topi = top_k(cells, q)                               # [n_cells, q]
    first = topv[:, 0]
    topv = torch.cat([(first + torch.where(first > 0, _BOOST_CELL, 0.0))[:, None],
                      topv[:, 1:]], 1)
    cell = torch.arange(n_cells, device=rank.device)
    ys = (cell // cols)[:, None] * ch + topi // cw             # [n_cells, q]
    xs = (cell % cols)[:, None] * cw + topi % cw
    flat_v = torch.where(topv > 0, topv, 0.0).reshape(-1)
    best, sel = top_k(flat_v, k)
    return (ys.reshape(-1)[sel].to(torch.int32),
            xs.reshape(-1)[sel].to(torch.int32), best)


def _subpixel_offsets(score, ys, xs):
    """Per-keypoint sub-pixel offsets from a 1D parabola fit per axis on the
    raw (pre-NMS) FAST score map; clamped to [-0.5, 0.5]."""
    h, w = score.shape
    ys = torch.clamp(ys.long(), 1, h - 2)
    xs = torch.clamp(xs.long(), 1, w - 2)
    base = ys * w + xs                                          # [K]
    flat = score.reshape(-1)
    c = flat[base]

    def fit(lo, hi):
        denom = 2.0 * c - lo - hi
        off = torch.where(torch.abs(denom) > 1e-6, 0.5 * (hi - lo) / denom, 0.0)
        return torch.clamp(off, -0.5, 0.5)

    return (fit(flat[base - 1], flat[base + 1]),
            fit(flat[base - w], flat[base + w]))


@functools.lru_cache(maxsize=1)
def _orient_weights_np():
    """Intensity-centroid moment weights on the 32x32 patch (31x31 circular
    support, zero last row/col)."""
    dy, dx = np.mgrid[-HALF : HALF + 1, -HALF : HALF + 1]
    circ = (dx**2 + dy**2 <= HALF**2).astype(np.float32)
    wx = np.zeros((_PATCH, _PATCH), np.float32)
    wy = np.zeros((_PATCH, _PATCH), np.float32)
    wx[: 2 * HALF + 1, : 2 * HALF + 1] = dx * circ
    wy[: 2 * HALF + 1, : 2 * HALF + 1] = dy * circ
    return wx, wy


@functools.lru_cache(maxsize=1)
def _brief_index_np():
    """For each of N_ANGLE_BINS quantized angles, the flat patch index
    (row * 32 + col) of the 512 rotated pattern points (256 pairs), rounded
    as the reference's one-hot selection tables are.  Returns [A, 512] i64."""
    pts = np.concatenate([PATTERN[:, 0:2], PATTERN[:, 2:4]], axis=0)  # [512,2] (x,y)
    a = N_ANGLE_BINS
    idx = np.zeros((a, 512), np.int64)
    for b in range(a):
        th = 2.0 * np.pi * b / a
        ca, sa = np.cos(th), np.sin(th)
        xr = pts[:, 0] * ca - pts[:, 1] * sa
        yr = pts[:, 0] * sa + pts[:, 1] * ca
        i = np.clip(np.round(yr).astype(np.int64) + HALF, 0, _PATCH - 1)
        j = np.clip(np.round(xr).astype(np.int64) + HALF, 0, _PATCH - 1)
        idx[b] = i * _PATCH + j
    return idx


@functools.lru_cache(maxsize=8)
def _frontend_constants(device: torch.device):
    wx, wy = _orient_weights_np()
    return (
        torch.from_numpy(_gauss7()).to(device),
        torch.from_numpy(np.stack([wx.reshape(-1), wy.reshape(-1)], 1)).to(device),
        torch.from_numpy(_brief_index_np()).to(device),
        (torch.ones(32, dtype=torch.int64, device=device)
         << torch.arange(32, device=device)),
    )


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] {0,1} -> [..., 8] int32 holding uint32 words (LSB-first)."""
    weights = _frontend_constants(bits.device)[3]
    w = (bits.reshape(*bits.shape[:-1], 8, 32).long() * weights).sum(-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def orient_and_brief(patches):
    """Orientation (intensity centroid) + binned rotated-BRIEF descriptor
    for a batch of 32x32 patches.  Returns (angle [K] f32, desc [K, 8] i32).

    The angle is continuous; only the descriptor sampling quantizes it to
    N_ANGLE_BINS.  The reference samples through one-hot einsums, which are
    exact selections, so a gather gives the same values and bits."""
    _, moments_w, brief_idx, _ = _frontend_constants(patches.device)
    k = patches.shape[0]
    flat = patches.reshape(k, _PATCH * _PATCH)
    m = flat @ moments_w                                       # [K, 2]
    angle = torch.atan2(m[:, 1], m[:, 0])
    a = N_ANGLE_BINS
    b = torch.remainder(torch.round(angle * (a / (2.0 * np.pi))).long(), a)
    vals = torch.gather(flat, 1, brief_idx[b])                 # [K, 512]
    bits = vals[:, :256] < vals[:, 256:]
    return angle, pack_words(bits)


def extract_features_from_levels(levels, depth, cfg: SlamConfig) -> FrameFeatures:
    """Features from a given pyramid (``levels[l]`` at ``pyramid_shapes``)
    and a depth map in metres at the wire shape ``cfg.camera.depth_wire_shape``."""
    orb = cfg.orb
    cam = cfg.camera
    h, w = cam.height, cam.width
    shapes = pyramid_shapes(h, w, orb.n_levels, orb.scale_factor)
    budgets = distribute_features(orb.n_features, orb.n_levels, orb.scale_factor)
    kernel = _frontend_constants(depth.device)[0]
    t_hi, t_lo = float(orb.fast_threshold), float(orb.fast_threshold_min)

    # One launch for the whole pyramid.  Adaptive FAST threshold: hi + lo
    # scores in one pass; hi corners outrank lo ones so lo corners only fill
    # weak cells.
    maps = frontend_cuda.fast_rank_levels(levels[:orb.n_levels], t_hi, t_lo,
                                          _BOOST_HI, _LEVEL_BORDER)

    uv_all, oct_all, resp_all, val_all = [], [], [], []
    blurred_all, ys_all, xs_all = [], [], []
    for l, (hl, wl) in enumerate(shapes):
        rank, raw_score = maps[l]
        k = budgets[l]
        ys, xs, top = _grid_select(rank, k, orb.grid_rows, orb.grid_cols)
        valid = top > 0
        blurred_all.append(_blur(levels[l], kernel))
        ys_all.append(ys)
        xs_all.append(xs)
        dxs, dys = _subpixel_offsets(raw_score, ys, xs)
        xf = xs.float() + dxs
        yf = ys.float() + dys
        # Level-l -> level-0 coords under the resize's pixel-center
        # alignment: x0 = (x_l + 0.5) * (W0 / W_l) - 0.5.
        sx, sy = w / wl, h / hl
        uv_all.append(torch.stack([(xf + 0.5) * sx - 0.5,
                                   (yf + 0.5) * sy - 0.5], -1))
        oct_all.append(torch.full((k,), l, dtype=torch.int32,
                                  device=depth.device))
        resp_all.append(raw_score[torch.clamp(ys.long(), 0, hl - 1),
                                  torch.clamp(xs.long(), 0, wl - 1)])
        val_all.append(valid)

    # One launch for the frame's keypoints: gather, orientation and BRIEF.
    angle, desc = frontend_cuda.describe_patches(blurred_all, ys_all, xs_all)

    uv = torch.cat(uv_all)
    valid = torch.cat(val_all)
    # Depth lookup at level-0 coords.  A wire stride s > 1 means sample
    # [i, j] summarizes pixel block [i*s:(i+1)*s, j*s:(j+1)*s], so a pixel
    # maps to its OWN block, floor((u+0.5)/s).
    s = cam.depth_wire_stride
    hs, ws = cam.depth_wire_shape
    if s == 1:
        ui = torch.clamp(torch.round(uv[:, 0]).long(), 0, ws - 1)
        vi = torch.clamp(torch.round(uv[:, 1]).long(), 0, hs - 1)
    else:
        ui = torch.clamp(torch.floor((uv[:, 0] + 0.5) / s).long(), 0, ws - 1)
        vi = torch.clamp(torch.floor((uv[:, 1] + 0.5) / s).long(), 0, hs - 1)
    z = depth[vi, ui]
    has_depth = valid & cam_mod.valid_depth(cam, z)
    z = torch.where(has_depth, z, 0.0)
    xyz = cam_mod.backproject(cam, uv, z)
    return FrameFeatures(
        uv=uv,
        xyz=torch.where(has_depth[:, None], xyz, 0.0),
        depth=z,
        desc=desc,
        angle=angle,
        octave=torch.cat(oct_all),
        response=torch.cat(resp_all),
        valid=valid,
        has_depth=has_depth,
    )


def extract_features(gray, depth, cfg: SlamConfig) -> FrameFeatures:
    """gray: [H, W] f32 in [0, 255]; depth: f32 metres (0 = invalid)."""
    return extract_features_from_levels(build_pyramid(gray, cfg), depth, cfg)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """Host-side u8 RGB -> f32 gray in [0, 255] (ITU-R BT.601, cv2-compatible)."""
    rgb = rgb.astype(np.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
