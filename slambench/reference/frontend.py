"""The plain feature frontend: FAST-9 + NMS, grid top-k, intensity-centroid
orientation and rotated BRIEF, in plain PyTorch.

Frozen copy, at commit bd2752c, of the plain path of
``boslam_tpu_torch/features/frontend.py`` (``distribute_features``,
``pyramid_shapes``, ``_gauss7``, ``_resize_weights_np``, ``resize_linear``,
``build_pyramid``, ``_blur``, ``_grid_select``, ``_subpixel_offsets``,
``_orient_weights_np``, ``_brief_index_np``, ``pack_words``,
``orient_and_brief``, ``extract_features_from_levels``),
``boslam_tpu_torch/features/pattern.py``, the plain twins in
``boslam_tpu_torch/ops/frontend_cuda.py`` (``fast_rank_plain``,
``_contig9``, ``patch_index``, ``extract_patches_plain``) and
``boslam_tpu_torch/utils/tensor_ops.top_k``.  The two hand-written kernels
of the port are replaced by those twins; nothing here imports the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# FAST radius-3 Bresenham circle, (dx, dy), clockwise from 12 o'clock.
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
HALF = 15
PATCH = 2 * HALF + 2
LEVEL_BORDER = 17
N_ANGLE_BINS = 32
BOOST_HI = float(1 << 17)
BOOST_CELL = float(1 << 18)


class Features(NamedTuple):
    uv: torch.Tensor      # [N, 2] level-0 pixels
    depth: torch.Tensor   # [N] metres (0 = none)
    desc: torch.Tensor    # [N, 8] int32 words
    angle: torch.Tensor   # [N]
    octave: torch.Tensor  # [N] int32
    valid: torch.Tensor   # [N] bool


def make_pattern(seed: int = 42) -> np.ndarray:
    """[256, 4] float32 BRIEF point pairs ~ N(0, (31/5)^2), radius <= 13."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, 31 / 5.0, size=(256, 4)).astype(np.float32)
    for pair in (pts[:, 0:2], pts[:, 2:4]):
        r = np.linalg.norm(pair, axis=-1, keepdims=True)
        pair *= np.minimum(1.0, 13.0 / np.maximum(r, 1e-6))
    return pts


def top_k(values, k: int):
    """Descending, ties to the lower index (a stable sort)."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def distribute_features(n, n_levels, scale):
    inv = [1.0 / scale**l for l in range(n_levels)]
    total = sum(inv)
    ks = [max(8, int(round(n * w / total))) for w in inv]
    ks[0] += n - sum(ks)
    return ks


def pyramid_shapes(h, w, n_levels, scale):
    return [(max(int(round(h / scale**l)), 64), max(int(round(w / scale**l)), 64))
            for l in range(n_levels)]


def _gauss7(sigma: float = 2.0) -> np.ndarray:
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _resize_weights_np(m: int, n: int) -> np.ndarray:
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


def build_pyramid(gray, shapes):
    """Level l is level l-1 resized by ``W_h^T @ level @ W_w``."""
    levels = [gray]
    for hl, wl in shapes[1:]:
        prev = levels[-1]
        h, w = prev.shape
        wh = torch.from_numpy(_resize_weights_np(h, hl)).to(gray.device)
        ww = torch.from_numpy(_resize_weights_np(w, wl)).to(gray.device)
        levels.append((wh.T @ prev) @ ww)
    return levels


def _blur(img, kernel):
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


def _contig9(mask):
    dup = mask | (mask << 16)
    acc = dup
    for s in range(1, 9):
        acc = acc & (dup >> s)
    return (acc & 0xFFFF) != 0


def fast_rank(level, t_hi: float, t_lo: float, boost_hi: float, border: int):
    """FAST-9 hi/lo score + 3x3 NMS + rank fusion.  Returns (rank, raw)."""
    h, w = level.shape
    dev = level.device
    p = F.pad(level, (4, 4, 4, 4))
    th, tw = h + 2, w + 2
    center = p[3:3 + th, 3:3 + tw]
    zf = torch.zeros((th, tw), dtype=level.dtype, device=dev)
    zi = torch.zeros((th, tw), dtype=torch.int32, device=dev)
    mb_hi, md_hi, mb_lo, md_lo = zf, zf, zf, zf
    kb_hi, kd_hi, kb_lo, kd_lo = zi, zi, zi, zi
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for k, (dx, dy) in enumerate(CIRCLE):
        d = p[3 + dy:3 + dy + th, 3 + dx:3 + dx + tw] - center
        nd = -d
        bit = torch.full((), 1 << k, dtype=torch.int32, device=dev)
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

    nms_hi, nms_lo = nms(score_hi), nms(score_lo)
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    inb = ((rows >= border) & (rows < h - border)
           & (cols >= border) & (cols < w - border))
    rank = torch.where(nms_hi > 0, nms_hi + boost_hi, nms_lo)
    rank = torch.where(inb, rank, 0.0)
    raw_hi = score_hi[1:1 + h, 1:1 + w]
    raw_lo = score_lo[1:1 + h, 1:1 + w]
    return rank, torch.where(raw_hi > 0, raw_hi, raw_lo)


def _grid_select(rank, k: int, rows: int, cols: int):
    h, w = rank.shape
    n_cells = rows * cols
    ch, cw = -(-h // rows), -(-w // cols)
    q = min(max(2, -(-2 * k // n_cells)), k)
    padded = torch.zeros((rows * ch, cols * cw), dtype=rank.dtype,
                         device=rank.device)
    padded[:h, :w] = rank
    cells = padded.reshape(rows, ch, cols, cw).permute(0, 2, 1, 3).reshape(
        n_cells, ch * cw)
    topv, topi = top_k(cells, q)
    first = topv[:, 0]
    topv = torch.cat([(first + torch.where(first > 0, BOOST_CELL, 0.0))[:, None],
                      topv[:, 1:]], 1)
    cell = torch.arange(n_cells, device=rank.device)
    ys = (cell // cols)[:, None] * ch + topi // cw
    xs = (cell % cols)[:, None] * cw + topi % cw
    best, sel = top_k(torch.where(topv > 0, topv, 0.0).reshape(-1), k)
    return (ys.reshape(-1)[sel].to(torch.int32),
            xs.reshape(-1)[sel].to(torch.int32), best)


def _subpixel_offsets(score, ys, xs):
    h, w = score.shape
    ys = torch.clamp(ys.long(), 1, h - 2)
    xs = torch.clamp(xs.long(), 1, w - 2)
    base = ys * w + xs
    flat = score.reshape(-1)
    c = flat[base]

    def fit(lo, hi):
        denom = 2.0 * c - lo - hi
        off = torch.where(torch.abs(denom) > 1e-6, 0.5 * (hi - lo) / denom, 0.0)
        return torch.clamp(off, -0.5, 0.5)

    return (fit(flat[base - 1], flat[base + 1]),
            fit(flat[base - w], flat[base + w]))


def _orient_weights_np():
    dy, dx = np.mgrid[-HALF:HALF + 1, -HALF:HALF + 1]
    circ = (dx**2 + dy**2 <= HALF**2).astype(np.float32)
    wx = np.zeros((PATCH, PATCH), np.float32)
    wy = np.zeros((PATCH, PATCH), np.float32)
    wx[:2 * HALF + 1, :2 * HALF + 1] = dx * circ
    wy[:2 * HALF + 1, :2 * HALF + 1] = dy * circ
    return wx, wy


def _brief_index_np():
    pattern = make_pattern()
    pts = np.concatenate([pattern[:, 0:2], pattern[:, 2:4]], axis=0)
    idx = np.zeros((N_ANGLE_BINS, 512), np.int64)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        xr = pts[:, 0] * ca - pts[:, 1] * sa
        yr = pts[:, 0] * sa + pts[:, 1] * ca
        i = np.clip(np.round(yr).astype(np.int64) + HALF, 0, PATCH - 1)
        j = np.clip(np.round(xr).astype(np.int64) + HALF, 0, PATCH - 1)
        idx[b] = i * PATCH + j
    return idx


class Frontend:
    """The constant tables of one config, built once on ``device``."""

    def __init__(self, slam_cfg: dict, device):
        cam, orb = slam_cfg["camera"], slam_cfg["orb"]
        self.cam, self.orb = cam, orb
        self.shapes = pyramid_shapes(cam["height"], cam["width"],
                                     orb["n_levels"], orb["scale_factor"])
        self.budgets = distribute_features(orb["n_features"], orb["n_levels"],
                                           orb["scale_factor"])
        wx, wy = _orient_weights_np()
        self.kernel = torch.from_numpy(_gauss7()).to(device)
        self.moments_w = torch.from_numpy(
            np.stack([wx.reshape(-1), wy.reshape(-1)], 1)).to(device)
        self.brief_idx = torch.from_numpy(_brief_index_np()).to(device)
        self.bit_weights = (torch.ones(32, dtype=torch.int64, device=device)
                            << torch.arange(32, device=device))

    def _patches(self, img, ys, xs):
        h, w = img.shape
        ar = torch.arange(PATCH, device=ys.device)
        y0 = torch.clamp(ys.long(), HALF, h - HALF - 2) - HALF
        x0 = torch.clamp(xs.long(), HALF, w - HALF - 2) - HALF
        return img[(y0[:, None] + ar[None, :])[:, :, None],
                   (x0[:, None] + ar[None, :])[:, None, :]]

    def _orient_and_brief(self, patches):
        k = patches.shape[0]
        flat = patches.reshape(k, PATCH * PATCH)
        m = flat @ self.moments_w
        angle = torch.atan2(m[:, 1], m[:, 0])
        b = torch.remainder(torch.round(angle * (N_ANGLE_BINS / (2.0 * np.pi)))
                            .long(), N_ANGLE_BINS)
        vals = torch.gather(flat, 1, self.brief_idx[b])
        bits = (vals[:, :256] < vals[:, 256:]).reshape(k, 8, 32).long()
        words = (bits * self.bit_weights).sum(-1)
        return angle, torch.where(words >= 2**31, words - 2**32,
                                  words).to(torch.int32)

    def __call__(self, gray_u8, depth_u16) -> Features:
        """Features of one wire frame (u8 gray, u16 depth at the wire
        shape), both tensors on the frontend's device."""
        cam, orb = self.cam, self.orb
        h, w = cam["height"], cam["width"]
        levels = build_pyramid(gray_u8.to(torch.float32), self.shapes)
        depth = depth_u16.to(torch.float32) * (1.0 / cam["depth_factor"])
        t_hi, t_lo = float(orb["fast_threshold"]), float(orb["fast_threshold_min"])
        uv_all, oct_all, val_all, patches = [], [], [], []
        for l, (hl, wl) in enumerate(self.shapes):
            rank, raw = fast_rank(levels[l], t_hi, t_lo, BOOST_HI, LEVEL_BORDER)
            k = self.budgets[l]
            ys, xs, top = _grid_select(rank, k, orb["grid_rows"], orb["grid_cols"])
            dxs, dys = _subpixel_offsets(raw, ys, xs)
            xf, yf = xs.float() + dxs, ys.float() + dys
            sx, sy = w / wl, h / hl
            uv_all.append(torch.stack([(xf + 0.5) * sx - 0.5,
                                       (yf + 0.5) * sy - 0.5], -1))
            oct_all.append(torch.full((k,), l, dtype=torch.int32,
                                      device=depth.device))
            val_all.append(top > 0)
            patches.append(self._patches(_blur(levels[l], self.kernel), ys, xs))
        angle, desc = self._orient_and_brief(torch.cat(patches))
        uv, valid = torch.cat(uv_all), torch.cat(val_all)
        s = cam["depth_wire_stride"]
        hs, ws = depth.shape
        if s == 1:
            ui = torch.clamp(torch.round(uv[:, 0]).long(), 0, ws - 1)
            vi = torch.clamp(torch.round(uv[:, 1]).long(), 0, hs - 1)
        else:
            ui = torch.clamp(torch.floor((uv[:, 0] + 0.5) / s).long(), 0, ws - 1)
            vi = torch.clamp(torch.floor((uv[:, 1] + 0.5) / s).long(), 0, hs - 1)
        z = depth[vi, ui]
        has_depth = valid & (z > cam["depth_min"]) & (z < cam["depth_max"])
        return Features(uv=uv, depth=torch.where(has_depth, z, 0.0), desc=desc,
                        angle=angle, octave=torch.cat(oct_all), valid=valid)
