"""The streaming projection-window Hamming matcher: a hand-written CUDA
kernel and its plain twin.

``fused_match_top2`` replaces the JAX package's Pallas kernel of the same
name (``boslam_tpu/ops/hamming_pallas.py``).  For a CUDA tensor it launches
``csrc/fused_match.cu`` (per-row best, second-best and argbest over the
admissible map columns, per-column argmin over valid rows) and applies the
reference's epilogue in PyTorch; for a CPU tensor it runs the plain twin,
the materialized [N, M] pipeline ``hamming_matrix_mxu`` + window mask +
``match_top2``.  There is no other route.  ``LAUNCHES["fused_match"]``
counts kernel launches only.
"""

from __future__ import annotations

import torch

from boslam_tpu_torch.matching import hamming
from boslam_tpu_torch.ops.build import LAUNCHES, check_launch, kernel_fn

_BIG = 1e9   # the reference's masked distance, exact in float32
TILE = 128   # map columns per block of the kernel's first pass
MAX_ROWS = 1 << 20


def fused_match_top2_plain(desc_a, uv_a, r_a, valid_a, desc_b, uv_b, vis_b,
                           max_dist: int, ratio: float = 1.0,
                           mutual: bool = True):
    """The plain twin: distances, window and top-2 materialized as [N, M]
    (the reference's jnp route)."""
    dist = hamming.hamming_matrix_mxu(desc_a, desc_b)
    d2 = torch.sum((uv_a[:, None, :] - uv_b[None, :, :]) ** 2, dim=-1)
    window = d2 <= (r_a[:, None] ** 2)
    return hamming.match_top2(dist, valid_a, vis_b, max_dist=max_dist,
                              ratio=ratio, mutual=mutual, extra_mask=window)


def _aligned(t: torch.Tensor, dtype, shape, align: int) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor whose data is ``align``-byte
    aligned (a copy only where needed)."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_match_top2: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    t = t.to(dtype).contiguous()
    if t.data_ptr() % align:
        t = t.clone()
    return t


def fused_match_tiles(desc_a, uv_a, r_a, valid_a, desc_b, uv_b, vis_b):
    """The kernel's raw outputs: (best f32 [N], second f32 [N], bidx i32 [N],
    colarg i32 [M]); masked distances are 1e9 and an unmatched row has bidx
    -1.  CUDA tensors only."""
    n, m = desc_a.shape[0], desc_b.shape[0]
    dev = desc_a.device
    if dev.type != "cuda":
        raise ValueError(f"fused_match_tiles: needs CUDA tensors, got {dev}")
    if not 1 <= n < MAX_ROWS or m < 1:
        raise ValueError(f"fused_match_top2: need 1 <= N < 2**20 rows and "
                         f"M >= 1 columns, got N={n}, M={m}")
    for t in (uv_a, r_a, valid_a, desc_b, uv_b, vis_b):
        if t.device != dev:
            raise ValueError("fused_match_top2: all inputs must share one "
                             "CUDA device")
    for name, t in (("desc_a", desc_a), ("desc_b", desc_b)):
        if t.dtype != torch.int32:
            raise ValueError(f"fused_match_top2: {name} must hold int32 "
                             f"words, got {t.dtype}")
    da = _aligned(desc_a, torch.int32, (n, 8), 16)
    db = _aligned(desc_b, torch.int32, (m, 8), 16)
    ua = _aligned(uv_a, torch.float32, (n, 2), 8)
    ub = _aligned(uv_b, torch.float32, (m, 2), 8)
    r2 = torch.clamp_max(_aligned(r_a, torch.float32, (n,), 4) ** 2, _BIG)
    va = _aligned(valid_a, torch.bool, (n,), 1)
    vb = _aligned(vis_b, torch.bool, (m,), 1)
    tiles = -(-m // TILE)
    part = torch.empty((3, tiles, n), dtype=torch.int32, device=dev)
    colarg = torch.empty((m,), dtype=torch.int32, device=dev)
    best = torch.empty((n,), dtype=torch.float32, device=dev)
    second = torch.empty((n,), dtype=torch.float32, device=dev)
    bidx = torch.empty((n,), dtype=torch.int32, device=dev)
    fn = kernel_fn("fused_match")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(da.data_ptr(), ua.data_ptr(), r2.data_ptr(), va.data_ptr(),
                 n, db.data_ptr(), ub.data_ptr(), vb.data_ptr(), m,
                 part.data_ptr(), colarg.data_ptr(), best.data_ptr(),
                 second.data_ptr(), bidx.data_ptr(), stream)
    check_launch("fused_match", err)
    LAUNCHES["fused_match"] += 1
    return best, second, bidx, colarg


def fused_match_top2(desc_a, uv_a, r_a, valid_a, desc_b, uv_b, vis_b,
                     max_dist: int, ratio: float = 1.0, mutual: bool = True):
    """Projection-window Hamming match.

    Args:
      desc_a: [N, 8] int32 frame descriptor words; uv_a [N, 2] keypoint
        pixels; r_a [N] window radius in pixels (``inf``: no window);
        valid_a [N] bool.
      desc_b: [M, 8] int32 map descriptor words; uv_b [M, 2] projected
        pixels; vis_b [M] bool.
      max_dist / ratio / mutual: as ``matching.hamming.match_top2``.

    Returns (match_idx [N] i32 into B or -1, match_mask [N] bool,
    match_dist [N] i32).  CUDA tensors -> the kernel; CPU -> the twin.
    """
    if desc_a.device.type == "cpu":
        return fused_match_top2_plain(desc_a, uv_a, r_a, valid_a, desc_b,
                                      uv_b, vis_b, max_dist, ratio, mutual)
    best, second, bidx, colarg = fused_match_tiles(
        desc_a, uv_a, r_a, valid_a, desc_b, uv_b, vis_b)
    # Epilogue on [N] / [M] vectors, as hamming_pallas.py has it.
    n, m = desc_a.shape[0], desc_b.shape[0]
    safe_idx = torch.clamp(bidx, 0, m - 1).long()
    ok = (valid_a & (bidx >= 0) & (best <= max_dist)
          & (best <= ratio * second))
    if mutual:
        ok = ok & (colarg[safe_idx] == torch.arange(n, device=bidx.device,
                                                    dtype=torch.int32))
    idx = torch.where(ok, bidx, -1)
    return idx.to(torch.int32), ok, best.to(torch.int32)
