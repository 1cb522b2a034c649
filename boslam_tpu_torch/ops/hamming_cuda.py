"""The streaming projection-window Hamming matcher: a hand-written CUDA
kernel and its plain twin.

``fused_match_top2`` replaces the JAX package's Pallas kernel of the same
name (``boslam_tpu/ops/hamming_pallas.py``) with its epilogue.  For a CUDA
tensor it launches ``csrc/fused_match.cu``, two kernels that write the
match (index, mask, distance) themselves: distances on the tensor cores,
map tiles without a visible column skipped, max_dist / ratio / mutual
applied in the second pass.  For a CPU tensor it runs the plain twin, the
materialized [N, M] pipeline ``hamming_matrix_mxu`` + window mask +
``match_top2``.  There is no other route.  ``LAUNCHES["fused_match"]``
counts calls that launched the kernel.
"""

from __future__ import annotations

import torch

from boslam_tpu_torch.matching import hamming
from boslam_tpu_torch.ops.build import LAUNCHES, check_launch, kernel_fn

TILE = 128   # map columns per block of the kernel's first pass
ROWS = 128   # frame rows per block of the kernel's first pass
MAX_ROWS = 1 << 20
_ALIGN = 16  # bytes: every region of the workspace starts aligned


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


def workspace_layout(n: int, m: int):
    """({region: (byte offset, bytes)}, total bytes) of the one allocation a
    call makes: the kernel's scratch (per live map tile its rows' (k1, k2)
    keys, per row chunk its columns' keys, a live flag per tile) and the
    three outputs."""
    tiles, chunks = -(-m // TILE), -(-n // ROWS)
    sizes = (("rowpart", 8 * tiles * n), ("colpart", 4 * chunks * m),
             ("live", 4 * tiles), ("idx", 4 * n), ("dist", 4 * n),
             ("ok", n))
    layout, off = {}, 0
    for name, size in sizes:
        layout[name] = (off, size)
        off += -(-size // _ALIGN) * _ALIGN
    return layout, off


def _operand(t: torch.Tensor, dtype, shape, align: int) -> torch.Tensor:
    """``t`` as the kernel reads it: contiguous ``dtype`` data whose start is
    ``align``-byte aligned; a copy only where ``t`` is not that already."""
    if t.shape != shape:
        raise ValueError(f"fused_match_top2: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.dtype != dtype or not t.is_contiguous():
        t = t.to(dtype).contiguous()
    if t.data_ptr() % align:
        t = t.clone()
    return t


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
    match_dist [N] i32; 1e9 for a row without an admissible column).  CUDA
    tensors -> the kernel (two launches, the outputs views of one
    allocation); CPU -> the twin.
    """
    dev = desc_a.device
    if dev.type == "cpu":
        return fused_match_top2_plain(desc_a, uv_a, r_a, valid_a, desc_b,
                                      uv_b, vis_b, max_dist, ratio, mutual)
    if dev.type != "cuda":
        raise ValueError(f"fused_match_top2: needs CPU or CUDA tensors, "
                         f"got {dev}")
    n, m = desc_a.shape[0], desc_b.shape[0]
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
    da = _operand(desc_a, torch.int32, (n, 8), 16)
    db = _operand(desc_b, torch.int32, (m, 8), 16)
    ua = _operand(uv_a, torch.float32, (n, 2), 8)
    ub = _operand(uv_b, torch.float32, (m, 2), 8)
    ra = _operand(r_a, torch.float32, (n,), 4)
    va = _operand(valid_a, torch.bool, (n,), 1)
    vb = _operand(vis_b, torch.bool, (m,), 1)
    layout, total = workspace_layout(n, m)
    ws = torch.empty((total,), dtype=torch.uint8, device=dev)
    at = {name: ws.data_ptr() + off for name, (off, _) in layout.items()}
    idx, ok, dist = (ws[layout[k][0]:layout[k][0] + layout[k][1]].view(dt)
                     for k, dt in (("idx", torch.int32), ("ok", torch.bool),
                                   ("dist", torch.int32)))
    fn = kernel_fn("fused_match")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(da.data_ptr(), ua.data_ptr(), ra.data_ptr(), va.data_ptr(),
                 n, db.data_ptr(), ub.data_ptr(), vb.data_ptr(), m,
                 float(max_dist), float(ratio), int(bool(mutual)),
                 at["rowpart"], at["colpart"], at["live"], at["idx"],
                 at["ok"], at["dist"], stream)
    check_launch("fused_match", err)
    LAUNCHES["fused_match"] += 1
    return idx, ok, dist
