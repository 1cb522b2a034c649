"""Batched Hamming descriptor matching on torch tensors.

Descriptors are 256-bit, packed as eight 32-bit words held in int32 tensors
(the uint32 bits of the JAX package).  Shifts on int32 are arithmetic, so
every shift below is followed by a mask that drops the sign fill.

- ``hamming_matrix``: exact XOR + popcount.
- ``hamming_matrix_mxu``: popcount(a XOR b) = |a| + |b| - 2 a.b on 0/1 bit
  vectors, so the N x M distance matrix is one matrix product (exact in
  float32: every dot is at most 256).
"""

from __future__ import annotations

import torch

_BIG = 1 << 20


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Vectorized 32-bit popcount (Hacker's Delight) on words held in int32
    or int64; returns int32."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """[..., 8] words -> [..., 256] {0,1} float32 bit columns (LSB-first)."""
    shifts = torch.arange(32, device=desc.device)
    bits = (desc.long()[..., :, None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], 256).to(torch.float32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] {0,1} -> [..., 8] int32 words (LSB-first)."""
    b = bits.reshape(*bits.shape[:-1], 8, 32).long()
    w = torch.sum(b << torch.arange(32, device=bits.device), dim=-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Exact Hamming distances: [N, 8] x [M, 8] -> [N, M] int32."""
    x = desc_a[:, None, :] ^ desc_b[None, :, :]
    return torch.sum(popcount_u32(x), dim=-1, dtype=torch.int32)


def hamming_matrix_mxu(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Hamming distances via one matrix product:
    popcount(a ^ b) = popcount(a) + popcount(b) - 2 * dot(bits_a, bits_b).
    [..., N, 8] x [..., M, 8] -> [..., N, M] (leading dims broadcast)."""
    bits_a = unpack_bits(desc_a)
    bits_b = unpack_bits(desc_b)
    dot = bits_a @ bits_b.transpose(-1, -2)
    na = torch.sum(popcount_u32(desc_a), dim=-1).to(torch.float32)
    nb = torch.sum(popcount_u32(desc_b), dim=-1).to(torch.float32)
    return torch.round(na[..., :, None] + nb[..., None, :] - 2.0 * dot).to(torch.int32)


def match_top2(
    dist: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    max_dist: int,
    ratio: float = 1.0,
    mutual: bool = True,
    extra_mask: torch.Tensor | None = None,
):
    """Row-wise best + second-best with ratio test, threshold, mutual check.

    Args:
      dist: [..., N, M] integer distances.
      valid_a: [..., N] bool, valid_b: [..., M] bool.
      extra_mask: optional [..., N, M] bool of admissible pairs.

    Returns:
      (match_idx [..., N] int32 into B, -1 if unmatched; match_mask bool;
       match_dist int32).  Ties go to the first index, as in the
      reference (``argmin`` returns the first minimum in both frameworks).
    """
    big = torch.full((), _BIG, dtype=dist.dtype, device=dist.device)
    masked = torch.where(valid_b[..., None, :], dist, big)
    if extra_mask is not None:
        masked = torch.where(extra_mask, masked, big)
    best_idx = torch.argmin(masked, dim=-1, keepdim=True)
    best = torch.gather(masked, -1, best_idx)[..., 0]
    second = torch.min(masked.scatter(-1, best_idx, _BIG), dim=-1).values
    best_idx = best_idx[..., 0]
    ok = valid_a & (best <= max_dist) & (
        best.to(torch.float32) <= ratio * second.to(torch.float32)
    )
    if mutual:
        col_best = torch.argmin(
            torch.where(valid_a[..., :, None], masked, big), dim=-2)
        rows = torch.arange(masked.shape[-2], device=dist.device)
        ok = ok & (torch.gather(col_best, -1, best_idx) == rows)
    idx = torch.where(ok, best_idx, -1)
    return idx.to(torch.int32), ok, best.to(torch.int32)
