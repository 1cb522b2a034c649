"""Tensor counterparts of the JAX primitives the port needs and PyTorch has
no exact twin for: tie-stable top-k, static-size nonzero, and scatters that
drop out-of-range indices (``.at[].set/add(..., mode="drop")``).

None of them synchronizes with the host.
"""

from __future__ import annotations

import torch


def top_k(values: torch.Tensor, k: int):
    """``jax.lax.top_k`` on the last axis: descending, ties to the lower
    index.  A stable descending sort; ``torch.topk`` breaks ties otherwise."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def nonzero_static(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)`` for a 1-D mask: the
    first ``size`` True indices in order, padded with ``fill`` (int64)."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, tgt, torch.arange(mask.shape[0], device=mask.device))
    return out[:size]


def _with_dump_row(arr: torch.Tensor) -> torch.Tensor:
    return torch.cat([arr, torch.zeros_like(arr[:1])])


def set_drop(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """Copy of ``arr`` with ``arr[idx] = vals`` along dim 0; an index equal to
    ``len(arr)`` is dropped.  Kept indices must be distinct."""
    out = _with_dump_row(arr)
    out[idx.long()] = vals
    return out[:-1]


def add_drop(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """Copy of ``arr`` with ``vals`` added at ``idx`` along dim 0 (duplicates
    sum); an index equal to ``len(arr)`` is dropped."""
    vals = torch.as_tensor(vals, dtype=arr.dtype, device=arr.device)
    vals = vals.expand(idx.shape + arr.shape[1:])
    return _with_dump_row(arr).index_add(0, idx.long(), vals)[:-1]


def last_writer(idx: torch.Tensor, n: int) -> torch.Tensor:
    """For a scatter of ``len(idx)`` writes into ``n`` slots, the position of
    the LAST write to each slot (-1 if none): the sequential semantics of a
    scatter with duplicate indices, made deterministic on any device."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    out = torch.full((n,), -1, dtype=torch.int64, device=idx.device)
    return out.scatter_reduce(0, idx.long(), pos, reduce="amax")


def at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` along dim 0 for a 0-dim index tensor.  PyTorch reads a 0-dim
    index on the host (one device synchronization); a 1-element index
    tensor stays on the device."""
    return x[i.reshape(1).long()][0]


def set_at(x: torch.Tensor, i: torch.Tensor, value) -> torch.Tensor:
    """Copy of ``x`` with ``x[i] = value`` along dim 0, ``i`` a 0-dim index
    tensor (no host synchronization, as ``at``)."""
    out = x.clone()
    out[i.reshape(1).long()] = value
    return out
