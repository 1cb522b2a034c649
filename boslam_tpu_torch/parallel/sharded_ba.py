"""Landmark-sharded Schur bundle adjustment over a process group
(``boslam_tpu.parallel.sharded_ba``).

Landmark blocks and their observation edges are sharded over the mesh axis
``pt``; camera poses are replicated.  Each rank assembles its partial
camera-block contributions locally; one ``all_reduce`` per LM iteration sums
the small [KO*6, KO*6] Schur system over the ranks; every rank solves it
redundantly on identical inputs and back-substitutes its own landmark
shard.  Cross-shard covisibility needs no halo exchange: an edge lives with
its landmark, and the cameras are replicated.

Segment sums follow the edge list's layout without float atomics: edges are
sorted stably by segment once per solve, and a segment sum is the two-level
cumsum and boundary gathers of ``solvers.global_ba._point_sum``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.geometry import se3
from boslam_tpu_torch.solvers import ba_core
from boslam_tpu_torch.solvers.ba_core import BaEdges
from boslam_tpu_torch.solvers.global_ba import _point_schedule, _point_sum


class _Seg(NamedTuple):
    """The two fields ``_point_schedule`` reads: segment id, validity."""

    pt: torch.Tensor
    valid: torch.Tensor


def segment_schedule(seg, valid, n: int):
    """Stable-sort schedule of segment ids ``seg`` [E] (edges with ``valid``
    False land in no segment) for ``_point_sum`` into ``n`` segments."""
    return _point_schedule(_Seg(seg, valid), n)


def all_reduce_sum(tensors, group):
    """Sum each tensor over ``group`` with ONE collective on one flat
    buffer (the reference's single ``psum`` of a tuple)."""
    if group is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].reshape(t.shape))
        o += t.numel()
    return out


class _Schedules(NamedTuple):
    cam: object   # edges -> KO optimized cameras
    pt: object    # edges -> L local points
    pair: object  # edges -> L * KO (point, camera) pairs


def _schedules(edges: BaEdges, opt_cam_mask, L: int) -> _Schedules:
    KO = opt_cam_mask.shape[0]
    cam = edges.cam.long()
    is_opt = (cam < KO) & opt_cam_mask[torch.clamp(cam, 0, KO - 1)]
    return _Schedules(
        cam=segment_schedule(cam, is_opt, KO),
        pt=segment_schedule(edges.pt.long(), edges.valid, L),
        pair=segment_schedule(edges.pt.long() * KO + cam, is_opt, L * KO),
    )


def _local_partials(cfg: SlamConfig, poses, pts, edges, opt_cam_mask, lam,
                    sched: _Schedules):
    """Per-shard assembly: everything before the cross-shard reduction.

    Returns (Hcc, bc, S_cross, bs_corr, Hpp_inv, A, bp): the first four are
    partial sums to be all-reduced; the last three stay shard-local.
    """
    KO = opt_cam_mask.shape[0]
    L = pts.shape[0]
    delta = cfg.local_ba.huber_delta
    r, J_cam, J_pt = ba_core.edge_residuals(cfg, poses, pts, edges)
    w, _ = ba_core.robust_weights(cfg, r, edges, delta)

    cam = edges.cam.long()
    is_opt = (cam < KO) & opt_cam_mask[torch.clamp(cam, 0, KO - 1)]
    Jc = torch.where(is_opt[:, None, None], J_cam, 0.0)
    wJc = w[:, None, None] * Jc
    wJp = w[:, None, None] * J_pt
    wr = w[:, None] * r

    Hcc = _point_sum(sched.cam, torch.einsum("eri,erj->eij", Jc, wJc))
    bc = -_point_sum(sched.cam, torch.einsum("eri,er->ei", Jc, wr))
    Hpp = _point_sum(sched.pt, torch.einsum("eri,erj->eij", J_pt, wJp))
    bp = -_point_sum(sched.pt, torch.einsum("eri,er->ei", J_pt, wr))
    A = _point_sum(sched.pair, torch.einsum("eri,erj->eij", Jc, wJp)
                   ).reshape(L, KO, 6, 3)

    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    Hpp_d = Hpp + lam * (
        eye3 * torch.clamp(torch.diagonal(Hpp, dim1=-2, dim2=-1),
                           min=1e-6)[..., None, :]
    ) + 1e-8 * eye3
    Hpp_inv = ba_core.inv3x3(Hpp_d)
    M = torch.einsum("pkis,pst->pkit", A, Hpp_inv)
    S_cross = torch.einsum("pait,pbjt->aibj", M, A)
    bs_corr = torch.einsum("pait,pt->ai", M, bp)
    return Hcc, bc, S_cross, bs_corr, Hpp_inv, A, bp


def _camera_solve(KO, Hcc, bc, S_cross, bs_corr, opt_cam_mask, lam):
    """The reduced camera system: masked, LM-damped, 1e-7 jitter, dense
    Cholesky (the reference's ``_camera_solve``)."""
    dev = Hcc.device
    D = KO * 6
    ar = torch.arange(KO, device=dev)
    S = torch.zeros((KO, 6, KO, 6), dtype=Hcc.dtype, device=dev)
    S[ar, :, ar, :] = Hcc
    S = (S - S_cross).reshape(D, D)
    b_s = (bc - bs_corr).reshape(D)
    m = opt_cam_mask.to(Hcc.dtype).repeat_interleave(6)
    eye = torch.eye(D, dtype=Hcc.dtype, device=dev)
    S = S * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    b_s = b_s * m
    S = S + lam * torch.diag(torch.clamp(torch.diagonal(S), min=1e-6)) * eye
    L, _ = torch.linalg.cholesky_ex(S + 1e-7 * eye)
    dxi = torch.cholesky_solve(b_s[:, None], L)[:, 0].reshape(KO, 6)
    return dxi * opt_cam_mask[:, None]


def make_sharded_ba(cfg: SlamConfig, mesh, n_iters: int = 10):
    """A distributed LM solver over ``mesh``'s ``pt`` group.

    Inputs, per rank: poses [C, 7] and opt_cam_mask [KO] replicated;
    pts_local [L/n, 3] this rank's landmark stripe and edges_local this
    rank's ``BaEdges`` with SHARD-LOCAL point indices
    (``shard_edges_by_point`` / ``shard_rows``).

    Returns fn(poses, pts_local, edges_local, opt_cam_mask)
    -> (poses, pts_local, cost0, cost1).
    """
    KO = cfg.local_ba.n_opt_kf
    delta = cfg.local_ba.huber_delta
    group = mesh.group("pt")

    def cost_of(poses, pts, edges):
        local = ba_core.robust_cost(cfg, poses, pts, edges, delta)
        return all_reduce_sum([local], group)[0]

    def fn(poses, pts, edges, opt_cam_mask):
        sched = _schedules(edges, opt_cam_mask, pts.shape[0])
        cost = cost0 = cost_of(poses, pts, edges)
        lam = torch.tensor(cfg.local_ba.lm_lambda0, dtype=torch.float32,
                           device=poses.device)
        for _ in range(n_iters):
            Hcc, bc, S_cross, bs_corr, Hpp_inv, A, bp = _local_partials(
                cfg, poses, pts, edges, opt_cam_mask, lam, sched)
            # THE collective: the per-shard Schur contributions, summed.
            Hcc, bc, S_cross, bs_corr = all_reduce_sum(
                [Hcc, bc, S_cross, bs_corr], group)
            dxi = _camera_solve(KO, Hcc, bc, S_cross, bs_corr, opt_cam_mask,
                                lam)
            dpt = torch.einsum(
                "pst,pt->ps", Hpp_inv,
                bp - torch.einsum("pait,ai->pt", A, dxi))
            new_poses = torch.cat([se3.retract(poses[:KO], dxi), poses[KO:]])
            new_pts = pts + dpt
            new_cost = cost_of(new_poses, new_pts, edges)
            accept = new_cost < cost
            poses = torch.where(accept, new_poses, poses)
            pts = torch.where(accept, new_pts, pts)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              1e-9, 1e3)
            cost = torch.minimum(new_cost, cost)
        return poses, pts, cost0, cost

    return fn


def shard_edges_by_point(edges: BaEdges, n_pts: int, n_shards: int):
    """Host-side repartition: round-robin stripe points over shards and group
    edges with their landmark's shard, with local point re-indexing.

    Point p lives on shard p % n_shards at local index p // n_shards.
    Returns (edges_sharded [n_shards * E_cap], E_cap): CPU tensors, E_cap
    the largest per-shard edge count, shorter shards padded with invalid
    edges."""
    a = {f: np.asarray(torch.as_tensor(v).cpu()) for f, v in
         edges._asdict().items()}
    shard = a["pt"] % n_shards
    local = a["pt"] // n_shards
    buckets = [np.where((shard == s) & a["valid"])[0] for s in range(n_shards)]
    e_cap = max(len(sel) for sel in buckets)
    out = {f: [] for f in BaEdges._fields}
    for sel in buckets:
        pad = e_cap - len(sel)
        idx = np.concatenate([sel, np.zeros(pad, np.int64)])
        real = np.concatenate([np.ones(len(sel), bool), np.zeros(pad, bool)])
        for f in BaEdges._fields:
            v = local[idx] if f == "pt" else a[f][idx]
            out[f].append(v & real if f in ("has_depth", "valid") else v)
    return BaEdges(**{f: torch.from_numpy(np.concatenate(v))
                      for f, v in out.items()}), e_cap


def stripe_points(pts, n_shards: int):
    """[L, 3] -> the striped layout in which shard s holds the points
    p = s (mod n_shards) in order; returns (striped, perm)."""
    L = pts.shape[0]
    perm = np.argsort(np.arange(L) % n_shards, kind="stable")
    return pts[torch.as_tensor(perm, device=pts.device)], perm


def shard_rows(tree, n_shards: int, rank: int):
    """Rank ``rank``'s equal block of every leading axis of ``tree`` (a
    tensor or a NamedTuple of tensors), the rows it holds in the
    reference's ``P('pt')`` layout."""
    if isinstance(tree, tuple):
        return type(tree)(*(shard_rows(v, n_shards, rank) for v in tree))
    n = tree.shape[0] // n_shards
    return tree[rank * n:(rank + 1) * n]
