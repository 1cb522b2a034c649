"""Distributed GLOBAL bundle adjustment over the mesh's ``pt`` group
(``boslam_tpu.parallel.sharded_global_ba``).

The full-map edge list (``solvers.global_ba.build_global_edges``) is
sharded landmark-wise: each rank owns a stripe of landmarks and every
observation of them; camera poses are replicated.  One ``all_reduce`` per
LM iteration sums the camera-side normal equations, and every PCG matvec
sums its [C, 6] camera-space output the same way; landmark blocks (Hpp,
back-substitution) never leave their rank.  At the end the stripes are
gathered, so every rank returns the whole map.

A point-sharded edge list is no longer the ``[K, N]`` keypoint table that
the single-device solver's camera reductions reshape, so camera sums here
are sorted segment sums (a stable sort on the camera, then the two-level
cumsum), as the point sums are; no float atomics.

Every quantity the host reads (the PCG exit) and every accept decision
derives from all-reduced values, so all ranks take the same path through
the loops and issue the same collectives.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.device import resolve_device
from boslam_tpu_torch.geometry import se3
from boslam_tpu_torch.mapping.map_state import MapState
from boslam_tpu_torch.parallel.sharded_ba import (
    all_reduce_sum, segment_schedule, shard_edges_by_point, shard_rows,
    stripe_points,
)
from boslam_tpu_torch.solvers import ba_core
from boslam_tpu_torch.solvers.global_ba import (
    _damped, _inv6x6, _pcg, _point_schedule, _point_sum, build_global_edges,
)
from boslam_tpu_torch.tracking.tracker import HostSync


def make_sharded_global_ba(cfg: SlamConfig, mesh, lm_iters: int,
                           cg_iters: int, sync: HostSync | None = None):
    """Distributed global-BA solver over ``mesh``'s ``pt`` group.

    fn(poses [C, 7] replicated, opt_cam_mask [C] replicated, pts_local this
       rank's landmark stripe, edges_local this rank's ``BaEdges`` with
       SHARD-LOCAL point indices)
    -> (poses, pts_local, cost0, cost1).  ``sync`` counts the PCG loop's
    host reads.
    """
    delta = cfg.local_ba.huber_delta
    group = mesh.group("pt")
    sync = HostSync() if sync is None else sync

    def cost_of(poses, pts, edges):
        return all_reduce_sum(
            [ba_core.robust_cost(cfg, poses, pts, edges, delta)], group)[0]

    def fn(poses, opt_cam_mask, pts, edges):
        C = poses.shape[0]
        Pl = pts.shape[0]
        cam = edges.cam.long()
        # One sort per solve for each reduction: points, and cameras in
        # edge order and in point-sorted order.
        sched = _point_schedule(edges, Pl)
        cam_sched = segment_schedule(cam, edges.valid, C)
        cam_sched_s = segment_schedule(cam[sched.perm],
                                       edges.valid[sched.perm], C)
        opt = opt_cam_mask[:, None]
        cost = cost0 = cost_of(poses, pts, edges)
        lam = torch.tensor(1e-4, dtype=torch.float32, device=poses.device)
        for _ in range(lm_iters):
            r, J_cam, J_pt = ba_core.edge_residuals(cfg, poses, pts, edges)
            w, _ = ba_core.robust_weights(cfg, r, edges, delta)
            Jc = torch.where(opt_cam_mask[cam][:, None, None], J_cam, 0.0)
            wr = w[:, None] * r
            Hcc = _point_sum(cam_sched, torch.einsum(
                "eri,erj->eij", Jc, w[:, None, None] * Jc))
            bc = -_point_sum(cam_sched, torch.einsum("eri,er->ei", Jc, wr))
            # THE collective: the camera-side normal equations.
            Hcc, bc = all_reduce_sum([Hcc, bc], group)
            Hpp = _point_sum(sched, torch.einsum(
                "eri,erj->eij", J_pt, w[:, None, None] * J_pt))
            bp = -_point_sum(sched, torch.einsum("eri,er->ei", J_pt, wr))
            # Sorted-order copies for the CG matvecs.
            Jp_s = J_pt[sched.perm]
            Jc_s = Jc[sched.perm]
            w_s = w[sched.perm]
            Hpp_inv = ba_core.inv3x3(_damped(Hpp, lam, 1e-8))
            Hcc_d = _damped(Hcc, lam, 1e-7)

            def cam_reduce(z):
                """W^T z summed into camera space over all ranks: [C, 6].
                Runs in point-sorted edge order (the z gather is then
                contiguous per point)."""
                ze = z[torch.clamp(sched.pt_sorted, 0, Pl - 1)]
                ze = torch.where((sched.pt_sorted < Pl)[:, None], ze, 0.0)
                v = torch.einsum("erj,ej->er", Jp_s, ze) * w_s[:, None]
                v = torch.einsum("er,eri->ei", v, Jc_s)
                return all_reduce_sum([_point_sum(cam_sched_s, v)], group)[0]

            def point_half(x):
                """t = sum_e W_e^T x_cam(e) per local point."""
                u = torch.einsum("eri,ei->er", Jc, x[cam]) * w[:, None]
                u = torch.einsum("er,erj->ej", u, J_pt)
                return _point_sum(sched, u)

            zb = torch.einsum("pst,pt->ps", Hpp_inv, bp)
            b_s = (bc - cam_reduce(zb)) * opt
            Minv = _inv6x6(Hcc_d)

            def mv(x):
                x = x * opt
                z = torch.einsum("pst,pt->ps", Hpp_inv, point_half(x))
                y = torch.einsum("cij,cj->ci", Hcc_d, x) - cam_reduce(z)
                return y * opt + x * ~opt

            dxi, _ = _pcg(mv, b_s, Minv, cg_iters, sync=sync)
            dxi = dxi * opt
            # Landmark back-substitution stays on the rank.
            dpt = torch.einsum("pst,pt->ps", Hpp_inv, bp - point_half(dxi))
            new_poses = se3.retract(poses, dxi)
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


def distributed_global_ba(cfg: SlamConfig, mesh, state: MapState,
                          lm_iters: int = 6, cg_iters: int = 40,
                          device=None, sync: HostSync | None = None):
    """Full-map BA of a live ``MapState`` with landmarks sharded over the
    mesh's ``pt`` group; every rank of the group calls it with the same map.

    Host-side preparation: the observation edge list of the map, landmarks
    striped over the ranks, edges relabelled with rank-local point indices.
    The solve runs on ``device`` (default ``cuda``; it raises without a
    card); the map given may live anywhere.  Returns
    (MapState on the map's device, (cost0, cost1, n_edges)).
    """
    dev = resolve_device(device)
    C = state.kf_pose.shape[0]
    Pn = state.pt_xyz.shape[0]
    n = mesh.shape["pt"]
    rank = mesh.index("pt")
    edges = build_global_edges(cfg, state)
    e_sh, _ = shard_edges_by_point(edges, Pn, n)
    pts_sh, perm = stripe_points(state.pt_xyz.detach().cpu(), n)
    kf_valid = state.kf_valid.cpu()
    opt_cam_mask = kf_valid & (torch.arange(C) > 0)
    fn = make_sharded_global_ba(cfg, mesh, lm_iters, cg_iters, sync)
    poses, pts_out, cost0, cost1 = fn(
        state.kf_pose.to(dev), opt_cam_mask.to(dev),
        shard_rows(pts_sh, n, rank).to(dev),
        type(e_sh)(*(f.to(dev) for f in shard_rows(e_sh, n, rank))),
    )
    group = mesh.group("pt")
    if group is not None:
        parts = [torch.empty_like(pts_out) for _ in range(n)]
        dist.all_gather(parts, pts_out.contiguous(), group=group)
        pts_out = torch.cat(parts)
    # Un-stripe the landmark stripes back to global order.
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    home = state.kf_pose.device
    pt_xyz = pts_out[torch.as_tensor(inv, device=dev)].to(home)
    new_state = state._replace(
        kf_pose=torch.where(opt_cam_mask.to(home)[:, None], poses.to(home),
                            state.kf_pose),
        pt_xyz=torch.where(state.pt_valid[:, None], pt_xyz, state.pt_xyz),
    )
    return new_state, (float(cost0), float(cost1),
                       int(torch.sum(edges.valid)))
