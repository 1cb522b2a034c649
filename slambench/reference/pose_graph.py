"""The essential graph of a loop closure, its objective and a damped
Gauss-Newton over it, in plain PyTorch of any float dtype (float64 for the
check).  Nothing imports the port.

The graph is worked out again from the map that the program's closure
built it from (after the loop's points were fused and its edge recorded,
before any pose moved), as ``boslam_tpu_torch/solvers/pose_graph.py``
states it: every keyframe's spanning-tree edge to its parent (weight 100),
the ``4 K`` strongest covisibility pairs (ties to the lower pair in the
upper triangle's order) whose weight reaches ``covis_essential_weight``
(weight: the covisibility), and every recorded loop edge (weight 200),
each between two live keyframes.  A spanning or covisibility edge measures
``T_i T_j^-1`` at the map's poses; a loop edge carries its own.  The
objective is ``sum_e w_e |log(T_meas^-1 T_i T_j^-1)|^2``.

The solve starts from the map's poses with the current keyframe moved onto
the loop's measurement, holds slot 0 and the loop's candidate fixed with
every dead slot, and takes ``pg_iters`` Gauss-Newton steps, each damped as
the program damps it: ``H + 1e-6 I + 1e-3 diag(H)`` over the free
keyframes.  The Jacobians are central differences of the residual in the
left-multiplied twists of the two ends.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.geometry import exp, log, pose_compose, pose_inv

SPAN_W, LOOP_W = 100.0, 200.0
FD_STEP = 1e-6  # central differences: error ~ step^2 + eps / step


class Graph(NamedTuple):
    i: torch.Tensor       # [E] long
    j: torch.Tensor       # [E] long
    t_meas: torch.Tensor  # [E, 7] measured T_i T_j^-1
    w: torch.Tensor       # [E]


def essential_graph(m: dict, covis_weight: float, dtype) -> Graph:
    """The live edges of the map ``m`` (the program's arrays, any device):
    ``kf_pose``, ``kf_valid``, ``spanning_parent``, ``covis``,
    ``loop_edges``, ``loop_rel``, ``n_loop_edges``."""
    pose = m["kf_pose"].to(dtype)
    valid = m["kf_valid"].bool()
    K = pose.shape[0]
    dev = pose.device
    child = torch.arange(K, device=dev)
    parent = m["spanning_parent"].long()
    sp = (parent >= 0) & valid & valid[parent.clamp(0, K - 1)]
    iu, ju = torch.triu_indices(K, K, offset=1, device=dev)
    cw = m["covis"][iu, ju].to(dtype) * valid[iu] * valid[ju]
    order = torch.sort(cw, descending=True, stable=True).indices[:4 * K]
    cv = order[cw[order] >= covis_weight]
    n = int(m["n_loop_edges"])
    le = m["loop_edges"][:n].long()
    lp = (le >= 0).all(1) & valid[le.clamp(0, K - 1)].all(1)
    i = torch.cat([child[sp], iu[cv], le[lp, 0]])
    j = torch.cat([parent[sp], ju[cv], le[lp, 1]])
    meas = pose_compose(pose[i], pose_inv(pose[j]))
    n_meas = int(sp.sum()) + len(cv)
    t_meas = torch.cat([meas[:n_meas], m["loop_rel"][:n][lp].to(dtype)])
    w = torch.cat([torch.full((int(sp.sum()),), SPAN_W, dtype=dtype,
                              device=dev), cw[cv],
                   torch.full((int(lp.sum()),), LOOP_W, dtype=dtype,
                              device=dev)])
    return Graph(i, j, t_meas, w)


def residual(g: Graph, poses):
    """[E, 6]: log(T_meas^-1 T_i T_j^-1)."""
    return log(pose_compose(pose_inv(g.t_meas),
                            pose_compose(poses[g.i], pose_inv(poses[g.j]))))


def objective(g: Graph, poses):
    return torch.sum(g.w * torch.sum(residual(g, poses) ** 2, -1))


def _jacobians(g: Graph, poses):
    """[E, 6, 12]: d r / d (xi_i, xi_j) for T <- exp(xi) T at each end."""
    E = g.i.shape[0]
    steps = FD_STEP * torch.eye(12, dtype=poses.dtype, device=poses.device)
    cols = []
    for d in (steps, -steps):
        xi = d[None].expand(E, 12, 12)
        ti = pose_compose(exp(xi[..., :6]), poses[g.i][:, None].expand(E, 12, 7))
        tj = pose_compose(exp(xi[..., 6:]), poses[g.j][:, None].expand(E, 12, 7))
        m = pose_inv(g.t_meas)[:, None].expand(E, 12, 7)
        cols.append(log(pose_compose(m, pose_compose(ti, pose_inv(tj)))))
    return ((cols[0] - cols[1]) / (2 * FD_STEP)).transpose(1, 2)


def gauss_newton(g: Graph, poses, free, iters: int):
    """``iters`` damped Gauss-Newton steps over the ``free`` keyframes."""
    K = poses.shape[0]
    idx = torch.nonzero(free)[:, 0]
    col = torch.full((K,), -1, dtype=torch.long, device=poses.device)
    col[idx] = torch.arange(len(idx), device=poses.device)
    n = 6 * len(idx)
    for _ in range(iters):
        r = residual(g, poses)
        J = _jacobians(g, poses)
        Jf = poses.new_zeros((g.i.shape[0], 6, n + 6))  # last block: fixed
        for end, k in ((g.i, 0), (g.j, 6)):
            c = torch.where(col[end] >= 0, col[end], len(idx))
            cols = 6 * c[:, None] + torch.arange(6, device=poses.device)
            Jf.scatter_add_(2, cols[:, None, :].expand(-1, 6, -1),
                            J[:, :, k:k + 6])
        Jf = Jf[..., :n].reshape(-1, n)
        wr = g.w.repeat_interleave(6)
        H = Jf.T @ (wr[:, None] * Jf)
        b = -Jf.T @ (wr * r.reshape(-1))
        H = H + 1e-6 * torch.eye(n, dtype=H.dtype, device=H.device) \
            + 1e-3 * torch.diag(torch.diagonal(H))
        dx = poses.new_zeros((K, 6))
        dx[idx] = torch.linalg.solve(H, b).reshape(-1, 6)
        poses = pose_compose(exp(dx), poses)
    return poses


def loop_solve(m: dict, kf_id: int, cand: int, t_rel, covis_weight: float,
               iters: int, dtype=torch.float64):
    """(graph, start poses, the reference's solution) of the closure that
    built its graph from ``m`` and moved ``kf_id`` by ``t_rel`` onto
    ``cand``."""
    g = essential_graph(m, covis_weight, dtype)
    poses = m["kf_pose"].to(dtype).clone()
    poses[kf_id] = pose_compose(t_rel.to(dtype), poses[cand])
    free = m["kf_valid"].bool().clone()
    free[0] = free[cand] = False
    return g, poses, gauss_newton(g, poses, free, iters)
