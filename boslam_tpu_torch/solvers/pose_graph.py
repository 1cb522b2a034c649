"""Pose-graph optimization over the essential graph
(``boslam_tpu.solvers.pose_graph``).

Vertices are all keyframe poses, edges the spanning tree + high-weight
covisibility pairs + loop edges, residual ``r = log(T_meas^-1 · T_i · T_j^-1)``.
The per-edge 6x12 Jacobians are closed-form (the reference takes them from
``jax.jacfwd`` under ``vmap``); the normal equations are assembled dense
([6K, 6K]) with gauge fixing by row masking and solved by Cholesky for
``pg_iters`` damped GN iterations.  The blocks are summed over a fixed
gather of each block's edges (``_block_sum``), never by float atomics, so
a closure gives the same poses on every run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.geometry import se3
from boslam_tpu_torch.mapping.map_state import MapState, recompute_covis
from boslam_tpu_torch.solvers import robust
from boslam_tpu_torch.utils.tensor_ops import at, last_writer, set_at, top_k


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor       # [E] i32
    j: torch.Tensor       # [E] i32
    t_meas: torch.Tensor  # [E, 7] measured T_i · T_j^-1
    weight: torch.Tensor  # [E] f32
    valid: torch.Tensor   # [E] bool


def build_essential_edges(
    cfg: SlamConfig, state: MapState, max_covis_edges: int | None = None
) -> PoseGraphEdges:
    """Essential graph edges with measurements taken from current poses.

    Call before applying any loop correction, so the relative measurements
    encode the pre-correction (locally consistent) geometry.
    """
    K = state.kf_pose.shape[0]
    dev = state.kf_pose.device
    E_cov = 4 * K if max_covis_edges is None else max_covis_edges

    # Spanning-tree edges.
    child = torch.arange(K, dtype=torch.int32, device=dev)
    parent = state.spanning_parent
    sp_j = torch.clamp(parent, 0, K - 1)
    sp_valid = (parent >= 0) & state.kf_valid & state.kf_valid[sp_j.long()]

    # Strong covisibility edges: top-E_cov upper-triangle weights (stable
    # order on tied integer weights, as jax.lax.top_k).
    iu0, iu1 = torch.triu_indices(K, K, offset=1, device=dev)
    w = state.covis[iu0, iu1] * state.kf_valid[iu0] * state.kf_valid[iu1]
    topw, top_idx = top_k(w, E_cov)
    cv_i = iu0[top_idx].to(torch.int32)
    cv_j = iu1[top_idx].to(torch.int32)
    cv_valid = topw >= cfg.map.covis_essential_weight

    # Loop edges: endpoints are -1 once a keyframe cull invalidated the
    # edge; both endpoints must be live.
    nl = state.loop_edges.shape[0]
    lp_i = state.loop_edges[:, 0]
    lp_j = state.loop_edges[:, 1]
    lp_valid = (
        (torch.arange(nl, device=dev) < state.n_loop_edges)
        & (lp_i >= 0) & (lp_j >= 0)
        & state.kf_valid[torch.clamp(lp_i, 0, K - 1).long()]
        & state.kf_valid[torch.clamp(lp_j, 0, K - 1).long()]
    )

    ei = torch.cat([child, cv_i, lp_i])
    ej = torch.cat([sp_j, cv_j, lp_j])
    valid = torch.cat([sp_valid, cv_valid, lp_valid])
    Ti = state.kf_pose[torch.clamp(ei, 0, K - 1).long()]
    Tj = state.kf_pose[torch.clamp(ej, 0, K - 1).long()]
    t_rel = se3.pose_compose(Ti, se3.pose_inv(Tj))
    # Loop edges carry their own measured relative pose.
    t_meas = torch.cat([t_rel[: K + E_cov], state.loop_rel])
    weight = torch.cat([torch.full((K,), 100.0, device=dev),
                        topw.to(torch.float32),
                        torch.full((nl,), 200.0, device=dev)])
    return PoseGraphEdges(ei, ej, t_meas, weight, valid)


def _edge_residual(t_meas, Ti, Tj):
    return se3.log(
        se3.pose_compose(se3.pose_inv(t_meas), se3.pose_compose(Ti, se3.pose_inv(Tj)))
    )


def _coupling_coeffs(theta2):
    """The three angle functions of the SE(3) left Jacobian's coupling
    block: (t - sin t)/t^3, (t^2/2 + cos t - 1)/t^4 and
    (t - sin t - t^3/6)/t^5, by Taylor series below t = 0.1, where the
    closed forms cancel in float32."""
    small = theta2 < 1e-2
    t2 = torch.where(small, 1.0, theta2)
    t = torch.sqrt(t2)
    s, c = torch.sin(t), torch.cos(t)
    x2, x4 = theta2, theta2 * theta2
    c1 = torch.where(small, 1 / 6 - x2 / 120 + x4 / 5040, (t - s) / (t2 * t))
    c2 = torch.where(small, 1 / 24 - x2 / 720 + x4 / 40320,
                     (t2 / 2 + c - 1) / (t2 * t2))
    c3 = torch.where(small, -1 / 120 + x2 / 5040 - x4 / 362880,
                     (t - s - t2 * t / 6) / (t2 * t2 * t))
    return c1, c2, c3


def _left_jacobian_inv(xi):
    """Inverse SE(3) left Jacobian [..., 6, 6] in the (omega, v) order:
    [[J^-1, 0], [-J^-1 Q J^-1, J^-1]], J the SO(3) left Jacobian and Q the
    coupling block of Barfoot's closed form."""
    W, Vh = se3.hat(xi[..., :3]), se3.hat(xi[..., 3:])
    c1, c2, c3 = _coupling_coeffs(torch.sum(xi[..., :3] ** 2, -1)[..., None, None])
    WV, VW, WVW = W @ Vh, Vh @ W, W @ Vh @ W
    Q = (0.5 * Vh + c1 * (WV + VW + WVW)
         + c2 * (W @ WV + VW @ W - 3.0 * WVW)
         + 0.5 * (c2 + 3.0 * c3) * (WVW @ W + W @ WVW))
    Ji = se3._so3_left_jacobian_inv(xi[..., :3])
    zero = torch.zeros_like(Ji)
    return torch.cat([torch.cat([Ji, zero], -1),
                      torch.cat([-Ji @ Q @ Ji, Ji], -1)], -2)


def _adjoint(T):
    """Adjoint [..., 6, 6] of poses [..., 7] on (omega, v) twists."""
    R = se3.quat_to_mat(T[..., :4])
    zero = torch.zeros_like(R)
    return torch.cat([torch.cat([R, zero], -1),
                      torch.cat([se3.hat(T[..., 4:]) @ R, R], -1)], -2)


def edge_jacobians(Ti, Tj, t_meas):
    """d r / d xi_i and d r / d xi_j at xi = 0 ([E, 6, 6] each) for the
    left-multiplicative updates T <- exp(xi) ∘ T, in closed form (the
    reference differentiates with ``jax.jacfwd``).  With E the edge error
    T_meas^-1 ∘ T_i ∘ T_j^-1 and r = log(E): the update of T_i enters as
    exp(Ad(T_meas^-1) xi_i) ∘ E, that of T_j as E ∘ exp(-xi_j), so
    J_i = Jl^-1(r) Ad(T_meas^-1) and J_j = -Jl^-1(-r)."""
    r = _edge_residual(t_meas, Ti, Tj)
    return (_left_jacobian_inv(r) @ _adjoint(se3.pose_inv(t_meas)),
            -_left_jacobian_inv(-r))


def _block_sum_plan(keys: torch.Tensor, rows: torch.Tensor):
    """Group ``rows`` (indices into a value tensor) by ``keys`` for
    ``_block_sum``: (the distinct keys [U], each key's rows [U, L] in row
    order, padded with -1).  One host read (L, the largest group)."""
    order = torch.argsort(keys, stable=True)
    uk, counts = torch.unique_consecutive(keys[order], return_counts=True)
    width = int(counts.max()) if counts.numel() else 0
    j = torch.arange(width, device=keys.device)
    pos = torch.clamp((torch.cumsum(counts, 0) - counts)[:, None] + j,
                      max=max(keys.numel() - 1, 0))
    return uk, torch.where(j < counts[:, None], rows[order][pos], -1)


def _block_sum(vals: torch.Tensor, plan, n: int) -> torch.Tensor:
    """[n, ...] sums of ``vals`` rows grouped by ``plan``, absent keys 0; the
    same order of additions on every run."""
    uk, rows = plan
    out = vals.new_zeros((n,) + vals.shape[1:])
    padded = torch.cat([vals, vals.new_zeros((1,) + vals.shape[1:])])
    out[uk] = padded[rows].sum(1)
    return out


def optimize_pose_graph(
    cfg: SlamConfig, poses, kf_valid, edges: PoseGraphEdges, fixed_mask
):
    """Damped GN on the pose graph.  ``fixed_mask`` [K] bool freezes gauge
    vertices (KF0 + the loop keyframe).  Returns optimized poses [K, 7]."""
    K = poses.shape[0]
    dev = poses.device
    free = kf_valid & ~fixed_mask
    # Negative endpoints index from the end, as the reference's scatter
    # normalizes them; such edges have zero weight.
    ia = torch.where(edges.i < 0, edges.i + K, edges.i).long()
    ib = torch.where(edges.j < 0, edges.j + K, edges.j).long()
    ci = torch.clamp(edges.i, 0, K - 1).long()
    cj = torch.clamp(edges.j, 0, K - 1).long()
    w = torch.where(edges.valid, edges.weight, 0.0)
    m = torch.repeat_interleave(free.to(torch.float32), 6)
    eye = torch.eye(K * 6, device=dev)
    # Block (a, b) of edge e sits in row (a, b) * E + e of the stacked
    # values; edges of weight 0 add nothing and are left out.
    E = w.shape[0]
    live = torch.nonzero(w != 0).squeeze(1)
    ends = (ia, ib)
    h_plan = _block_sum_plan(
        torch.cat([ends[a][live] * K + ends[b][live]
                   for a in (0, 1) for b in (0, 1)]),
        torch.cat([(2 * a + b) * E + live for a in (0, 1) for b in (0, 1)]))
    b_plan = _block_sum_plan(torch.cat([ia[live], ib[live]]),
                             torch.cat([live, E + live]))

    for _ in range(cfg.loop.pg_iters):
        Ti = poses[ci]
        Tj = poses[cj]
        r = _edge_residual(edges.t_meas, Ti, Tj)                # [E, 6]
        Ji, Jj = edge_jacobians(Ti, Tj, edges.t_meas)           # [E, 6, 6] x2

        # Assemble dense H and b by block sums.
        J = (Ji, Jj)
        b = _block_sum(torch.cat([-torch.einsum("eri,e,er->ei", Ja, w, r)
                                  for Ja in J]), b_plan, K)
        H = _block_sum(torch.cat([torch.einsum("eri,e,erj->eij", Ja, w, Jb)
                                  for Ja in J for Jb in J]),
                       h_plan, K * K).reshape(K, K, 6, 6)

        Hf = H.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
        Hf = Hf * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        bf = b.reshape(K * 6) * m
        Hf = Hf + 1e-6 * eye + 1e-3 * torch.diag(torch.diagonal(Hf))
        dx = robust.cho_solve(Hf, bf)
        dx = dx.reshape(K, 6) * free[:, None]
        dx = torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)  # skip bad solves
        poses = se3.retract(poses, dx)
    return poses


def apply_pose_correction(cfg: SlamConfig, state: MapState, new_poses):
    """Move every map point rigidly with its reference keyframe after a
    pose-graph update: X' = T_wc_new(ref) · T_cw_old(ref) · X."""
    K = state.kf_pose.shape[0]
    ref = torch.clamp(state.pt_ref_kf, 0, K - 1).long()
    corr = se3.pose_compose(se3.pose_inv(new_poses[ref]), state.kf_pose[ref])
    xyz = se3.pose_apply(corr, state.pt_xyz)
    # Points must move with a live keyframe.
    move = state.pt_valid & state.kf_valid[ref]
    xyz = torch.where(move[:, None], xyz, state.pt_xyz)
    return state._replace(kf_pose=new_poses, pt_xyz=xyz)


def fuse_loop_points(cfg: SlamConfig, state: MapState, kf_cur, kf_cand,
                     match_idx, match_ok) -> MapState:
    """Fuse duplicated map points across a verified loop: matched keypoint
    pairs (cur slot i, cand slot j) observing different points merge them
    (the loop side's point survives), and an unbound slot on either side
    gains the other side's observation.  Scatters with duplicate indices
    keep the last write, as the reference's sequential scatter does."""
    K, N = state.kf_obs_pt.shape
    P = state.pt_xyz.shape[0]
    dev = state.kf_obs_pt.device
    j = torch.clamp(match_idx, 0, N - 1).long()
    row_cur = at(state.kf_obs_pt, kf_cur)            # [N] point of cur slot i
    pt_cand = at(state.kf_obs_pt, kf_cand)[j]        # [N] point of matched cand slot
    ok = match_ok & (match_idx >= 0)

    # Merge: cur's point -> cand's (older, loop-side) point.
    both = ok & (row_cur >= 0) & (pt_cand >= 0) & (row_cur != pt_cand)
    src = torch.where(both, row_cur, P)
    remap = torch.cat([torch.arange(P, dtype=torch.int32, device=dev),
                       torch.full((1,), -1, dtype=torch.int32, device=dev)])
    src_c = torch.clamp(src, 0, P).long()
    vals = torch.where(src < P, pt_cand, remap[src_c])
    writer = last_writer(src_c, P + 1)
    remap = torch.where(writer >= 0, vals[torch.clamp(writer, min=0)], remap)
    remap = torch.cat([remap[torch.clamp(remap[:P], 0, P).long()], remap[P:]])
    obs = torch.where(state.kf_obs_pt >= 0,
                      remap[torch.clamp(state.kf_obs_pt, 0, P).long()], -1)
    merged_away = remap[:P] != torch.arange(P, device=dev)

    # Bind unassociated slots to the other side's (post-remap) point.
    row_cur = at(obs, kf_cur)
    pt_cand_new = torch.where(pt_cand >= 0,
                              remap[torch.clamp(pt_cand, 0, P).long()], -1)
    bind_cur = ok & (row_cur < 0) & (pt_cand_new >= 0)
    obs = set_at(obs, kf_cur, torch.where(bind_cur, pt_cand_new, row_cur))
    row_cand = at(obs, kf_cand)
    cur_pt_new = at(obs, kf_cur)
    give = ok & (row_cand[j] < 0) & (cur_pt_new >= 0)
    tgt = torch.where(give, j, N)
    writer = last_writer(tgt, N + 1)[:N]
    row_cand = torch.where(writer >= 0,
                           torch.where(give, cur_pt_new, -1)[torch.clamp(writer, min=0)],
                           row_cand)
    obs = set_at(obs, kf_cand, row_cand)

    st = state._replace(kf_obs_pt=obs, pt_valid=state.pt_valid & ~merged_away)
    return recompute_covis(st)


def add_loop_edge(state: MapState, kf_i, kf_j, t_rel) -> MapState:
    """Record a verified loop edge (measured T_i · T_j^-1)."""
    n = state.n_loop_edges
    cap = state.loop_edges.shape[0]
    slot = torch.clamp_max(n, cap - 1)
    edge = torch.stack([torch.as_tensor(kf_i), torch.as_tensor(kf_j)]).to(
        device=state.loop_edges.device, dtype=torch.int32)
    return state._replace(
        loop_edges=set_at(state.loop_edges, slot, edge),
        loop_rel=set_at(state.loop_rel, slot, t_rel),
        n_loop_edges=torch.clamp_max(n + 1, cap),
    )


def close_loop_update(cfg: SlamConfig, state: MapState, kf_id, cand, t_rel,
                      match_idx, match_ok):
    """The whole loop correction: fuse duplicated points, record the loop
    edge, rigidly move the current keyframe to satisfy it, optimize the
    essential graph, propagate the correction to map points.

    Returns (MapState, corrected kf pose [7])."""
    state = fuse_loop_points(cfg, state, kf_id, cand, match_idx, match_ok)
    state = add_loop_edge(state, kf_id, cand, t_rel)
    edges = build_essential_edges(cfg, state)
    corrected = se3.pose_compose(t_rel, at(state.kf_pose, cand))
    init = set_at(state.kf_pose, kf_id, corrected)
    K = init.shape[0]
    fixed = torch.zeros(K, dtype=torch.bool, device=init.device)
    fixed[0] = True
    fixed = set_at(fixed, cand, True)
    new_poses = optimize_pose_graph(cfg, init, state.kf_valid, edges, fixed)
    state = apply_pose_correction(cfg, state, new_poses)
    return state, at(state.kf_pose, kf_id)
