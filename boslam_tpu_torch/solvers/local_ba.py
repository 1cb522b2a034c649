"""Local bundle adjustment over the covisibility window, Schur-complement
damped Gauss-Newton (``boslam_tpu.solvers.local_ba``): inline
(``local_bundle_adjustment``, solve and write back) or deferred
(``deferred_local_ba`` solves on a snapshot, ``merge_local_ba`` lands the
result later under per-entry identity guards).  On a card both replay a
CUDA graph of the solve (``SolveGraph``): the inline one shared by the
process's engines of one configuration, the deferred one an engine's own.

Static window: N_OPT optimized + N_FIX fixed cameras and a compacted active
landmark set of MAX_LOCAL points.  The edge set is one possible edge per
(window camera, local point), so it lives as a dense [C, L] grid: every
normal-equation block is an einsum over the grid, the Schur reduction
``S = H_cc - sum_p A H_pp^-1 A^T`` is two einsums, and the reduced camera
system is a dense (N_OPT*6)^2 Cholesky.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.geometry import camera as cam_mod
from boslam_tpu_torch.geometry import se3
from boslam_tpu_torch.mapping.map_state import MapState
from boslam_tpu_torch.ops.build import LAUNCHES
from boslam_tpu_torch.solvers import robust as robust_mod
from boslam_tpu_torch.solvers.ba_core import inv3x3
from boslam_tpu_torch.utils.tensor_ops import (
    last_writer, nonzero_static, set_drop, top_k,
)


class LocalBaStats(NamedTuple):
    cost0: torch.Tensor
    cost1: torch.Tensor
    n_edges: torch.Tensor
    n_points: torch.Tensor


def _select_window(cfg: SlamConfig, state: MapState, center):
    """(opt_ids [KO], opt_mask, opt_cam_mask, fix_ids [KF], fix_mask)."""
    KO = cfg.local_ba.n_opt_kf
    KF_ = cfg.local_ba.n_fixed_kf
    K = state.covis.shape[0]
    dev = state.covis.device
    ar = torch.arange(K, device=dev)
    center = center.long().reshape(1)
    row = state.covis[center][0] * state.kf_valid
    row = torch.where(ar == center, 0, row)
    w, ids = top_k(row, KO - 1)
    opt_ids = torch.cat([center, ids])
    opt_mask = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), w > 0])
    opt_mask = opt_mask & state.kf_valid[opt_ids]
    # Keyframe 0 anchors the gauge: never optimized.
    opt_cam_mask = opt_mask & (opt_ids != 0)

    # Fixed ring: most covisible with the window, not already in it.
    in_opt = torch.zeros(K + 1, dtype=torch.bool, device=dev)
    # index_fill_ takes its value as a kernel argument: an advanced-index
    # assignment of a Python scalar copies it from the host (a stream
    # synchronization, and an error under CUDA-graph capture).
    in_opt.index_fill_(0, torch.where(opt_mask, opt_ids, K), True)
    in_opt = in_opt[:K] | (ar == opt_ids[0])
    ring = torch.sum(state.covis[opt_ids] * opt_mask[:, None], dim=0) * state.kf_valid
    ring = torch.where(in_opt, 0, ring)
    wf, fix_ids = top_k(ring, KF_)
    fix_mask = (wf > 0) & state.kf_valid[fix_ids]
    return opt_ids, opt_mask, opt_cam_mask, fix_ids, fix_mask


class DenseEdges(NamedTuple):
    """Dense [C, L] edge grid: one (possible) edge per window camera x
    local point."""

    uv: torch.Tensor        # [C, L, 2] measured pixels
    depth: torch.Tensor     # [C, L] measured keypoint depth (0 = none)
    has_depth: torch.Tensor # [C, L] bool
    info: torch.Tensor      # [C, L] per-octave information weight
    valid: torch.Tensor     # [C, L] bool


def _build_problem(cfg: SlamConfig, state: MapState, center):
    """Compacted cameras, points, and the dense [C, L] edge grid."""
    L = cfg.local_ba.max_local_points
    P = state.pt_xyz.shape[0]
    dev = state.pt_xyz.device
    opt_ids, opt_mask, opt_cam_mask, fix_ids, fix_mask = _select_window(
        cfg, state, center
    )
    cam_ids = torch.cat([opt_ids, fix_ids])                 # [C]
    cam_mask = torch.cat([opt_mask, fix_mask])
    poses = state.kf_pose[cam_ids]

    # Active points: observed by the optimized window.
    obs_opt = state.kf_obs_pt[opt_ids]                      # [KO, N]
    obs_opt = torch.where((obs_opt >= 0) & opt_mask[:, None], obs_opt, P)
    active = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    active.index_fill_(0, obs_opt.reshape(-1).long(), True)
    active = active[:P] & state.pt_valid
    local_ids = nonzero_static(active, L, P)                # [L] -> global
    slot_used = local_ids < P
    inv = torch.full((P + 1,), -1, dtype=torch.int64, device=dev)
    inv[torch.clamp(local_ids, 0, P)] = torch.where(
        slot_used, torch.arange(L, device=dev), -1)
    pts = state.pt_xyz[torch.clamp(local_ids, 0, P - 1)]    # [L, 3]

    # Invert each camera's observation row into pt_slot[c, l] = keypoint
    # slot of local point l in camera c (-1 if unobserved).  A point seen
    # twice by one camera keeps its last slot, as a sequential scatter does.
    C, N = cam_ids.shape[0], state.kf_obs_pt.shape[1]
    obs = state.kf_obs_pt[cam_ids]                          # [C, N]
    pl = inv[torch.clamp(obs, 0, P).long()]                 # [C, N] local pt
    ok = (
        (obs >= 0)
        & (pl >= 0)
        & cam_mask[:, None]
        & state.kf_kp_valid[cam_ids]
    )
    tgt = torch.where(ok, pl, L)
    flat = (torch.arange(C, device=dev)[:, None] * (L + 1) + tgt).reshape(-1)
    writer = last_writer(flat, C * (L + 1)).reshape(C, L + 1)
    pt_slot = torch.where(writer >= 0, writer % N, -1)[:, :L]  # [C, L]
    has_e = (pt_slot >= 0) & slot_used[None, :]
    sl = torch.clamp(pt_slot, 0, N - 1)                     # [C, L]
    uv = torch.gather(state.kf_uv[cam_ids], 1, sl[..., None].expand(C, L, 2))
    depth = torch.gather(state.kf_depth[cam_ids], 1, sl)
    octave = torch.gather(state.kf_octave[cam_ids], 1, sl)
    edges = DenseEdges(
        uv=uv,
        depth=depth,
        has_depth=(depth > 0) & has_e,
        info=robust_mod.octave_inv_sigma2(octave, cfg.orb.scale_factor),
        valid=has_e,
    )
    return (
        cam_ids, cam_mask, opt_cam_mask, poses, local_ids, slot_used, pts, edges
    )


def _dense_residuals(cfg: SlamConfig, poses, pts, edges: DenseEdges):
    """Residuals r [C, L, 3] + Jacobians (J_cam [C, L, 3, 6],
    J_pt [C, L, 3, 3]) on the dense grid."""
    cam = cfg.camera
    w_d = cfg.tracker.depth_weight
    xc = se3.pose_apply(poses[:, None, :], pts[None, :, :])   # [C, L, 3]
    uv_pred = cam_mod.project(cam, xc)
    r_uv = uv_pred - edges.uv
    r_z = torch.where(edges.has_depth, w_d * (xc[..., 2] - edges.depth), 0.0)
    r = torch.cat([r_uv, r_z[..., None]], dim=-1)             # [C, L, 3]

    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(xc.shape[:-1] + (3, 3))
    dxc_dxi = torch.cat([-se3.hat(xc), eye], dim=-1)          # [C, L, 3, 6]
    Jp2 = cam_mod.project_jacobian(cam, xc)                   # [C, L, 2, 3]
    R = se3.quat_to_mat(poses[:, None, :4])                   # [C, 1, 3, 3]
    zsel = edges.has_depth[..., None, None]
    J_cam = torch.cat(
        [Jp2 @ dxc_dxi, torch.where(zsel, w_d * dxc_dxi[..., 2:3, :], 0.0)],
        dim=-2,
    )                                                         # [C, L, 3, 6]
    J_pt = torch.cat(
        [Jp2 @ R, torch.where(zsel, w_d * R[..., 2:3, :], 0.0)], dim=-2
    )                                                         # [C, L, 3, 3]

    bad = (xc[..., 2] <= 1e-3) | ~edges.valid
    r = torch.where(bad[..., None], 0.0, r)
    J_cam = torch.where(bad[..., None, None], 0.0, J_cam)
    J_pt = torch.where(bad[..., None, None], 0.0, J_pt)
    return r, J_cam, J_pt


def _dense_cost(cfg: SlamConfig, poses, pts, edges: DenseEdges, delta):
    cam = cfg.camera
    w_d = cfg.tracker.depth_weight
    xc = se3.pose_apply(poses[:, None, :], pts[None, :, :])
    uv_pred = cam_mod.project(cam, xc)
    r_uv = uv_pred - edges.uv
    r_z = torch.where(edges.has_depth, w_d * (xc[..., 2] - edges.depth), 0.0)
    chi2 = (torch.sum(r_uv * r_uv, -1) + r_z * r_z) * edges.info
    ok = edges.valid & (xc[..., 2] > 1e-3)
    return torch.sum(torch.where(ok, robust_mod.huber_cost(chi2, delta), 0.0))


def _lm_solve_step(cfg: SlamConfig, poses, pts, edges: DenseEdges,
                   opt_cam_mask, lam):
    """One damped Schur solve: returns (dxi [KO, 6] for opt cams, dpt [L, 3])."""
    KO = cfg.local_ba.n_opt_kf
    delta = cfg.local_ba.huber_delta
    dev = pts.device
    r, J_cam, J_pt = _dense_residuals(cfg, poses, pts, edges)
    chi2 = torch.sum(r * r, dim=-1) * edges.info              # [C, L]
    w = robust_mod.huber_weight(chi2, delta) * edges.info
    w = torch.where(edges.valid, w, 0.0)
    sw = torch.sqrt(w)[..., None]                             # [C, L, 1]

    cam_sel = opt_cam_mask[:KO].to(torch.float32)
    Gc = J_cam[:KO] * (sw[:KO, :, None] * cam_sel[:, None, None, None])
    Gp = J_pt * sw[..., None]                                 # [C, L, 3, 3]
    rw = r * sw                                               # [C, L, 3]

    Hcc = torch.einsum("clri,clrj->cij", Gc, Gc)              # [KO, 6, 6]
    bc = -torch.einsum("clri,clr->ci", Gc, rw[:KO])           # [KO, 6]
    Hpp = torch.einsum("clri,clrj->lij", Gp, Gp)              # [L, 3, 3]
    bp = -torch.einsum("clri,clr->li", Gp, rw)                # [L, 3]
    A = torch.einsum("clri,clrj->lcij", Gc, Gp[:KO])          # [L, KO, 6, 3]

    # Marquardt damping.
    eye3 = torch.eye(3, device=dev)
    Hpp_d = Hpp + lam * (eye3 * torch.clamp(
        torch.diagonal(Hpp, dim1=-2, dim2=-1), min=1e-6
    )[..., None, :] * eye3) + 1e-8 * eye3
    Hpp_inv = inv3x3(Hpp_d)

    # Schur reduction.
    M = torch.einsum("pkis,pst->pkit", A, Hpp_inv)            # [L, KO, 6, 3]
    S_cross = torch.einsum("pait,pbjt->aibj", M, A)           # [KO, 6, KO, 6]
    eye_ko = torch.eye(KO, device=dev)
    S = torch.einsum("ab,aij->aibj", eye_ko, Hcc) - S_cross
    b_s = bc - torch.einsum("pait,pt->ai", M, bp)             # [KO, 6]

    D = KO * 6
    S = S.reshape(D, D)
    b_s = b_s.reshape(D)
    # Mask out non-optimized camera rows/cols (identity rows).
    m = torch.repeat_interleave(opt_cam_mask.to(torch.float32), 6, output_size=D)
    S = S * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    b_s = b_s * m
    diagS = torch.clamp(torch.diagonal(S), min=1e-6)
    eye_d = torch.eye(D, device=dev)
    S = S + lam * torch.diag(diagS) * eye_d
    dxi = robust_mod.cho_solve(S + 1e-7 * eye_d, b_s).reshape(KO, 6)
    dxi = dxi * opt_cam_mask[:, None]

    # Back-substitute points.
    dpt = torch.einsum(
        "pst,pt->ps", Hpp_inv, bp - torch.einsum("pait,ai->pt", A, dxi),
    )
    # A non-finite solve must not poison the state: skip the step instead.
    finite = torch.all(torch.isfinite(dxi)) & torch.all(torch.isfinite(dpt))
    return torch.where(finite, dxi, 0.0), torch.where(finite, dpt, 0.0)


def _solve_local_ba(cfg: SlamConfig, state: MapState, center):
    """Build the window problem around ``center`` and run the LM/GN loop.
    Returns (opt_ids [KO], opt_cam_mask, opt_poses [KO, 7], local_ids [L],
    slot_used, pts [L, 3], stats)."""
    lb = cfg.local_ba
    KO = lb.n_opt_kf
    (cam_ids, cam_mask, opt_cam_mask, poses, local_ids, slot_used, pts,
     edges) = _build_problem(cfg, state, center)

    cost0 = _dense_cost(cfg, poses, pts, edges, lb.huber_delta)

    if lb.lm_accept_reject:
        # Classic LM: trial-point cost per iteration, accept/reject.
        lam = torch.full((), lb.lm_lambda0, device=pts.device)
        cost = cost0
        for _ in range(lb.lm_iters):
            dxi, dpt = _lm_solve_step(cfg, poses, pts, edges, opt_cam_mask, lam)
            new_poses = torch.cat([se3.retract(poses[:KO], dxi), poses[KO:]])
            new_pts = pts + dpt
            new_cost = _dense_cost(cfg, new_poses, new_pts, edges, lb.huber_delta)
            accept = new_cost < cost
            poses = torch.where(accept, new_poses, poses)
            pts = torch.where(accept, new_pts, pts)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e3)
            cost = torch.minimum(new_cost, cost)
    else:
        # Damped GN: fixed geometric lambda schedule, every step taken.
        lams = lb.lm_lambda0 * (
            lb.lm_lambda_decay ** torch.arange(lb.lm_iters, device=pts.device,
                                               dtype=torch.float32))
        for it in range(lb.lm_iters):
            dxi, dpt = _lm_solve_step(cfg, poses, pts, edges, opt_cam_mask,
                                      lams[it])
            poses = torch.cat([se3.retract(poses[:KO], dxi), poses[KO:]])
            pts = pts + dpt

    cost1 = _dense_cost(cfg, poses, pts, edges, lb.huber_delta)

    stats = LocalBaStats(
        cost0=cost0,
        cost1=cost1,
        n_edges=torch.sum(edges.valid).to(torch.int32),
        n_points=torch.sum(slot_used).to(torch.int32),
    )
    return (
        cam_ids[:KO], opt_cam_mask, poses[:KO], local_ids, slot_used, pts,
        stats,
    )


def inline_local_ba(cfg: SlamConfig, state: MapState, center):
    """The inline solve, eagerly: local BA around keyframe ``center`` with
    its write-back, as (kf_pose [K, 7], pt_xyz [P, 3], stats) of the whole
    map."""
    K = state.kf_pose.shape[0]
    P = state.pt_xyz.shape[0]
    opt_ids, opt_cam_mask, opt_poses, local_ids, slot_used, pts, stats = (
        _solve_local_ba(cfg, state, center)
    )
    kf_pose = torch.cat([state.kf_pose, state.kf_pose[:1]])
    kf_pose[torch.where(opt_cam_mask, opt_ids, K)] = opt_poses
    pt_xyz = torch.cat([state.pt_xyz, state.pt_xyz[:1]])
    pt_xyz[torch.where(slot_used, local_ids, P)] = pts
    return kf_pose[:K], pt_xyz[:P], stats


def local_bundle_adjustment(cfg: SlamConfig, state: MapState, center):
    """Run local BA around keyframe ``center``; returns (MapState, stats)
    with the optimized poses and points written back.  On a card the solve
    replays the process's CUDA graph for ``cfg`` and the map's shapes
    (``inline_graph``); on the CPU it runs eagerly."""
    solve = inline_graph(cfg, state) or functools.partial(inline_local_ba, cfg)
    kf_pose, pt_xyz, stats = solve(state, center)
    return state._replace(kf_pose=kf_pose, pt_xyz=pt_xyz), stats


class DeferredBaResult(NamedTuple):
    """Output of a deferred local-BA solve (the reference's local-mapping
    thread as a second in-flight computation): optimized poses and points
    plus the identity guards that let them merge into a map that has
    advanced since the snapshot.

    ``opt_seq`` is kf_seq at snapshot time (a keyframe slot is reused after
    a cull, and a changed seq means another keyframe lives there);
    ``pt_gen`` is pt_first_kf, which identifies a point slot's tenant."""

    opt_ids: torch.Tensor    # [KO] i32 optimized keyframe slots
    opt_mask: torch.Tensor   # [KO] bool
    opt_pose: torch.Tensor   # [KO, 7] optimized T_cw
    opt_seq: torch.Tensor    # [KO] i32 kf_seq guard
    pt_ids: torch.Tensor     # [L] i64 global point slots (P = unused)
    pt_used: torch.Tensor    # [L] bool
    pt_xyz: torch.Tensor     # [L, 3] optimized positions
    pt_gen: torch.Tensor     # [L] i32 pt_first_kf guard
    stats: LocalBaStats


def deferred_local_ba(cfg: SlamConfig, state: MapState, center):
    """Solve local BA around ``center`` without writing back; the result
    merges into the (by then advanced) map through ``merge_local_ba``."""
    P = state.pt_xyz.shape[0]
    opt_ids, opt_cam_mask, opt_poses, local_ids, slot_used, pts, stats = (
        _solve_local_ba(cfg, state, center)
    )
    ids_c = torch.clamp(local_ids, 0, P - 1)
    return DeferredBaResult(
        opt_ids=opt_ids,
        opt_mask=opt_cam_mask,
        opt_pose=opt_poses,
        opt_seq=state.kf_seq[opt_ids.long()],
        pt_ids=local_ids,
        pt_used=slot_used,
        pt_xyz=pts,
        pt_gen=state.pt_first_kf[ids_c],
        stats=stats,
    )


def merge_local_ba(cfg: SlamConfig, state: MapState,
                   res: DeferredBaResult) -> MapState:
    """Merge a deferred local-BA result into the current map.

    A keyframe pose lands only if its slot still holds the same keyframe
    (valid, kf_seq unchanged); a point only if its slot still holds the
    same point (valid, pt_first_kf unchanged).  Entries culled or reused
    since the snapshot are skipped."""
    K = state.kf_pose.shape[0]
    P = state.pt_xyz.shape[0]
    kid = res.opt_ids.long()
    kf_ok = res.opt_mask & state.kf_valid[kid] & (state.kf_seq[kid] == res.opt_seq)
    kf_pose = set_drop(state.kf_pose, torch.where(kf_ok, kid, K), res.opt_pose)
    ids_c = torch.clamp(res.pt_ids, 0, P - 1)
    pt_ok = (res.pt_used & state.pt_valid[ids_c]
             & (state.pt_first_kf[ids_c] == res.pt_gen))
    pt_xyz = set_drop(state.pt_xyz, torch.where(pt_ok, res.pt_ids, P), res.pt_xyz)
    return state._replace(kf_pose=kf_pose, pt_xyz=pt_xyz)


# The map arrays the solve reads: a graph copies only these in.  The
# deferred solve's guards read two more.
SOLVE_FIELDS = ("kf_pose", "pt_xyz", "covis", "kf_valid", "kf_obs_pt",
                "pt_valid", "kf_kp_valid", "kf_uv", "kf_depth", "kf_octave")
DEFERRED_FIELDS = SOLVE_FIELDS + ("kf_seq", "pt_first_kf")


def solve_inputs(state: MapState, fields) -> MapState:
    """A copy of ``state``'s ``fields``, every other field left empty (a
    solve that read one would fail)."""
    return MapState(*(t.clone() if name in fields else t.new_empty(0)
                      for name, t in zip(MapState._fields, state)))


def _clone(out):
    """A copy of a (nested) tuple of tensors."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    parts = [_clone(v) for v in out]
    return type(out)(*parts) if hasattr(out, "_fields") else tuple(parts)


class SolveGraph:
    """A local-BA solve ``fn(cfg, state, center)`` captured once in a CUDA
    graph and replayed.

    Eager, the solve enqueues several hundred small operations, which costs
    the host tens of ms per keyframe event; a replay costs the copies of
    the map's ``fields`` (those the solve reads) into the graph's static
    inputs, one launch and the copies of its outputs, which the caller
    keeps while the next replay overwrites the graph's buffers.  All
    shapes are static in ``cfg``, so one capture serves every solve of a
    map of the same shapes.  Replay it on one stream at a time: every
    caller shares the static buffers.  ``ops.build.LAUNCHES`` counts
    captures (``local_ba_capture``) and replays (``local_ba_graph``)."""

    def __init__(self, fn, cfg: SlamConfig, state: MapState, fields):
        self.fields = fields
        dev = state.kf_pose.device
        self.static = solve_inputs(state, fields)
        self.center = torch.zeros((), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            # One eager solve first: it creates the cuBLAS / cuSOLVER
            # handles and workspaces, which a capture cannot.
            fn(cfg, self.static, self.center)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = fn(cfg, self.static, self.center)
        LAUNCHES["local_ba_capture"] += 1

    def __call__(self, state: MapState, center):
        for name in self.fields:
            getattr(self.static, name).copy_(getattr(state, name))
        self.center.copy_(center)
        self.graph.replay()
        LAUNCHES["local_ba_graph"] += 1
        return _clone(self.out)


def graph_key(cfg: SlamConfig, state: MapState, fields) -> tuple:
    """Every value a capture of the solve over ``state``'s ``fields``
    bakes in: the intrinsics, the octave scale, the depth weight, the
    whole ``local_ba`` section, TF32's switch and the fields' shapes,
    dtypes and device."""
    cam = cfg.camera
    arrays = tuple((tuple(t.shape), t.dtype, t.device)
                   for t in (getattr(state, name) for name in fields))
    return ((cam.fx, cam.fy, cam.cx, cam.cy), cfg.orb.scale_factor,
            cfg.tracker.depth_weight, cfg.local_ba,
            torch.backends.cuda.matmul.allow_tf32, arrays)


# One inline graph per configuration and device for the process: the
# engines of one configuration share it, so a fresh engine pays no capture.
_INLINE_GRAPHS: dict = {}


def inline_graph(cfg: SlamConfig, state: MapState) -> SolveGraph | None:
    """The inline solve's graph for ``cfg`` and ``state``'s shapes,
    captured at its first call; None for a map on the CPU."""
    if state.kf_pose.device.type != "cuda":
        return None
    key = graph_key(cfg, state, SOLVE_FIELDS)
    graph = _INLINE_GRAPHS.get(key)
    if graph is None:
        graph = _INLINE_GRAPHS[key] = SolveGraph(inline_local_ba, cfg, state,
                                                 SOLVE_FIELDS)
    return graph


class DeferredBaGraph(SolveGraph):
    """``deferred_local_ba`` captured once for an engine's async mapping
    and replayed on the stream its solves run on (the capture itself runs
    on a side stream of its own, after a device synchronization)."""

    def __init__(self, cfg: SlamConfig, state: MapState):
        super().__init__(deferred_local_ba, cfg, state, DEFERRED_FIELDS)
