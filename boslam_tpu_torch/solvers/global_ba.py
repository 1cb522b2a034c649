"""Global bundle adjustment: all keyframes + all landmarks, matrix-free PCG
(``boslam_tpu.solvers.global_ba``).

At global scale the reduced camera system outgrows a dense factorization,
so the Schur complement is applied matrix-free inside preconditioned
conjugate gradient:

    S x = (H_cc + lam D) x - W H_pp^-1 W^T x

Both reduction directions follow the edge list's layout, with no scatter:

- camera side: the global edge list is the flattened ``[K, N]`` keypoint
  table (one edge per keyframe x keypoint slot), so a camera reduction is a
  reshape and a dense sum over the N axis;
- point side: edges are sorted by point id once per solve (a stable sort,
  as the reference's), and a point reduction is a two-level cumsum plus
  two boundary gathers.  Float atomics (``index_add_``) would add in an
  order that changes from run to run; the sorted order is the reference's.

The CG loop exits on a relative-residual tolerance under a cap of
iterations; the port reads that condition on the host once per iteration,
each read counted by a ``HostSync``.  The LM loop keeps its accept flag,
damping and cost on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.geometry import se3
from boslam_tpu_torch.mapping.map_state import MapState
from boslam_tpu_torch.solvers import ba_core
from boslam_tpu_torch.solvers import robust as robust_mod
from boslam_tpu_torch.solvers.ba_core import BaEdges
from boslam_tpu_torch.tracking.tracker import HostSync


class GlobalBaStats(NamedTuple):
    cost0: torch.Tensor
    cost1: torch.Tensor
    n_edges: torch.Tensor
    pcg_steps: tuple  # CG iterations taken in each LM iteration (host ints)


def build_global_edges(cfg: SlamConfig, state: MapState) -> BaEdges:
    """Every (keyframe, keypoint-slot) observation is an edge; cameras are
    global keyframe ids, points are global point ids.  The edge order is
    the row-major flattened ``[K, N]`` table (``cam[e] == e // N``), which
    the solver uses for scatter-free camera reductions."""
    K, N = state.kf_obs_pt.shape
    P = state.pt_xyz.shape[0]
    dev = state.kf_obs_pt.device
    obs = state.kf_obs_pt
    pt = torch.clamp(obs, 0, P - 1)
    valid = (
        (obs >= 0)
        & state.kf_valid[:, None]
        & state.kf_kp_valid
        & state.pt_valid[pt.long()]
    )
    cam_idx = torch.arange(K, dtype=torch.int32, device=dev)[:, None].expand(K, N)
    depth = state.kf_depth.reshape(-1)
    return BaEdges(
        cam=cam_idx.reshape(-1),
        pt=pt.reshape(-1),
        uv=state.kf_uv.reshape(-1, 2),
        depth=depth,
        has_depth=(depth > 0) & valid.reshape(-1),
        info=robust_mod.octave_inv_sigma2(
            state.kf_octave.reshape(-1), cfg.orb.scale_factor
        ),
        valid=valid.reshape(-1),
    )


class _PtSchedule(NamedTuple):
    """Point-reduction schedule: edge permutation sorting by point id
    (invalid edges at the end) + per-point [start, end) ranges."""

    perm: torch.Tensor       # [E] i64 camera-order index of the e-th sorted edge
    inv_perm: torch.Tensor   # [E] i64 sorted position of the e-th camera-order edge
    pt_sorted: torch.Tensor  # [E] i64 point id per sorted edge (P = invalid)
    starts: torch.Tensor     # [P] i64
    ends: torch.Tensor       # [P] i64


def _point_schedule(edges: BaEdges, P: int) -> _PtSchedule:
    seg = torch.where(edges.valid, edges.pt.long(), P)
    # Stable, as jnp.argsort: ties keep camera order, which fixes the
    # summation order inside each point's segment.
    perm = torch.argsort(seg, stable=True)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(perm.shape[0], device=perm.device)
    pt_sorted = seg[perm]
    ar = torch.arange(P, device=seg.device)
    return _PtSchedule(
        perm=perm,
        inv_perm=inv_perm,
        pt_sorted=pt_sorted,
        starts=torch.searchsorted(pt_sorted, ar),
        ends=torch.searchsorted(pt_sorted, ar, right=True),
    )


_CS_BLOCK = 128  # two-level cumsum block length (see _point_sum_sorted)


def _point_sum_sorted(sched: _PtSchedule, vals_sorted):
    """Sorted segment sum by a two-level exclusive cumsum and boundary
    gathers.  ``vals_sorted``: [E, ...] in sorted edge order -> [P, ...].

    A single global f32 cumsum accumulates error with the running total
    (late segments lose up to ~0.5% at 131k edges).  The scan is split into
    ``_CS_BLOCK``-long blocks: a local cumsum per block plus an exclusive
    scan of block totals, and a segment sum is
    ``(off[be] - off[bs]) + (loc[e] - loc[s])``; for a segment inside one
    block the offset difference is exactly zero, and for adjacent blocks it
    is the one stored block total.
    """
    shape = vals_sorted.shape
    E = shape[0]
    flat = vals_sorted.reshape(E, -1)
    L = _CS_BLOCK
    pad = (-E) % L
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, flat.shape[1]))])
    B = flat.shape[0] // L
    blk = flat.reshape(B, L, -1)
    loc = torch.cumsum(blk, dim=1).reshape(B * L, -1)     # inclusive, local
    loc = torch.cat([torch.zeros_like(loc[:1]), loc])      # [B*L+1] exclusive view
    totals = blk.sum(dim=1)                                # [B, F]
    off = torch.cat(
        [torch.zeros_like(totals[:1]), torch.cumsum(totals, dim=0)]
    )                                                      # [B+1, F] exclusive

    def gather(idx):
        # The exclusive cumsum at idx in [0, E] is off[b] + loc[idx], b the
        # block of element idx - 1 (b <= B - 1 < B + 1; idx <= E < B*L + 1).
        b = torch.where(idx == 0, 0, torch.clamp(idx - 1, min=0) // L)
        return b, loc[idx]

    b_e, loc_e = gather(sched.ends)
    b_s, loc_s = gather(sched.starts)
    # Exact 0 for same-block segments, the single stored block total for
    # adjacent blocks; only segments spanning >= 3 blocks use the rounded
    # global prefix difference.
    off_diff = torch.where(
        (b_e == b_s)[:, None],
        0.0,
        torch.where(
            (b_e == b_s + 1)[:, None],
            totals[torch.clamp(b_s, max=B - 1)],
            off[b_e] - off[b_s],
        ),
    )
    out = off_diff + (loc_e - loc_s)
    return out.reshape((sched.starts.shape[0],) + shape[1:])


def _point_sum(sched: _PtSchedule, vals):
    """[E, ...] camera-order values -> [P, ...] per-point sums."""
    return _point_sum_sorted(sched, vals[sched.perm])


def _cam_sum(vals, K: int, N: int):
    """[E, ...] camera-order values -> [K, ...] per-camera sums (dense)."""
    return vals.reshape((K, N) + vals.shape[1:]).sum(dim=1)


def _damped(H, lam, eps):
    """H + lam * diag(max(diag(H), 1e-6)) + eps * I, batched."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    d = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-6)
    return H + lam * (eye * d[..., None, :]) + eps * eye


def _assemble(cfg: SlamConfig, poses, pts, edges, sched, opt_cam_mask, lam,
              delta, K, N):
    """Block terms for the matrix-free Schur operator (scatter-free)."""
    r, J_cam, J_pt = ba_core.edge_residuals(cfg, poses, pts, edges)
    w, _ = ba_core.robust_weights(cfg, r, edges, delta)
    Jc = torch.where(opt_cam_mask[edges.cam.long()][:, None, None], J_cam, 0.0)

    wr = w[:, None] * r
    Hcc = _cam_sum(torch.einsum("eri,erj->eij", Jc, w[:, None, None] * Jc), K, N)
    bc = -_cam_sum(torch.einsum("eri,er->ei", Jc, wr), K, N)
    Hpp = _point_sum(
        sched, torch.einsum("eri,erj->eij", J_pt, w[:, None, None] * J_pt)
    )
    bp = -_point_sum(sched, torch.einsum("eri,er->ei", J_pt, wr))

    Hpp_inv = ba_core.inv3x3(_damped(Hpp, lam, 1e-8))
    # Preconditioner: damped-Hcc block-Jacobi (the exact Schur diagonal
    # bought nothing over it in the reference's measurements).
    Hcc_d = _damped(Hcc, lam, 1e-7)

    # Sorted-order copies for the point-side half of each CG application.
    Jp_s = J_pt[sched.perm]
    Jc_s = Jc[sched.perm]
    w_s = w[sched.perm]
    return r, Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d, bc, Hpp_inv, bp


def _to_cameras(zp, Jp_s, Jc_s, w_s, sched, K, N):
    """Per-point [P, 3] values -> per-camera [K, 6] sums of
    w_e Jc_e^T Jp_e zp[pt(e)], gathered in sorted order."""
    P = zp.shape[0]
    ze = zp[torch.clamp(sched.pt_sorted, 0, P - 1)]
    ze = torch.where((sched.pt_sorted < P)[:, None], ze, 0.0)
    c = torch.einsum("erj,ej->er", Jp_s, ze) * w_s[:, None]
    d = torch.einsum("er,eri->ei", c, Jc_s)                 # [E, 6] sorted
    return _cam_sum(d[sched.inv_perm], K, N)


def _to_points(x, Jc, J_pt, w, sched, K, N):
    """Per-camera [K, 6] values -> per-point [P, 3] sums of
    w_e Jp_e^T Jc_e x[cam(e)] ([K, N] broadcast, no gather)."""
    Jc_kn = Jc.reshape(K, N, 3, 6)
    u = torch.einsum("knri,ki->knr", Jc_kn, x) * w.reshape(K, N)[..., None]
    b = torch.einsum("knr,knrj->knj", u, J_pt.reshape(K, N, 3, 3))
    return _point_sum(sched, b.reshape(-1, 3))


def _schur_matvec(x, Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d, Hpp_inv, edges,
                  sched, K, N):
    """y = S x, scatter-free: dense camera reduces + sorted point cumsum."""
    t = _to_points(x, Jc, J_pt, w, sched, K, N)             # [P, 3]
    z = torch.einsum("pst,pt->ps", Hpp_inv, t)              # [P, 3]
    y_cross = _to_cameras(z, Jp_s, Jc_s, w_s, sched, K, N)
    y_diag = torch.einsum("cij,cj->ci", Hcc_d, x)
    return y_diag - y_cross


def _pcg(matvec, b, Minv_blocks, iters: int, rtol: float = 1e-2,
         sync: HostSync | None = None):
    """Block-Jacobi preconditioned CG on the camera system ([C, 6] layout).

    ``iters`` is a cap: the loop exits once the residual norm has dropped
    below ``rtol`` of its start (inexact-Newton forcing), as the
    reference's ``lax.while_loop`` does.  The condition is read on the host
    before each iteration, each read counted by ``sync``.
    Returns (x, iterations taken)."""
    sync = HostSync() if sync is None else sync

    def apply_M(r):
        return torch.einsum("cij,cj->ci", Minv_blocks, r)

    x = torch.zeros_like(b)
    r = b
    z = apply_M(r)
    p = z
    tol = (rtol * rtol) * torch.sum(r * r)
    k = 0
    while k < iters and sync.flag(torch.sum(r * r) > tol):
        Ap = matvec(p)
        rz = torch.sum(r * z)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-12)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = apply_M(r_new)
        beta = torch.sum(r_new * z_new) / torch.clamp(rz, min=1e-12)
        p = z_new + beta * p
        r, z = r_new, z_new
        k += 1
    return x, k


def global_bundle_adjustment(cfg: SlamConfig, state: MapState,
                             lm_iters: int = 6, cg_iters: int = 40,
                             sync: HostSync | None = None):
    """Full-map BA; returns (MapState, GlobalBaStats).  KF0 fixed (gauge).
    ``sync`` counts the CG loop's host reads."""
    delta = cfg.local_ba.huber_delta
    C = state.kf_pose.shape[0]
    P = state.pt_xyz.shape[0]
    K, N = state.kf_obs_pt.shape
    dev = state.kf_pose.device
    edges = build_global_edges(cfg, state)
    sched = _point_schedule(edges, P)  # one sort, amortized over the solve
    opt_cam_mask = state.kf_valid & (torch.arange(C, device=dev) > 0)
    opt = opt_cam_mask[:, None]
    poses = state.kf_pose
    pts = state.pt_xyz
    cost0 = ba_core.robust_cost(cfg, poses, pts, edges, delta)

    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    cost = cost0
    steps = []
    for _ in range(lm_iters):
        r, Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d, bc, Hpp_inv, bp = _assemble(
            cfg, poses, pts, edges, sched, opt_cam_mask, lam, delta, K, N
        )
        # Right-hand side of the reduced system: bc - W Hpp^-1 bp.
        zb = torch.einsum("pst,pt->ps", Hpp_inv, bp)
        b_s = (bc - _to_cameras(zb, Jp_s, Jc_s, w_s, sched, K, N)) * opt

        Minv = _inv6x6(Hcc_d)

        def mv(x):
            x = x * opt
            y = _schur_matvec(x, Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d,
                              Hpp_inv, edges, sched, K, N)
            return y * opt + x * ~opt

        dxi, k = _pcg(mv, b_s, Minv, cg_iters, sync=sync)
        dxi = dxi * opt
        steps.append(k)
        # Back-substitute landmarks.
        t = _to_points(dxi, Jc, J_pt, w, sched, K, N)
        dpt = torch.einsum("pst,pt->ps", Hpp_inv, bp - t)

        new_poses = se3.retract(poses, dxi)
        new_pts = pts + dpt
        new_cost = ba_core.robust_cost(cfg, new_poses, new_pts, edges, delta)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        pts = torch.where(accept, new_pts, pts)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e3)
        cost = torch.minimum(new_cost, cost)

    new_state = state._replace(
        kf_pose=torch.where(opt, poses, state.kf_pose),
        pt_xyz=torch.where(state.pt_valid[:, None], pts, state.pt_xyz),
    )
    stats = GlobalBaStats(cost0, cost, torch.sum(edges.valid).to(torch.int32),
                          tuple(steps))
    return new_state, stats


def _inv6x6(M):
    """Batched 6x6 inverse (block-Jacobi preconditioner blocks), without
    the error check's host synchronization."""
    eye = torch.eye(6, dtype=M.dtype, device=M.device)
    return torch.linalg.inv_ex(M + 1e-6 * eye)[0]
