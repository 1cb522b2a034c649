"""Map-update operations: keyframe insertion, point creation, culling,
observation fusion, statistics — masked free-list updates on the MapState
tensors, the computation of ``boslam_tpu.mapping.map_ops``.

Every function returns a new MapState and leaves its input untouched.
"""

from __future__ import annotations

import torch

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.geometry import camera as cam_mod
from boslam_tpu_torch.geometry import se3
from boslam_tpu_torch.mapping.map_state import (
    MapState, free_kf_slot, latest_kf_slot, point_obs_count, recompute_covis,
)
from boslam_tpu_torch.matching import hamming
from boslam_tpu_torch.utils.tensor_ops import (
    add_drop, at, last_writer, nonzero_static, set_at, set_drop, top_k,
)


def _spanning_parent(state: MapState, slot) -> torch.Tensor:
    """Parent = most covisible OLDER keyframe (ORB-SLAM spanning tree).
    "Older" means inserted earlier (kf_seq), not a lower slot id."""
    seq = at(state.kf_seq, slot)
    row = at(state.covis, slot) * state.kf_valid
    older = (state.kf_seq >= 0) & (state.kf_seq < seq)
    row = torch.where(older, row, -1)
    parent = torch.argmax(row)
    return torch.where((seq > 0) & (at(row, parent) > 0), parent, -1).to(torch.int32)


def insert_keyframe(
    cfg: SlamConfig, state: MapState, feats, pose_cw, match_pt, match_ok, frame_idx
):
    """Insert the current frame as a keyframe.

    New map points are created directly from keypoint depth, allocated from
    the free list; when the pool is full the creation is dropped.  Returns
    (state, slot).  The caller gates insertion on a free slot existing.
    """
    N = feats.uv.shape[0]
    P = cfg.map.max_points
    slot, _ = free_kf_slot(state)

    obs = torch.where(match_ok & feats.valid & (match_pt >= 0), match_pt, -1)

    # ---- allocate new points for unmatched depth-backed keypoints -------
    create = feats.valid & feats.has_depth & (obs < 0)
    free_idx = nonzero_static(~state.pt_valid, N, P)
    rank = torch.cumsum(create.to(torch.int64), 0) - 1
    new_id = free_idx[torch.clamp(rank, 0, N - 1)]
    ok_create = create & (new_id < P)
    new_id = torch.where(ok_create, new_id, P)  # P = drop sentinel

    t_wc = se3.pose_inv(pose_cw)
    cam_w = t_wc[4:7]
    xyz_w = se3.pose_apply(t_wc[None], feats.xyz)
    # Viewing model: unit direction point -> camera, and the scale band
    # predicted from the creating keypoint's octave.
    dvec = cam_w[None, :] - xyz_w
    dist = torch.linalg.vector_norm(dvec, dim=-1)
    vdir = dvec / torch.clamp(dist, min=1e-9)[:, None]
    sf = cfg.orb.scale_factor
    dmax = dist * torch.pow(sf, feats.octave.to(torch.float32))
    dmin = dmax / sf ** (cfg.orb.n_levels - 1)
    slot_i = slot.to(torch.int32)
    st = state._replace(
        pt_xyz=set_drop(state.pt_xyz, new_id, xyz_w),
        pt_desc=set_drop(state.pt_desc, new_id, feats.desc),
        pt_angle=set_drop(state.pt_angle, new_id, feats.angle),
        pt_valid=set_drop(state.pt_valid, new_id, True),
        pt_ref_kf=set_drop(state.pt_ref_kf, new_id, slot_i),
        pt_first_kf=set_drop(state.pt_first_kf, new_id, state.n_kf),
        pt_n_vis=set_drop(state.pt_n_vis, new_id, 1),
        pt_n_found=set_drop(state.pt_n_found, new_id, 1),
        pt_dir_sum=set_drop(state.pt_dir_sum, new_id, vdir),
        pt_dmin=set_drop(state.pt_dmin, new_id, dmin),
        pt_dmax=set_drop(state.pt_dmax, new_id, dmax),
    )
    # Re-observed points accumulate this keyframe's viewing direction into
    # their mean-direction sum.
    reobs = torch.where(match_ok & feats.valid & (obs >= 0), obs, P).long()
    dvec_o = cam_w[None, :] - st.pt_xyz[torch.clamp(reobs, 0, P - 1)]
    vdir_o = dvec_o / torch.clamp(
        torch.linalg.vector_norm(dvec_o, dim=-1), min=1e-9
    )[:, None]
    st = st._replace(pt_dir_sum=add_drop(st.pt_dir_sum, reobs, vdir_o))

    obs = torch.where(ok_create, new_id, obs).to(torch.int32)

    # ---- write the keyframe row ----------------------------------------
    st = st._replace(
        kf_pose=set_at(st.kf_pose, slot, pose_cw),
        kf_valid=set_at(st.kf_valid, slot, True),
        kf_uv=set_at(st.kf_uv, slot, feats.uv),
        kf_depth=set_at(st.kf_depth, slot, feats.depth),
        kf_desc=set_at(st.kf_desc, slot, feats.desc),
        kf_octave=set_at(st.kf_octave, slot, feats.octave),
        kf_angle=set_at(st.kf_angle, slot, feats.angle),
        kf_kp_valid=set_at(st.kf_kp_valid, slot, feats.valid),
        kf_obs_pt=set_at(st.kf_obs_pt, slot, obs),
        kf_frame_idx=set_at(st.kf_frame_idx, slot, frame_idx),
        kf_seq=set_at(st.kf_seq, slot, st.n_kf),
        n_kf=st.n_kf + 1,
    )
    st = recompute_covis(st)
    st = st._replace(
        spanning_parent=set_at(st.spanning_parent, slot,
                                 _spanning_parent(st, slot))
    )
    return st, slot


def update_track_stats(cfg: SlamConfig, state: MapState, visible, match_pt, match_ok):
    """After tracking a frame: bump per-point visible/found counters."""
    P = cfg.map.max_points
    n_vis = state.pt_n_vis + visible.to(torch.int32)
    tgt = torch.where(match_ok & (match_pt >= 0), match_pt, P)
    n_found = add_drop(state.pt_n_found, tgt, 1)
    return state._replace(pt_n_vis=n_vis, pt_n_found=n_found)


def _drop_dead_obs(state: MapState) -> MapState:
    """Clear observation entries that point at dead points."""
    obs = state.kf_obs_pt
    P = state.pt_valid.shape[0]
    alive = (obs >= 0) & state.pt_valid[torch.clamp(obs, 0, P - 1).long()]
    return state._replace(kf_obs_pt=torch.where(alive, obs, -1))


def cull_points(cfg: SlamConfig, state: MapState, update_covis: bool = True) -> MapState:
    """Remove unreliable recent points: found-ratio < 0.25, or seen by < 3
    keyframes once mature."""
    m = cfg.map
    n_obs = point_obs_count(state)
    age = state.n_kf - state.pt_first_kf  # in keyframes
    found_ratio = state.pt_n_found / torch.clamp(state.pt_n_vis, min=1)
    bad_ratio = (found_ratio < m.cull_min_found_ratio) & (state.pt_n_vis >= 4)
    bad_obs = (n_obs < m.cull_min_obs) & (age >= 3)
    keep = state.pt_valid & ~bad_ratio & ~bad_obs
    st = state._replace(pt_valid=keep)
    st = _drop_dead_obs(st)
    return recompute_covis(st) if update_covis else st


def cull_one_keyframe(cfg: SlamConfig, state: MapState):
    """Cull the single most redundant keyframe, if any qualifies (>= 90% of
    its points seen in >= 3 other keyframes).  Root and the latest keyframe
    are protected.  Returns (MapState, cull_info [11] f32): [victim_slot
    (-1 = none), victim_seq, parent_slot, parent_seq, T_victim_parent(7)]."""
    K, N = state.kf_obs_pt.shape
    n_obs = point_obs_count(state)  # [P]
    obs = state.kf_obs_pt
    has = obs >= 0
    obs_cnt = torch.where(
        has, n_obs[torch.clamp(obs, 0, n_obs.shape[0] - 1).long()], 0
    )  # [K, N]
    redundant = torch.sum((obs_cnt >= 4) & has, dim=1)
    n_has = torch.sum(has, dim=1)
    frac = redundant / torch.clamp(n_has, min=1)
    ar = torch.arange(K, device=obs.device)
    eligible = (
        state.kf_valid
        & (state.kf_seq > 0)                      # root (seq 0) protected
        & (ar != latest_kf_slot(state))
        & (frac >= cfg.map.kf_cull_redundancy)
        & (n_has > 0)
    )
    victim = torch.argmax(torch.where(eligible, frac, -1.0))
    do = at(eligible, victim)
    return _remove_keyframe(state, victim, do)


def evict_for_slot(cfg: SlamConfig, state: MapState):
    """Capacity-saturation eviction: when every keyframe slot is occupied,
    evict the lowest-VALUE keyframe (minimal summed covisibility weight to
    the live window, ties toward the oldest).  Root, the latest keyframe and
    the live window are protected.  No-op (victim slot -1) while a free slot
    exists.  Same (state, cull_info[11]) contract as ``cull_one_keyframe``."""
    K = state.kf_valid.shape[0]
    ar = torch.arange(K, device=state.kf_valid.device)
    latest = latest_kf_slot(state)
    # Live window: latest + its strongest covisible neighbors.
    w_row = at(state.covis, latest) * state.kf_valid
    window = w_row >= max(cfg.map.covis_min_weight, 1)
    window = window | (ar == latest)
    # Value = how much a keyframe still shares with the live window.
    value = torch.sum(
        torch.where(window[None, :], state.covis, 0), dim=1
    ).to(torch.float32)
    eligible = (
        state.kf_valid
        & (state.kf_seq > 0)          # root (gauge anchor) protected
        & ~window                      # never evict the live window
        & (ar != latest)
    )
    # Small-pool fallback: only root and the latest stay untouchable.
    fallback = state.kf_valid & (state.kf_seq > 0) & (ar != latest)
    use = torch.where(torch.any(eligible), eligible, fallback)
    # Lexicographic (value, seq) in float32, rounded the way the reference
    # rounds it (one rounding of value * 1e6 + seq).
    score = (value.double() * 1e6 + state.kf_seq.double()).to(torch.float32)
    victim = torch.argmin(torch.where(use, score, float("inf")))
    do = torch.all(state.kf_valid) & at(use, victim)
    return _remove_keyframe(state, victim, do)


def _remove_keyframe(state: MapState, victim, do):
    """Shared removal for cull_one_keyframe / evict_for_slot: re-home points
    and spanning-tree children, invalidate touching loop edges, free the
    slot, and emit the [11] cull-chain record."""
    K = state.kf_valid.shape[0]
    ar = torch.arange(K, device=state.kf_valid.device)
    parent = at(state.spanning_parent, victim)
    parent = torch.where(
        (parent >= 0) & at(state.kf_valid, torch.clamp(parent, 0, K - 1)),
        parent, 0,
    ).to(torch.int32)
    new_ref = torch.where(do & (state.pt_ref_kf == victim), parent,
                          state.pt_ref_kf)
    new_sp = torch.where(do & (state.spanning_parent == victim), parent,
                         state.spanning_parent)
    new_sp = torch.where(do & (ar == victim), -1, new_sp)
    touches = do & (
        (state.loop_edges[:, 0] == victim) | (state.loop_edges[:, 1] == victim)
    )
    new_loop_edges = torch.where(touches[:, None], -1, state.loop_edges)
    st = state._replace(
        kf_valid=state.kf_valid & ~(do & (ar == victim)),
        kf_obs_pt=torch.where((do & (ar == victim))[:, None], -1,
                              state.kf_obs_pt),
        pt_ref_kf=new_ref,
        spanning_parent=new_sp,
        loop_edges=new_loop_edges,
    )
    t_vp = se3.pose_compose(at(state.kf_pose, victim),
                            se3.pose_inv(at(state.kf_pose, parent)))
    f32 = torch.float32
    cull_info = torch.cat([
        torch.stack([
            torch.where(do, victim, -1).to(f32),
            at(state.kf_seq, victim).to(f32),
            parent.to(f32),
            at(state.kf_seq, parent).to(f32),
        ]),
        t_vp,
    ])
    return recompute_covis(st), cull_info


def fuse_new_keyframe(
    cfg: SlamConfig, state: MapState, slot, n_neighbors: int = 4
) -> MapState:
    """Fuse keyframe ``slot``'s points into its covisible neighbors: project
    the new keyframe's points into each top-covisibility neighbor and
    Hamming-match them against its keypoints in a window; an unassociated
    matched keypoint gains an observation, and a keypoint bound to a
    different point merges the two (the better-observed point survives)."""
    K, N = state.kf_obs_pt.shape
    P = cfg.map.max_points
    dev = state.kf_obs_pt.device
    nbr_ids, nbr_w, nbr_ok = _top_neighbors(cfg, state, slot, n_neighbors)

    new_pts = at(state.kf_obs_pt, slot)  # [N] point ids of the new KF
    pts_ok = new_pts >= 0
    pid = torch.clamp(new_pts, 0, P - 1).long()
    xyz = state.pt_xyz[pid]
    desc = state.pt_desc[pid]
    n_obs = point_obs_count(state)

    obs_tab = state.kf_obs_pt
    remap = torch.cat([torch.arange(P, dtype=torch.int32, device=dev),
                       torch.full((1,), -1, dtype=torch.int32, device=dev)])
    for j in range(n_neighbors):
        nbr, ok_nb = nbr_ids[j], nbr_ok[j]
        pose = at(state.kf_pose, nbr)
        xc = se3.pose_apply(pose[None], xyz)
        uv = cam_mod.project(cfg.camera, xc)
        vis = (
            pts_ok
            & ok_nb
            & (xc[..., 2] > cfg.camera.depth_min)
            & cam_mod.in_image(cfg.camera, uv, 1.0)
        )
        kuv = at(state.kf_uv, nbr)
        kval = at(state.kf_kp_valid, nbr)
        d2 = torch.sum((kuv[:, None, :] - uv[None, :, :]) ** 2, -1)
        r = cfg.matcher.search_radius * torch.pow(
            cfg.orb.scale_factor, at(state.kf_octave, nbr).to(torch.float32)
        )
        window = (d2 <= r[:, None] ** 2) & vis[None, :]
        dist = hamming.hamming_matrix_mxu(at(state.kf_desc, nbr), desc)
        idx, mok, _ = hamming.match_top2(
            dist, kval, vis, max_dist=cfg.matcher.hamming_low,
            ratio=1.0, mutual=True, extra_mask=window,
        )
        # idx[s] = new-KF keypoint index whose point matches neighbor slot s
        cand_pt = torch.where(mok, new_pts[torch.clamp(idx, 0, N - 1).long()], -1)
        existing = at(obs_tab, nbr)
        # Case 1: neighbor slot unassociated -> add observation.
        add = mok & (existing < 0) & (cand_pt >= 0)
        new_row = torch.where(add, cand_pt, existing)
        obs_tab = set_at(obs_tab, nbr, torch.where(ok_nb, new_row, existing))
        # Case 2: duplicate -> redirect the lesser-observed point.
        dup = mok & (existing >= 0) & (cand_pt >= 0) & (existing != cand_pt)
        keep_exist = (n_obs[torch.clamp(existing, 0, P - 1).long()]
                      >= n_obs[torch.clamp(cand_pt, 0, P - 1).long()])
        src = torch.where(keep_exist, cand_pt, existing)
        dst = torch.where(keep_exist, existing, cand_pt)
        src = torch.where(dup & ok_nb, src, P)
        src_c = torch.clamp(src, 0, P).long()
        vals = torch.where(src < P, dst, remap[src_c])
        # Duplicate sources: the last write wins, as in a sequential scatter.
        writer = last_writer(src_c, P + 1)
        hit = writer >= 0
        remap = torch.where(hit, vals[torch.clamp(writer, min=0)], remap)
    # Resolve two-step merge chains (A->B, B->C), then apply globally.
    head = remap[torch.clamp(remap[:P], 0, P).long()]
    remap = torch.cat([head, remap[P:]])
    merged_away = remap[:P] != torch.arange(P, device=dev)
    obs_tab = torch.where(obs_tab >= 0,
                          remap[torch.clamp(obs_tab, 0, P).long()], -1)
    st = state._replace(
        kf_obs_pt=obs_tab,
        pt_valid=state.pt_valid & ~merged_away,
    )
    return recompute_covis(st)


def _top_neighbors(cfg: SlamConfig, state: MapState, kf_id, k: int):
    row = at(state.covis, kf_id) * state.kf_valid
    row = torch.where(torch.arange(row.shape[0], device=row.device) == kf_id,
                      0, row)
    w, ids = top_k(row, k)
    return ids, w, w >= cfg.map.covis_min_weight


def refresh_point_model(
    cfg: SlamConfig, state: MapState, slot, n_neighbors: int = 8
) -> MapState:
    """Refresh the viewing model of every point observed in keyframe
    ``slot``'s covisibility window: representative descriptor = medoid by
    mean Hamming among the point's observations; normal = sum of viewing
    directions; min/max view distance from the medoid's octave.  One [M, M]
    Hamming matrix over the window's descriptors, masked by same-point."""
    K, N = state.kf_obs_pt.shape
    P = cfg.map.max_points
    dev = state.kf_obs_pt.device
    nbr_ids, _, nbr_ok = _top_neighbors(cfg, state, slot, n_neighbors)
    win = torch.cat([slot.reshape(1).long(), nbr_ids])          # [W]
    win_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), nbr_ok]) \
        & state.kf_valid[win]
    obs = state.kf_obs_pt[win]                                  # [W, N]
    valid = win_ok[:, None] & (obs >= 0) & state.kf_kp_valid[win]
    pid = torch.where(valid, obs, P).reshape(-1).long()        # [M], P = dump
    desc = state.kf_desc[win].reshape(-1, 8)
    M = pid.shape[0]

    # Representative descriptor: medoid by mean Hamming among observations.
    D = hamming.hamming_matrix_mxu(desc, desc).to(torch.float32)
    same = (pid[:, None] == pid[None, :]) & (pid < P)[None, :]
    cnt = torch.sum(same, dim=1)
    mean_d = torch.sum(torch.where(same, D, 0.0), dim=1) / torch.clamp(cnt, min=1)
    score = torch.where(pid < P, mean_d, float("inf"))
    best = torch.full((P + 1,), float("inf"), device=dev).scatter_reduce(
        0, pid, score, reduce="amin")[:P]
    is_best = score <= best[torch.clamp(pid, 0, P - 1)] + 1e-3
    ar_m = torch.arange(M, device=dev)
    rank = torch.where(is_best & (pid < P), ar_m, M)
    winner = torch.full((P + 1,), torch.iinfo(torch.int64).max,
                        dtype=torch.int64, device=dev).scatter_reduce(
        0, pid, rank, reduce="amin")[:P]
    has = winner < M
    widx = torch.clamp(winner, 0, M - 1)
    new_desc = torch.where(has[:, None], desc[widx], state.pt_desc)
    angles = state.kf_angle[win].reshape(-1)
    new_angle = torch.where(has, angles[widx], state.pt_angle)

    # Normal: exact mean view direction over the window's observations.
    cam_w = se3.pose_inv(state.kf_pose[win])[:, 4:7]             # [W, 3]
    dvec = cam_w[:, None, :] - state.pt_xyz[torch.clamp(obs, 0, P - 1).long()]
    dist = torch.linalg.vector_norm(dvec, dim=-1)               # [W, N]
    vdir = dvec / torch.clamp(dist, min=1e-9)[..., None]
    dir_sum = torch.zeros((P + 1, 3), device=dev).index_add(
        0, pid, (vdir * valid[..., None]).reshape(-1, 3))[:P]
    new_dir = torch.where(has[:, None], dir_sum, state.pt_dir_sum)

    # Distance band re-predicted from the medoid observation's octave.
    sf = cfg.orb.scale_factor
    oct_flat = state.kf_octave[win].reshape(-1)
    dmax_w = dist.reshape(-1)[widx] * torch.pow(sf, oct_flat[widx].to(torch.float32))
    dmin_w = dmax_w / sf ** (cfg.orb.n_levels - 1)
    return state._replace(
        pt_desc=new_desc,
        pt_angle=new_angle,
        pt_dir_sum=new_dir,
        pt_dmin=torch.where(has, dmin_w, state.pt_dmin),
        pt_dmax=torch.where(has, dmax_w, state.pt_dmax),
    )
