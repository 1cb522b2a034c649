"""Frame-to-map tracking: constant-velocity prediction, projection-window
matching against the local map, robust GN motion-only BA, then a track-
local-map second pass and re-optimization (``boslam_tpu.tracking.tracker``).

The reference's ``lax.cond`` around the wide fallback pass is a host branch
here: one host synchronization per frame, counted by the caller's
``HostSync``.  Relocalization (the lost path) matches the frame against the
BoW candidate keyframes once a vocabulary exists, else against the whole
map, and solves RANSAC PnP + robust GN for every candidate as one batch.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.geometry import camera as cam_mod
from boslam_tpu_torch.geometry import se3
from boslam_tpu_torch.loopclosure import vocab as vocab_mod
from boslam_tpu_torch.matching import bow as bow_mod
from boslam_tpu_torch.matching import hamming, projection, rotation
from boslam_tpu_torch.ops.hamming_cuda import fused_match_top2
from boslam_tpu_torch.solvers.pose_opt import optimize_pose
from boslam_tpu_torch.solvers.ransac import ransac_pnp
from boslam_tpu_torch.utils.tensor_ops import at, top_k

ST_UNINIT, ST_OK, ST_LOST = 0, 1, 2

# Map size from which relocalization's whole-map match goes through the
# streaming matcher (ops.hamming_cuda, kernel B3) instead of the
# materialized [N, M] pipeline, as in the reference.
FUSED_MATCH_MIN_POINTS = 32768


class Span(NamedTuple):
    """One closed span of the host's work.  ``id`` numbers the recorder's
    spans in the order they opened; ``parent`` is the enclosing span's id
    (-1 at a root); ``t0`` / ``t1`` are ``time.perf_counter_ns()``;
    ``request`` is what the span belongs to: the engine's frame index, or,
    under a root opened without one (a solve), that root's id."""

    id: int
    name: str
    parent: int
    t0: int
    t1: int
    request: int


class _OpenSpan:
    """The context a recording ``HostSync.span`` returns."""

    __slots__ = ("sync", "name", "request")

    def __init__(self, sync: "HostSync", name: str, request) -> None:
        self.sync, self.name, self.request = sync, name, request

    def __enter__(self):
        s = self.sync
        sid = s._next_id
        s._next_id += 1
        parent, request = (s._open[-1][0], s._open[-1][1]) if s._open \
            else (-1, sid)
        if self.request is not None:
            request = self.request
        s._open.append((sid, request, parent, time.perf_counter_ns()))
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        sid, request, parent, t0 = self.sync._open.pop()
        self.sync.spans.append(Span(sid, self.name, parent, t0, t1, request))
        return False


# What ``span`` returns while the recorder is off: one shared context that
# reads no clock.
_NO_SPAN = contextlib.nullcontext()


class HostSync:
    """Reads a device scalar on the host for a branch, and counts the
    reads: each is one wait for the device (the reference branches on the
    device with ``lax.cond`` / ``lax.switch``).

    It is also the engine's span recorder, off unless ``trace``.  On, each
    ``span(name)`` records a ``Span`` on ``time.perf_counter_ns()`` when it
    closes, each read is a ``sync.read`` span around its wait, and the
    caller takes the closed spans with ``drain()``; nothing is written out.
    Off, ``span`` returns one shared no-op context and the reads only
    count.  ``utils.timing`` maps the spans onto the profiler's clock."""

    def __init__(self, trace: bool = False) -> None:
        self.count = 0
        self.trace = bool(trace)
        self.spans: list = []   # closed spans, in the order they closed
        self._open: list = []   # (id, request, parent, t0) innermost last
        self._next_id = 0

    def span(self, name: str, request: int | None = None):
        """A context that records one span named ``name``, nested in the
        innermost open one; ``request`` (default: the enclosing span's)
        names the frame it belongs to."""
        if not self.trace:
            return _NO_SPAN
        return _OpenSpan(self, name, request)

    def drain(self) -> list:
        """The spans closed since the last drain, in the order they closed."""
        out, self.spans = self.spans, []
        return out

    def flag(self, t: torch.Tensor) -> bool:
        self.count += 1
        if self.trace:
            with self.span("sync.read"):
                return bool(t)
        return bool(t)

    def value(self, t: torch.Tensor) -> int:
        self.count += 1
        if self.trace:
            with self.span("sync.read"):
                return int(t)
        return int(t)


class TrackState(NamedTuple):
    pose_cw: torch.Tensor    # [7] current camera pose (world -> camera)
    velocity: torch.Tensor   # [7] T_cw(t) ∘ T_cw(t-1)^-1 (motion model)
    status: torch.Tensor     # scalar i32: 0 uninit / 1 ok / 2 lost
    n_since_kf: torch.Tensor # scalar i32 frames since last keyframe
    last_kf: torch.Tensor    # scalar i32 reference keyframe id
    frame_idx: torch.Tensor  # scalar i32


class TrackOut(NamedTuple):
    pose_cw: torch.Tensor
    match_pt: torch.Tensor   # [N] i32 matched map-point id per keypoint (-1)
    match_ok: torch.Tensor   # [N] bool final inlier matches
    visible: torch.Tensor    # [P] bool map points predicted visible this frame
    n_inliers: torch.Tensor  # scalar i32
    n_visible: torch.Tensor  # scalar i32 map points predicted visible
    n_matches: torch.Tensor  # scalar i32 pre-BA matches
    need_kf: torch.Tensor    # scalar bool keyframe-decision hint
    lost: torch.Tensor       # scalar bool
    # [n_inliers, n_matches, n_visible, need_kf, lost] as f32.
    scalars: torch.Tensor


def init_track_state(device) -> TrackState:
    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=device)

    return TrackState(
        pose_cw=se3.pose_identity(device=device),
        velocity=se3.pose_identity(device=device),
        status=i32(ST_UNINIT),
        n_since_kf=i32(0),
        last_kf=i32(0),
        frame_idx=i32(0),
    )


def _local_point_mask(map_state, last_kf):
    """Points observed by the reference keyframe's covisibility
    neighborhood, two rings deep."""
    K = map_state.kf_valid.shape[0]
    P = map_state.pt_valid.shape[0]
    dev = map_state.kf_valid.device
    self_row = torch.arange(K, device=dev) == last_kf
    nb1 = ((at(map_state.covis, last_kf) > 0) | self_row) & map_state.kf_valid
    # Counts up to K * N fit float32 exactly; CUDA has no int32 matmul.
    reach = map_state.covis.to(torch.float32) @ nb1.to(torch.float32)
    nb2 = ((reach > 0) | nb1) & map_state.kf_valid
    obs = map_state.kf_obs_pt                                  # [K, N]
    sel = nb2[:, None] & map_state.kf_kp_valid & (obs >= 0)
    ids = torch.where(sel, obs, P).reshape(-1).long()  # P = dump slot
    out = torch.zeros((P + 1,), dtype=torch.bool, device=dev)
    out[ids] = True
    return out[:P]


def _match_and_optimize(cfg, feats, pose_pred, map_state, pt_mask,
                        radius, max_dist, ratio):
    idx, ok, vis, _ = projection.search_by_projection(
        cfg, feats, pose_pred, map_state.pt_xyz, map_state.pt_desc,
        pt_mask, radius=radius, max_dist=max_dist, ratio=ratio,
        pt_angle=map_state.pt_angle,
        pt_dir_sum=map_state.pt_dir_sum,
        pt_dmin=map_state.pt_dmin,
        pt_dmax=map_state.pt_dmax,
    )
    P = map_state.pt_xyz.shape[0]
    pid = torch.clamp(idx, 0, P - 1).long()
    pts_w = map_state.pt_xyz[pid]
    res = optimize_pose(
        cfg, pose_pred, pts_w, feats.uv, feats.depth,
        feats.has_depth & ok, ok, feats.octave,
    )
    return idx, ok, res, vis


def track_frame(cfg: SlamConfig, map_state, track: TrackState, feats,
                sync: HostSync | None = None):
    """Track one frame against the map.  Returns (TrackState, TrackOut)."""
    sync = HostSync() if sync is None else sync
    tk = cfg.tracker
    mc = cfg.matcher
    pose_pred = se3.pose_compose(track.velocity, track.pose_cw)

    if tk.track_scope == "local":
        pt_mask = map_state.pt_valid & _local_point_mask(map_state, track.last_kf)
    else:
        pt_mask = map_state.pt_valid

    # Pass 1: tight window from motion model.
    idx1, ok1, res1, _ = _match_and_optimize(
        cfg, feats, pose_pred, map_state, pt_mask,
        mc.search_radius, mc.hamming_low, mc.ratio,
    )
    pose1 = res1.pose
    # Fallback: if too few matches, widen (the lost-motion-model path).
    if sync.flag(torch.sum(ok1) < 2 * tk.min_inliers):
        _, _, res1b, _ = _match_and_optimize(
            cfg, feats, pose_pred, map_state, pt_mask,
            mc.search_radius_wide, mc.hamming_high, mc.ratio,
        )
        pose1 = res1b.pose

    # Pass 2: track local map — refined pose, fresh window, re-optimize.
    idx2, ok2, res2, vis2 = _match_and_optimize(
        cfg, feats, pose1, map_state, pt_mask,
        mc.search_radius, mc.hamming_high, 1.0,
    )
    pose = res2.pose
    inl = res2.inliers
    n_inl = res2.n_inliers
    n_match = torch.sum(ok2)

    lost = n_inl < tk.min_inliers
    # Keep the old pose when lost (motion model would drift).
    pose = torch.where(lost, track.pose_cw, pose)
    velocity = torch.where(
        lost, se3.pose_identity(device=pose.device),
        se3.pose_compose(pose, se3.pose_inv(track.pose_cw)),
    )

    # Keyframe policy (reference need_new_keyframe()).
    ref_obs = torch.sum(
        (at(map_state.kf_obs_pt, track.last_kf) >= 0)
        & at(map_state.kf_kp_valid, track.last_kf)
    )
    tracked_ratio = n_inl / torch.clamp(ref_obs, min=1)
    need_kf = (
        ~lost
        & (track.n_since_kf >= tk.kf_min_interval)
        & (
            (track.n_since_kf >= tk.kf_max_interval)
            | (tracked_ratio < tk.kf_tracked_ratio)
            | (n_inl < tk.kf_min_tracked)
        )
    )

    n_vis = torch.sum(vis2).to(torch.int32)
    new_track = TrackState(
        pose_cw=pose,
        velocity=velocity,
        status=torch.where(lost, ST_LOST, ST_OK).to(torch.int32),
        n_since_kf=track.n_since_kf + 1,
        last_kf=track.last_kf,
        frame_idx=track.frame_idx + 1,
    )
    out = TrackOut(
        pose_cw=pose,
        match_pt=torch.where(inl, idx2, -1),
        match_ok=inl & (idx2 >= 0),
        visible=vis2,
        n_inliers=n_inl,
        n_visible=n_vis,
        n_matches=n_match.to(torch.int32),
        need_kf=need_kf,
        lost=lost,
        scalars=torch.stack([
            n_inl.to(torch.float32),
            n_match.to(torch.float32),
            n_vis.to(torch.float32),
            need_kf.to(torch.float32),
            lost.to(torch.float32),
        ]),
    )
    return new_track, out


def _reloc_solve(cfg: SlamConfig, pts_w, feats, ok, key):
    """Shared tail of relocalization, batched over candidates ([R, N]
    inputs): RANSAC PnP (reprojection-scored consensus, hypotheses from
    depth-backed minimal sets) + robust GN refine, accepted with at least
    ``min_inliers`` and ``reloc_min_inliers`` refined inliers.  Returns
    (good [R], pose [R, 7], n_inliers [R])."""
    res = ransac_pnp(
        cfg, pts_w, feats.uv, feats.xyz, feats.has_depth, ok, key,
        n_hypotheses=cfg.tracker.ransac_iters,
        min_inliers=cfg.tracker.min_inliers,
    )
    refined = optimize_pose(
        cfg, res.pose, pts_w, feats.uv, feats.depth,
        feats.has_depth & ok, ok, feats.octave, inliers0=res.inliers,
    )
    need = max(cfg.tracker.min_inliers, cfg.tracker.reloc_min_inliers)
    good = res.ok & (refined.n_inliers >= need)
    return good, refined.pose, refined.n_inliers


def _bow_candidates(cfg: SlamConfig, map_state, loop_state, feats):
    """The top-R BoW candidate keyframes, each matched by vocabulary word
    and lifted to world points: (points [R, N, 3], matched [R, N])."""
    P = map_state.pt_xyz.shape[0]
    N = feats.desc.shape[0]
    R = cfg.tracker.reloc_candidates
    frame_bow = vocab_mod.bow_vector(cfg, loop_state.vocab, feats.desc,
                                     feats.valid, idf=loop_state.idf)
    scores = loop_state.kf_bow @ frame_bow
    _, cands = top_k(torch.where(map_state.kf_valid, scores, -1.0), R)
    # Depthless frame keypoints can match too: the PnP consensus is
    # reprojection-scored, so they vote without a 3D backprojection.
    idx, ok, _ = bow_mod.search_by_bow(
        loop_state.vocab, feats.desc, feats.valid, map_state.kf_desc[cands],
        map_state.kf_kp_valid[cands] & (map_state.kf_depth[cands] > 0),
        max_dist=cfg.matcher.hamming_high, ratio=0.9,
        angle_a=feats.angle, angle_b=map_state.kf_angle[cands],
    )
    # World points of the matched keyframe slots: the bound map point where
    # one exists, else the keypoint's depth backprojection.
    j = torch.clamp(idx, 0, N - 1).long()
    obs = torch.gather(map_state.kf_obs_pt[cands], 1, j)
    uv = torch.gather(map_state.kf_uv[cands], 1, j[..., None].expand(R, N, 2))
    z = torch.gather(map_state.kf_depth[cands], 1, j)
    xc = cam_mod.backproject(cfg.camera, uv, z)
    xw_bp = se3.pose_apply(se3.pose_inv(map_state.kf_pose[cands])[:, None, :], xc)
    pts_w = torch.where((obs >= 0)[..., None],
                        map_state.pt_xyz[torch.clamp(obs, 0, P - 1).long()], xw_bp)
    return pts_w, ok


def _global_candidates(cfg: SlamConfig, map_state, feats):
    """The whole map matched without a window (cold-start fallback before a
    vocabulary exists), padded to the R-wide batch with masked rows."""
    P = map_state.pt_xyz.shape[0]
    N = feats.desc.shape[0]
    R = cfg.tracker.reloc_candidates
    dev = feats.desc.device
    if P >= FUSED_MATCH_MIN_POINTS:
        # r = inf disables the projection window: a pure global match.
        idx, ok, _ = fused_match_top2(
            feats.desc, feats.uv, torch.full((N,), torch.inf, device=dev),
            feats.valid & feats.has_depth,
            map_state.pt_desc, torch.zeros((P, 2), device=dev),
            map_state.pt_valid,
            max_dist=cfg.matcher.hamming_low, ratio=0.85, mutual=True,
        )
    else:
        dist = hamming.hamming_matrix_mxu(feats.desc, map_state.pt_desc)
        idx, ok, _ = hamming.match_top2(
            dist, feats.valid & feats.has_depth, map_state.pt_valid,
            max_dist=cfg.matcher.hamming_low, ratio=0.85, mutual=True,
        )
    pid = torch.clamp(idx, 0, P - 1).long()
    ok = rotation.rotation_consistency(feats.angle, map_state.pt_angle[pid], ok)
    idx = torch.where(ok, idx, -1)
    pts1 = map_state.pt_xyz[torch.clamp(idx, 0, P - 1).long()]
    ok_r = torch.zeros((R, N), dtype=torch.bool, device=dev)
    ok_r[0] = ok
    return pts1.expand(R, N, 3), ok_r


def relocalize(cfg: SlamConfig, map_state, loop_state, track: TrackState,
               feats, key, sync: HostSync | None = None):
    """Relocalization (the lost path).

    With a trained vocabulary: the top-R BoW candidate keyframes, each
    matched by vocabulary word and solved; before one exists: the whole map
    (through kernel B3 from ``FUSED_MATCH_MIN_POINTS`` points).  Every
    candidate is solved in one batch and the most-inlier verified one wins.
    The reference's ``lax.cond`` on ``vocab_ready`` is a host branch here,
    counted by ``sync``.  ``key`` is a ``torch.Generator`` or the RANSAC
    Gumbel noise [R, H, N].  Returns (TrackState, good, n_inliers).
    ``sync``'s spans: ``reloc.candidates`` (the BoW retrieval and
    ``search_by_bow``, or the whole-map match) and ``reloc.solve`` (RANSAC
    PnP, the refine and the choice of the candidate).
    """
    sync = HostSync() if sync is None else sync
    with sync.span("reloc.candidates"):
        if sync.flag(loop_state.vocab_ready):
            pts_w, ok = _bow_candidates(cfg, map_state, loop_state, feats)
        else:
            pts_w, ok = _global_candidates(cfg, map_state, feats)
    with sync.span("reloc.solve"):
        good_r, pose_r, ninl_r = _reloc_solve(cfg, pts_w, feats, ok, key)
        best = torch.argmax(torch.where(good_r, ninl_r, -1)).reshape(1)
        good = good_r[best][0]
        pose = pose_r[best][0]
        n_inl = ninl_r[best][0]
    # Re-center the reference keyframe on the recovered pose: local-scope
    # tracking builds its map around last_kf.
    cam_w = se3.pose_inv(pose)[4:]
    kf_w = se3.pose_inv(map_state.kf_pose)[:, 4:]
    d2 = torch.sum((kf_w - cam_w[None, :]) ** 2, dim=-1)
    nearest = torch.argmin(
        torch.where(map_state.kf_valid, d2, torch.inf)).to(torch.int32)
    dev = pose.device
    new_track = track._replace(
        pose_cw=torch.where(good, pose, track.pose_cw),
        velocity=se3.pose_identity(device=dev),
        status=torch.where(good, ST_OK, ST_LOST).to(torch.int32),
        last_kf=torch.where(good, nearest, track.last_kf),
        frame_idx=track.frame_idx + 1,
    )
    return new_track, good, n_inl
