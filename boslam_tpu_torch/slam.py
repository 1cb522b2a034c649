"""SLAM system orchestrator: the per-frame pipeline and the host loop.

``frame_step_core`` runs one RGBD frame — feature extraction, the
init/track status switch, and on a keyframe the full inline local-mapping
event (evict, insert, fuse, refresh, cull points, local BA, cull one
keyframe) — as eager PyTorch on the frame's device.  The reference compiles
the same step into one device program whose branches (``lax.switch`` /
``lax.cond``) run on the device; here each branch is taken on the host, and
every such read of a device scalar is counted by a ``HostSync``.

A frame that starts LOST takes the lost branch (relocalization), and the
keyframe event ends with the keyframe's BoW vector and loop detection.

The host sees one packed ``[OUT_DIM]`` row per frame, the reference's
device->host contract, field for field.  ``flush`` drains the rows and runs
the host's rare events: vocabulary training and refresh, loop verification
(dispatched at one flush, resolved at the next), loop correction and,
after it when ``loop.run_global_ba`` is set, global bundle adjustment
(``run_global_ba``, also callable on its own).  Asynchronous mapping is not
ported yet.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.device import resolve_device
from boslam_tpu_torch.features.frontend import extract_features
from boslam_tpu_torch.geometry import se3
from boslam_tpu_torch.loopclosure import (
    compute_bow, detect_loop, empty_loop_state, train_vocab,
    verify_loops_batch,
)
from boslam_tpu_torch.mapping import map_ops
from boslam_tpu_torch.mapping.map_state import empty_map
from boslam_tpu_torch.solvers.global_ba import global_bundle_adjustment
from boslam_tpu_torch.solvers.local_ba import local_bundle_adjustment
from boslam_tpu_torch.solvers.pose_graph import close_loop_update
from boslam_tpu_torch.tracking.tracker import (
    ST_LOST, ST_OK, ST_UNINIT, HostSync, init_track_state, relocalize,
    track_frame,
)
from boslam_tpu_torch.utils.tensor_ops import at
from boslam_tpu_torch.utils.trajectory import anchor_trajectory

_BT601 = np.asarray([0.299, 0.587, 0.114], np.float32)

try:  # cv2's SIMD cvtColor is ~9x faster than the numpy BT.601 matmul.
    import cv2 as _cv2
except ImportError:  # pragma: no cover
    _cv2 = None


def to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """Host-side u8 RGB -> u8 BT.601 gray (the engine wire format)."""
    if _cv2 is not None:
        return _cv2.cvtColor(rgb, _cv2.COLOR_RGB2GRAY)
    # np.rint matches cv2's round-half-to-even: without it the two paths
    # differ by 1 LSB and engine input depends on whether cv2 is installed.
    return np.rint(rgb.astype(np.float32) @ _BT601).astype(np.uint8)


def depth_to_u16(depth: np.ndarray, depth_factor: float) -> np.ndarray:
    """Host-side f32 metres -> u16 at the TUM depth encoding (wire format)."""
    buf = depth * np.float32(depth_factor)
    np.clip(buf, 0, 65535, out=buf)
    return buf.astype(np.uint16)


def depth_wire(depth: np.ndarray, cam) -> np.ndarray:
    """Host-side depth (f32 metres or u16 counts) -> wire-format u16 of
    shape ``cam.depth_wire_shape``.

    stride 1 is plain quantization.  stride s > 1 ships one sample per s x s
    block with a boundary-aware reduction: the medoid of the block's valid
    samples picks one surface, then samples within 5% of it are averaged, so
    depths never mix across object boundaries.
    """
    if depth.dtype != np.uint16:
        depth = depth_to_u16(depth, cam.depth_factor)
    s = cam.depth_wire_stride
    if s == 1:
        return depth
    hs, ws = cam.depth_wire_shape
    H, W = depth.shape
    buf = np.zeros((hs * s, ws * s), np.float32)
    buf[:H, :W] = depth
    b = buf.reshape(hs, s, ws, s).transpose(0, 2, 1, 3).reshape(hs, ws, s * s)
    valid = b > 0
    c = valid.sum(-1)
    sv = np.sort(np.where(valid, b, np.inf), axis=-1)
    med = np.take_along_axis(
        sv, (np.maximum(c - 1, 0) // 2)[..., None], axis=-1
    )[..., 0]
    keep = valid & (np.abs(b - med[..., None]) <= 0.05 * med[..., None])
    out = (b * keep).sum(-1) / np.maximum(keep.sum(-1), 1)
    return np.rint(np.where(c > 0, out, 0.0)).astype(np.uint16)


# Packed per-frame output row (f32[OUT_DIM]) — the ONLY device->host data.
O_POSE0 = 0          # [0:7] pose T_wc (w x y z tx ty tz)
O_STATUS = 7         # track status AFTER the frame
O_NINL = 8           # tracking inliers
O_NMATCH = 9         # pre-BA matches
O_NVIS = 10          # map points predicted visible
O_KF = 11            # 1.0 if a keyframe was inserted this frame
O_KFID = 12          # inserted keyframe id (-1)
O_BA0 = 13           # local BA cost before
O_BA1 = 14           # local BA cost after
O_BAE = 15           # local BA edge count
O_LCAND = 16         # loop candidate keyframe id (-1)
O_LSCORE = 17        # loop BoW score
O_LCONS = 18         # 1.0 if temporal consistency passed
O_LOST = 19          # 1.0 if tracking was lost this frame
O_RELOC = 20         # 0 none / 1 reloc attempted+failed / 2 attempted+ok
O_NKF = 21           # keyframe count after the frame
O_REF = 22           # reference keyframe slot of this frame
O_REFSEQ = 23        # kf_seq of that slot (detects later slot reuse)
O_REL0 = 24          # [24:31] T_cur_ref = T_cw(frame) ∘ T_wc(ref keyframe)
O_CULL0 = 31         # [31:42] cull chain record: [victim_slot (-1 = none),
                     # victim_seq, parent_slot, parent_seq, T_victim_parent(7)]
OUT_DIM = 42


def frame_step_core(cfg: SlamConfig, map_state, loop_state, track, key,
                    img, depth_u16, sync: HostSync | None = None):
    """Process one RGBD frame on its device.

    ``img`` is the u8 gray wire image and ``depth_u16`` the u16 wire depth
    (at ``cfg.camera.depth_factor``), both tensors on the working device;
    ``key`` is the ``torch.Generator`` relocalization draws from.
    Returns (map', loop', track', row[OUT_DIM] f32).
    """
    sync = HostSync() if sync is None else sync
    dev = img.device
    gray = img.to(torch.float32)
    depth = depth_u16.to(torch.float32) * (1.0 / cfg.camera.depth_factor)
    feats = extract_features(gray, depth, cfg)
    n = cfg.orb.n_features

    row = torch.zeros((OUT_DIM,), device=dev)
    row[O_KFID] = -1.0
    row[O_LCAND] = -1.0
    row[O_CULL0] = -1.0  # victim slot: -1 = nothing culled

    status = sync.value(track.status)
    if status == ST_UNINIT:
        # First frame: init the map from RGBD depth.
        mp = torch.full((n,), -1, dtype=torch.int32, device=dev)
        ok = torch.zeros((n,), dtype=torch.bool, device=dev)
        map_state, _ = map_ops.insert_keyframe(
            cfg, map_state, feats, se3.pose_identity(device=dev), mp, ok,
            track.frame_idx,
        )
        track = track._replace(
            status=torch.full((), ST_OK, dtype=torch.int32, device=dev),
            frame_idx=track.frame_idx + 1,
        )
        row[O_KF] = 1.0
        row[O_KFID] = 0.0
    elif status == ST_OK:
        track, out = track_frame(cfg, map_state, track, feats, sync)
        map_state = map_ops.update_track_stats(
            cfg, map_state, out.visible, out.match_pt, out.match_ok
        )
        # A saturated pool evicts inside the event; the guard covers only
        # degenerate pools (< 3 live keyframes: root and latest protected).
        can_kf = out.need_kf & ~out.lost & (
            ~torch.all(map_state.kf_valid) | (torch.sum(map_state.kf_valid) >= 3)
        )
        if sync.flag(can_kf):
            st, evict_info = map_ops.evict_for_slot(cfg, map_state)
            st, kf_id = map_ops.insert_keyframe(
                cfg, st, feats, out.pose_cw, out.match_pt, out.match_ok,
                track.frame_idx,
            )
            st = map_ops.fuse_new_keyframe(cfg, st, kf_id)
            st = map_ops.refresh_point_model(cfg, st, kf_id)
            st = map_ops.cull_points(cfg, st, update_covis=False)
            st, ba = local_bundle_adjustment(cfg, st, kf_id)
            # One cull record per row: a saturation eviction is reported and
            # the redundancy cull skipped this event.
            if sync.flag(evict_info[0] >= 0):
                cull_info = evict_info
            else:
                st, cull_info = map_ops.cull_one_keyframe(cfg, st)
            loop_state = compute_bow(cfg, loop_state, st, kf_id)
            loop_state, det = detect_loop(cfg, loop_state, st, kf_id)
            map_state = st
            track = track._replace(
                last_kf=kf_id,
                n_since_kf=torch.zeros((), dtype=torch.int32, device=dev),
                pose_cw=at(st.kf_pose, kf_id),
            )
            row[O_KF] = 1.0
            row[O_KFID] = kf_id.to(torch.float32)
            row[O_BA0] = ba.cost0
            row[O_BA1] = ba.cost1
            row[O_BAE] = ba.n_edges.to(torch.float32)
            row[O_LCAND] = det.candidate.to(torch.float32)
            row[O_LSCORE] = det.score
            row[O_LCONS] = det.consistent.to(torch.float32)
            row[O_CULL0:O_CULL0 + 11] = cull_info
        row[O_NINL] = out.n_inliers.to(torch.float32)
        row[O_NMATCH] = out.n_matches.to(torch.float32)
        row[O_NVIS] = out.n_visible.to(torch.float32)
        row[O_LOST] = out.lost.to(torch.float32)
    elif status == ST_LOST:
        track, good, n_inl = relocalize(cfg, map_state, loop_state, track,
                                        feats, key, sync)
        row[O_NINL] = n_inl.to(torch.float32)
        row[O_RELOC] = torch.where(good, 2.0, 1.0)
    else:
        raise ValueError(f"unknown track status {status}")

    row[O_STATUS] = track.status.to(torch.float32)
    ref = track.last_kf
    row[O_POSE0:O_POSE0 + 7] = se3.pose_inv(track.pose_cw)
    row[O_NKF] = map_state.n_kf.to(torch.float32)
    row[O_REF] = ref.to(torch.float32)
    row[O_REFSEQ] = at(map_state.kf_seq, ref).to(torch.float32)
    row[O_REL0:O_REL0 + 7] = se3.pose_compose(
        track.pose_cw, se3.pose_inv(at(map_state.kf_pose, ref))
    )
    return map_state, loop_state, track, row


class SlamSystem:
    """Sequential RGBD SLAM engine over one camera stream.

    ``feed()`` runs a frame and queues its packed row; ``flush()`` drains
    the rows in one readback and runs the host events (vocabulary training,
    loop verification and correction).  ``process_frame()`` is the
    synchronous wrapper (feed + flush).  The engine runs on ``cuda`` unless
    ``device`` says otherwise; without a card it raises.
    """

    # Max consistent candidates verified per drain; extras are dropped
    # (they re-fire on the next keyframe if genuine).
    MAX_VERIFY = 4

    def __init__(self, cfg: SlamConfig, seed: int = 0, chunk: int = 16,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.chunk = max(1, int(chunk))
        self.map = empty_map(cfg, self.device)
        self.loop = empty_loop_state(cfg, self.device)
        self.track = init_track_state(self.device)
        # Drawn from by relocalization and loop verification (RANSAC).
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.sync = HostSync()
        self.timestamps: List[float] = []
        self.poses_twc: List[np.ndarray] = []
        # Per frame: (ref kf slot, kf_seq at record time, T_cur_ref [7]).
        self.frame_refs: List[tuple] = []
        # Cull chain: (victim_slot, victim_seq) -> (parent_slot, parent_seq,
        # T_victim_parent [7]).
        self.cull_chain: dict = {}
        self.metrics: List[dict] = []
        self.n_loops_closed = 0
        self.n_global_ba = 0
        self._vocab_trained_at = -1  # n_kf at last vocabulary (re)train
        # In-flight loop verification batch (resolved at the NEXT flush) and
        # a host mirror of each keyframe slot's current seq (from the packed
        # rows: inserts and culls), which guards stale closures.
        self._pending_verify = None
        self._kf_seq_host: dict = {}
        self._pending_rows: List[torch.Tensor] = []
        self._pending_ts: List[float] = []
        self._pending_t0: List[float] = []

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            # Pinned + non_blocking: a pageable copy would wait for the device.
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # ------------------------------------------------------------------
    def feed(self, ts: float, rgb: np.ndarray, depth: np.ndarray) -> None:
        """Run one RGBD frame.  ``rgb`` may be [H, W, 3] u8 RGB or an [H, W]
        grayscale image; ``depth`` f32 metres or u16 at the camera
        depth_factor."""
        t0 = time.perf_counter()
        if rgb.ndim == 3:
            img = to_gray_u8(rgb)
        else:
            img = rgb if rgb.dtype == np.uint8 else \
                np.clip(rgb, 0, 255).astype(np.uint8)
        cam = self.cfg.camera
        if depth.dtype != np.uint16 or depth.shape != cam.depth_wire_shape:
            depth = depth_wire(depth, cam)
        self.map, self.loop, self.track, row = frame_step_core(
            self.cfg, self.map, self.loop, self.track, self.generator,
            self._upload(img), self._upload(depth), self.sync,
        )
        self._pending_rows.append(row)
        self._pending_ts.append(ts)
        self._pending_t0.append(t0)
        if len(self._pending_rows) >= self.chunk:
            self.flush()

    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Drain pending frames: ONE packed readback, then host events."""
        if not self._pending_rows:
            # End of stream: close the last in-flight loop.
            self._resolve_pending_verify()
            return
        rows = torch.stack(self._pending_rows).cpu().numpy()
        ts_list, t0_list = self._pending_ts, self._pending_t0
        self._pending_rows, self._pending_ts, self._pending_t0 = [], [], []
        t_drain = time.perf_counter()
        loop_requests = []  # (kf_id, cand, rec): one closure per drain
        for ts, t0, r in zip(ts_list, t0_list, rows):
            self.timestamps.append(ts)
            self.poses_twc.append(r[O_POSE0:O_POSE0 + 7].copy())
            self.frame_refs.append(
                (int(r[O_REF]), int(r[O_REFSEQ]), r[O_REL0:O_REL0 + 7].copy())
            )
            if r[O_CULL0] >= 0:
                self.cull_chain[(int(r[O_CULL0]), int(r[O_CULL0 + 1]))] = (
                    int(r[O_CULL0 + 2]), int(r[O_CULL0 + 3]),
                    r[O_CULL0 + 4:O_CULL0 + 11].copy(),
                )
                self._kf_seq_host[int(r[O_CULL0])] = None  # slot vacated
            rec = {
                "ts": ts,
                "status": int(r[O_STATUS]),
                "n_inliers": int(r[O_NINL]),
                "n_matches": int(r[O_NMATCH]),
                "n_visible": int(r[O_NVIS]),
                "lost": bool(r[O_LOST] > 0.5),
                "dt_ms": (t_drain - t0) * 1e3,
            }
            if r[O_RELOC] > 0.5:
                rec["event"] = "relocalize"
                rec["reloc_ok"] = bool(r[O_RELOC] > 1.5)
            elif r[O_LOST] > 0.5:
                rec["event"] = "lost"
            elif r[O_KF] > 0.5:
                kf_id = int(r[O_KFID])
                # The slot's new tenant: seq = monotonic n_kf before the
                # increment the row reports.
                self._kf_seq_host[kf_id] = int(r[O_NKF]) - 1
                rec["event"] = "init" if kf_id == 0 else "keyframe"
                rec.update(
                    kf_id=kf_id,
                    ba_cost0=float(r[O_BA0]),
                    ba_cost1=float(r[O_BA1]),
                    ba_edges=int(r[O_BAE]),
                )
                if r[O_LCAND] >= 0:
                    rec["loop_candidate"] = int(r[O_LCAND])
                    rec["loop_score"] = float(r[O_LSCORE])
                if r[O_LCONS] > 0.5:
                    loop_requests.append((kf_id, int(r[O_LCAND]), rec))
            self.metrics.append(rec)

        # Vocabulary lifecycle: first training once enough keyframes exist,
        # then a periodic refresh (kf_bow rows are recomputed each time).
        n_kf = int(rows[-1][O_NKF])
        lc = self.cfg.loop
        due = (
            (self._vocab_trained_at < 0 and n_kf >= lc.vocab_train_kf)
            or (self._vocab_trained_at >= 0
                and n_kf - self._vocab_trained_at >= lc.vocab_refresh_kf)
        )
        if due:
            self.loop = train_vocab(self.cfg, self.loop, self.map)
            self._vocab_trained_at = n_kf
        # Resolve the previous drain's verification batch (at most one
        # closure), then dispatch this drain's candidates.
        self._resolve_pending_verify()
        self._dispatch_verify(loop_requests)

    # ------------------------------------------------------------------
    def _dispatch_verify(self, loop_requests) -> None:
        """Verify this drain's candidates in one batch; the results are
        read at the next flush."""
        reqs, seen = [], set()
        for kf_id, cand, rec in loop_requests:
            if cand >= 0 and (kf_id, cand) not in seen:
                seen.add((kf_id, cand))
                reqs.append((kf_id, cand, rec))
        reqs = reqs[: self.MAX_VERIFY]
        if not reqs:
            return
        # Pad to the fixed batch size by repeating the first request (the
        # reference's static batch; the host reads only the first n).
        pad = reqs + [reqs[0]] * (self.MAX_VERIFY - len(reqs))
        kf_ids = torch.tensor([r[0] for r in pad], dtype=torch.int32,
                              device=self.device)
        cands = torch.tensor([r[1] for r in pad], dtype=torch.int32,
                             device=self.device)
        ok, t_rel, n_inl, midx, mok = verify_loops_batch(
            self.cfg, self.map, kf_ids, cands, self.generator)
        # Endpoint identity at dispatch, from the host mirror: a slot culled
        # or reused before the resolve must drop the closure.
        guards = [
            (self._kf_seq_host.get(kf), self._kf_seq_host.get(cand))
            for kf, cand, _ in reqs
        ]
        self._pending_verify = (ok, t_rel, n_inl, midx, mok, reqs, guards,
                                self.n_loops_closed, self.n_global_ba)

    def _resolve_pending_verify(self) -> None:
        """Read the previous drain's verification results and run at most
        one pose-graph correction."""
        if self._pending_verify is None:
            return
        (ok, t_rel, n_inl, midx, mok, reqs, guards, loops0, gba0) = (
            self._pending_verify
        )
        self._pending_verify = None
        ok_h, inl_h = ok.cpu().numpy(), n_inl.cpu().numpy()
        for i, (kf_id, cand, rec) in enumerate(reqs):
            rec["loop_inliers"] = int(inl_h[i])
        if self.n_loops_closed != loops0 or self.n_global_ba != gba0:
            return  # trajectory moved since dispatch; stale measurement
        for i, (kf_id, cand, rec) in enumerate(reqs):
            fresh = (
                guards[i][0] is not None
                and guards[i][1] is not None
                and self._kf_seq_host.get(kf_id) == guards[i][0]
                and self._kf_seq_host.get(cand) == guards[i][1]
            )
            if fresh and bool(ok_h[i]):
                self._close_loop(kf_id, cand, t_rel[i], midx[i], mok[i], rec)
                break

    # ------------------------------------------------------------------
    def process_frame(
        self, ts: float, rgb: np.ndarray, depth: np.ndarray
    ) -> np.ndarray:
        """Synchronous wrapper: feed one frame, flush, return T_wc [7]."""
        self.feed(ts, rgb, depth)
        self.flush()
        return self.poses_twc[-1]

    # ------------------------------------------------------------------
    def _close_loop(self, kf_id: int, cand: int, t_rel, midx, mok,
                    rec=None) -> None:
        """Correct the loop: point fusion + loop edge + essential-graph
        optimization + map propagation (``close_loop_update``)."""
        cfg = self.cfg
        dev = self.device
        self.map, pose_kf = close_loop_update(
            cfg, self.map, torch.tensor(kf_id, dtype=torch.int32, device=dev),
            torch.tensor(cand, dtype=torch.int32, device=dev), t_rel, midx,
            mok,
        )
        self.track = self.track._replace(
            pose_cw=pose_kf, velocity=se3.pose_identity(device=dev)
        )
        self.n_loops_closed += 1
        (rec if rec is not None else self.metrics[-1])["event"] = "loop_closed"
        if cfg.loop.run_global_ba:
            # Optional full-map BA after the pose-graph correction.
            self.run_global_ba()

    # ------------------------------------------------------------------
    def run_global_ba(self) -> dict:
        """Full-map bundle adjustment on this engine's device; returns the
        record it adds to the last frame's metrics (costs before and after,
        edge count)."""
        cfg = self.cfg
        # The latest keyframe anchors the tracked pose across the solve:
        # keep the frame's pose relative to it (T_cur_ref = pose_cw ∘
        # T_wc(ref)) and re-attach it to the corrected pose of ref; snapping
        # to the keyframe's pose would drop the motion since that keyframe.
        ref = self.sync.value(torch.argmax(
            torch.where(self.map.kf_valid, self.map.kf_seq, -1)))
        t_cur_ref = se3.pose_compose(
            self.track.pose_cw, se3.pose_inv(self.map.kf_pose[ref])
        )
        self.map, stats = global_bundle_adjustment(
            cfg, self.map, lm_iters=cfg.loop.global_ba_iters,
            cg_iters=cfg.loop.global_ba_cg_iters, sync=self.sync,
        )
        self.track = self.track._replace(
            pose_cw=se3.pose_compose(t_cur_ref, self.map.kf_pose[ref]),
            velocity=se3.pose_identity(device=self.device),
        )
        self.n_global_ba += 1
        rec = {
            "gba_cost0": float(stats.cost0),
            "gba_cost1": float(stats.cost1),
            "gba_edges": int(stats.n_edges),
            "gba_distributed": False,
        }
        if self.metrics:
            self.metrics[-1].update(rec)
        return rec

    # ------------------------------------------------------------------
    def trajectory(self):
        """(timestamps, poses_twc [T, 7]) with every frame re-anchored to the
        current pose of its reference keyframe (culled references chase the
        cull chain), so loop corrections made after a frame passed still
        correct it."""
        self.flush()
        # A flush may have just dispatched a verification: land it first.
        self._resolve_pending_verify()
        ts = np.asarray(self.timestamps)
        raw = np.stack(self.poses_twc)
        out = anchor_trajectory(
            raw, self.frame_refs, self.cull_chain,
            self.map.kf_pose.cpu().numpy(), self.map.kf_valid.cpu().numpy(),
            self.map.kf_seq.cpu().numpy(),
        )
        return ts, out

    @property
    def n_keyframes(self) -> int:
        return int(torch.sum(self.map.kf_valid))

    @property
    def n_points(self) -> int:
        return int(torch.sum(self.map.pt_valid))


def run_sequence(
    cfg: SlamConfig,
    frames,
    seed: int = 0,
    progress: bool = False,
    chunk: int = 16,
    device=None,
) -> SlamSystem:
    """Run the engine over an iterable of (ts, rgb, depth)."""
    slam = SlamSystem(cfg, seed=seed, chunk=chunk, device=device)
    for i, (ts, rgb, depth) in enumerate(frames):
        slam.feed(ts, rgb, depth)
        if progress and i % 25 == 0 and slam.metrics:
            m = slam.metrics[-1]
            print(
                f"[{i}] kf={slam.n_keyframes} pts={slam.n_points} "
                f"inl={m.get('n_inliers', 0)} {m.get('event', '')}"
            )
    slam.flush()
    return slam
