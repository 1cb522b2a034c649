"""SLAM system orchestrator: the per-frame pipeline and the host loop.

``frame_step_core`` runs one RGBD frame — feature extraction, the
init/track status switch, and on a keyframe the full inline local-mapping
event (evict, insert, fuse, refresh, cull points, local BA, cull one
keyframe) — as eager PyTorch on the frame's device.  The reference compiles
the same step into one device program whose branches (``lax.switch`` /
``lax.cond``) run on the device; here each branch is taken on the host, and
every such read of a device scalar is counted by a ``HostSync``.

The host sees one packed ``[OUT_DIM]`` row per frame, the reference's
device->host contract, field for field.  Loop detection, relocalization,
asynchronous mapping and global BA are not ported yet: the row's loop
fields keep their no-keyframe values, and a frame that starts LOST raises.
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
from boslam_tpu_torch.mapping import map_ops
from boslam_tpu_torch.mapping.map_state import empty_map
from boslam_tpu_torch.solvers.local_ba import local_bundle_adjustment
from boslam_tpu_torch.tracking.tracker import (
    ST_LOST, ST_OK, ST_UNINIT, HostSync, init_track_state, track_frame,
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


def frame_step_core(cfg: SlamConfig, map_state, track, img, depth_u16,
                    sync: HostSync | None = None):
    """Process one RGBD frame on its device.

    ``img`` is the u8 gray wire image and ``depth_u16`` the u16 wire depth
    (at ``cfg.camera.depth_factor``), both tensors on the working device.
    Returns (map', track', row[OUT_DIM] f32).
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
            row[O_CULL0:O_CULL0 + 11] = cull_info
        row[O_NINL] = out.n_inliers.to(torch.float32)
        row[O_NMATCH] = out.n_matches.to(torch.float32)
        row[O_NVIS] = out.n_visible.to(torch.float32)
        row[O_LOST] = out.lost.to(torch.float32)
    elif status == ST_LOST:
        raise NotImplementedError(
            "tracking is lost and relocalization (tracker.relocalize, the "
            "lost branch) is not ported yet: it lands with the loop-closure "
            "and relocalization slice"
        )
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
    return map_state, track, row


class SlamSystem:
    """Sequential RGBD SLAM engine over one camera stream.

    ``feed()`` runs a frame and queues its packed row; ``flush()`` drains
    the rows in one readback and does the host bookkeeping.
    ``process_frame()`` is the synchronous wrapper (feed + flush).  The
    engine runs on ``cuda`` unless ``device`` says otherwise; without a card
    it raises.
    """

    def __init__(self, cfg: SlamConfig, seed: int = 0, chunk: int = 16,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.chunk = max(1, int(chunk))
        self.map = empty_map(cfg, self.device)
        self.track = init_track_state(self.device)
        # Drawn from by relocalization, which is not ported yet.
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
        self.map, self.track, row = frame_step_core(
            self.cfg, self.map, self.track, self._upload(img),
            self._upload(depth), self.sync,
        )
        self._pending_rows.append(row)
        self._pending_ts.append(ts)
        self._pending_t0.append(t0)
        if len(self._pending_rows) >= self.chunk:
            self.flush()

    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Drain pending frames: ONE packed readback, then host bookkeeping."""
        if not self._pending_rows:
            return
        rows = torch.stack(self._pending_rows).cpu().numpy()
        ts_list, t0_list = self._pending_ts, self._pending_t0
        self._pending_rows, self._pending_ts, self._pending_t0 = [], [], []
        t_drain = time.perf_counter()
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
            rec = {
                "ts": ts,
                "status": int(r[O_STATUS]),
                "n_inliers": int(r[O_NINL]),
                "n_matches": int(r[O_NMATCH]),
                "n_visible": int(r[O_NVIS]),
                "lost": bool(r[O_LOST] > 0.5),
                "dt_ms": (t_drain - t0) * 1e3,
            }
            if r[O_LOST] > 0.5:
                rec["event"] = "lost"
            elif r[O_KF] > 0.5:
                kf_id = int(r[O_KFID])
                rec["event"] = "init" if kf_id == 0 else "keyframe"
                rec.update(
                    kf_id=kf_id,
                    ba_cost0=float(r[O_BA0]),
                    ba_cost1=float(r[O_BA1]),
                    ba_edges=int(r[O_BAE]),
                )
            self.metrics.append(rec)

    # ------------------------------------------------------------------
    def process_frame(
        self, ts: float, rgb: np.ndarray, depth: np.ndarray
    ) -> np.ndarray:
        """Synchronous wrapper: feed one frame, flush, return T_wc [7]."""
        self.feed(ts, rgb, depth)
        self.flush()
        return self.poses_twc[-1]

    # ------------------------------------------------------------------
    def trajectory(self):
        """(timestamps, poses_twc [T, 7]) with every frame re-anchored to the
        current pose of its reference keyframe (culled references chase the
        cull chain)."""
        self.flush()
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
