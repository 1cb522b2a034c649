"""Multi-sequence SLAM engine (``boslam_tpu.parallel.multi``): S camera
sequences in lockstep, one controller driving all of them.

Each sequence keeps its own map, loop state, track state, ``torch.Generator``
and ``HostSync`` on ``devices[s % len(devices)]`` (by default the one
working card): the counterpart of the reference's ``seq`` mesh over local
devices.  ``feed`` copies the S frames to the card in one stacked, pinned
transfer, then steps each active sequence in turn through
``frame_step_core``.

There is no batch dimension over sequences.  Every sequence branches on the
host (the frame step reads the track status, the keyframe decision and the
relocalization outcome), the reference itself keeps real per-sequence
branches rather than a ``vmap`` (a vmapped step would run local BA for every
sequence on every frame), and a batched frame step would rewrite every
module.  The reference's policy is kept exactly:

- the depth wire reduction runs per frame, as in ``SlamSystem.feed``;
- a finished sequence (``active`` False) does no work and leaves no record;
- each sequence has its own cull chain;
- the flush runs the rare host events in rounds: vocabulary training in the
  first round only, at most one loop candidate per sequence per round,
  verified at once (not one flush late, as ``SlamSystem`` does), and a
  closure stops that sequence's queue;
- the event generators derive from a host counter.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.device import resolve_device
from boslam_tpu_torch.geometry import se3
from boslam_tpu_torch.loopclosure import (
    empty_loop_state, train_vocab, verify_loop,
)
from boslam_tpu_torch.mapping.map_state import empty_map
from boslam_tpu_torch.slam import (
    O_CULL0, O_KF, O_KFID, O_LCAND, O_LCONS, O_LOST, O_NINL, O_NKF, O_POSE0,
    O_REF, O_REFSEQ, O_REL0, O_STATUS, frame_step_core, wire_frame,
)
from boslam_tpu_torch.solvers.pose_graph import close_loop_update
from boslam_tpu_torch.tracking.tracker import HostSync, init_track_state
from boslam_tpu_torch.utils.trajectory import anchor_trajectory

# The event generators' seed: the reference's ``jax.random.key(7)``.
_EVENT_SEED = 7


def seq_mesh(n_seq: int, devices=None) -> tuple:
    """The device of each of ``n_seq`` sequences: ``devices[s % len]``;
    ``devices`` defaults to the one working card (``cuda``; it raises
    without one)."""
    if devices is None:
        devices = [resolve_device(None)]
    devices = [resolve_device(d) for d in devices]
    return tuple(devices[s % len(devices)] for s in range(n_seq))


def make_batched_step(cfg: SlamConfig):
    """The frame step over S sequences: ``step(maps, loops, tracks, gens,
    imgs, d16s, active, syncs) -> (maps, loops, tracks, rows)``, lists of
    length S; an inactive sequence keeps its state and its row is None."""

    def step(maps, loops, tracks, gens, imgs, d16s, active, syncs):
        maps, loops, tracks = list(maps), list(loops), list(tracks)
        rows = [None] * len(maps)
        for s, act in enumerate(active):
            if act:
                maps[s], loops[s], tracks[s], rows[s] = frame_step_core(
                    cfg, maps[s], loops[s], tracks[s], gens[s], imgs[s],
                    d16s[s], syncs[s])
        return maps, loops, tracks, rows

    return step


def make_batched_events(cfg: SlamConfig):
    """Both rare host events over S sequences, gated per sequence:
    ``events(maps, loops, tracks, gens, vocab_do, kf_id, cand, loop_do,
    syncs) -> (maps, loops, tracks, closed [S] bool, n_inl [S] int)``.
    A sequence trains its vocabulary when ``vocab_do[s]``, then verifies
    and (on success) closes its loop (kf_id[s], cand[s]) when
    ``loop_do[s]``."""

    def events(maps, loops, tracks, gens, vocab_do, kf_id, cand, loop_do,
               syncs):
        maps, loops, tracks = list(maps), list(loops), list(tracks)
        S = len(maps)
        closed = np.zeros(S, bool)
        n_inl = np.zeros(S, np.int64)
        for s in range(S):
            if vocab_do[s]:
                loops[s] = train_vocab(cfg, loops[s], maps[s])
            if not (loop_do[s] and cand[s] >= 0):
                continue
            dev = maps[s].kf_pose.device
            kf = torch.tensor(int(kf_id[s]), dtype=torch.int32, device=dev)
            cd = torch.tensor(int(cand[s]), dtype=torch.int32, device=dev)
            ok, t_rel, inl, midx, mok = verify_loop(cfg, maps[s], kf, cd,
                                                    gens[s])
            n_inl[s] = syncs[s].value(inl)
            if syncs[s].flag(ok):
                maps[s], pose_kf = close_loop_update(cfg, maps[s], kf, cd,
                                                     t_rel, midx, mok)
                tracks[s] = tracks[s]._replace(
                    pose_cw=pose_kf,
                    velocity=se3.pose_identity(device=dev))
                closed[s] = True
        return maps, loops, tracks, closed, n_inl

    return events


class BatchedSlamSystem:
    """S independent RGBD SLAM engines driven in lockstep.

    ``feed(ts_list, rgbs, depths, active)`` advances every active sequence
    by one frame (lists of length S); ``flush()`` drains the packed rows in
    one readback and runs the host events.  Mirrors ``SlamSystem``'s
    interface per sequence through ``metrics[s]`` / ``trajectory(s)``.
    Sequence s draws its relocalization noise from a generator seeded
    ``seed + s``, as a ``SlamSystem(seed=seed + s)`` does.
    """

    def __init__(self, cfg: SlamConfig, n_seq: int, mesh=None,
                 seed: int = 0, chunk: int = 8):
        self.cfg = cfg
        self.n_seq = n_seq
        self.mesh = tuple(mesh) if mesh is not None else seq_mesh(n_seq)
        assert len(self.mesh) == n_seq
        self.chunk = max(1, int(chunk))
        self.map = [empty_map(cfg, d) for d in self.mesh]
        self.loop = [empty_loop_state(cfg, d) for d in self.mesh]
        self.track = [init_track_state(d) for d in self.mesh]
        self.generator = [torch.Generator(device=d).manual_seed(seed + s)
                          for s, d in enumerate(self.mesh)]
        self.sync = [HostSync() for _ in range(n_seq)]
        self._step = make_batched_step(cfg)
        self._events = make_batched_events(cfg)
        self.metrics: List[List[dict]] = [[] for _ in range(n_seq)]
        self.timestamps: List[List[float]] = [[] for _ in range(n_seq)]
        self.poses_twc: List[List[np.ndarray]] = [[] for _ in range(n_seq)]
        self.frame_refs: List[List[tuple]] = [[] for _ in range(n_seq)]
        self.n_loops_closed = [0] * n_seq
        # Per-sequence cull chains (see SlamSystem.cull_chain).
        self.cull_chain = [dict() for _ in range(n_seq)]
        self._vocab_trained_at = [-1] * n_seq
        self._pending_rows: List[list] = []
        self._pending_ts: List[List[float]] = []
        self._pending_act: List[np.ndarray] = []

    # ------------------------------------------------------------------
    def _upload(self, arrays, act):
        """The active sequences' arrays, one stacked pinned copy per device;
        returns per-sequence views (None for inactive ones)."""
        out = [None] * self.n_seq
        for dev in dict.fromkeys(self.mesh):
            idx = [s for s in range(self.n_seq) if act[s] and
                   self.mesh[s] == dev]
            if not idx:
                continue
            t = torch.from_numpy(np.stack([arrays[s] for s in idx]))
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            else:
                t = t.to(dev)
            for i, s in enumerate(idx):
                out[s] = t[i]
        return out

    def feed(self, ts_list, rgbs, depths, active=None) -> None:
        """Advance the sequences by one frame.  ``active`` [S] bools
        (default all True): an inactive sequence does no work and produces
        no host record, how unequal-length batches run each sequence to
        its own end (``run_sequences``)."""
        if active is None:
            active = [True] * self.n_seq
        active = np.asarray(active, bool)
        imgs, d16s = [None] * self.n_seq, [None] * self.n_seq
        for s in range(self.n_seq):
            if active[s]:
                # Per frame, as SlamSystem.feed: the frontend indexes depth
                # at the wire stride.
                imgs[s], d16s[s] = wire_frame(self.cfg, rgbs[s], depths[s])
        self.map, self.loop, self.track, rows = self._step(
            self.map, self.loop, self.track, self.generator,
            self._upload(imgs, active), self._upload(d16s, active), active,
            self.sync)
        self._pending_rows.append(rows)
        self._pending_ts.append(list(ts_list))
        self._pending_act.append(active)
        if len(self._pending_rows) >= self.chunk:
            self.flush()

    # ------------------------------------------------------------------
    def _read_rows(self):
        """[T][S] host rows (None where inactive), one readback per
        device."""
        host = [[None] * self.n_seq for _ in self._pending_rows]
        for dev in dict.fromkeys(self.mesh):
            where = [(t, s) for t, rows in enumerate(self._pending_rows)
                     for s, r in enumerate(rows)
                     if r is not None and self.mesh[s] == dev]
            if not where:
                continue
            block = torch.stack([self._pending_rows[t][s]
                                 for t, s in where]).cpu().numpy()
            for (t, s), r in zip(where, block):
                host[t][s] = r
        return host

    def flush(self) -> None:
        if not self._pending_rows:
            return
        rows_t = self._read_rows()
        ts_t = self._pending_ts
        act_t = self._pending_act
        self._pending_rows, self._pending_ts, self._pending_act = [], [], []

        lc = self.cfg.loop
        vocab_do = np.zeros(self.n_seq, bool)
        # Per-sequence queue of (kf_id, cand, rec): every consistent
        # candidate of this drain is verified in order until one closes,
        # and each result lands on the record whose row raised it.
        loop_queue = [[] for _ in range(self.n_seq)]
        for s in range(self.n_seq):
            last_active_t = -1
            for t, ts in enumerate(ts_t):
                if not act_t[t][s]:
                    continue  # finished sequence: no work, no record
                last_active_t = t
                r = rows_t[t][s]
                self.timestamps[s].append(ts[s])
                self.poses_twc[s].append(r[O_POSE0:O_POSE0 + 7].copy())
                self.frame_refs[s].append(
                    (int(r[O_REF]), int(r[O_REFSEQ]),
                     r[O_REL0:O_REL0 + 7].copy()))
                if r[O_CULL0] >= 0:
                    self.cull_chain[s][
                        (int(r[O_CULL0]), int(r[O_CULL0 + 1]))
                    ] = (int(r[O_CULL0 + 2]), int(r[O_CULL0 + 3]),
                         r[O_CULL0 + 4:O_CULL0 + 11].copy())
                rec = {
                    "ts": ts[s],
                    "status": int(r[O_STATUS]),
                    "n_inliers": int(r[O_NINL]),
                    "lost": bool(r[O_LOST] > 0.5),
                }
                if r[O_KF] > 0.5:
                    rec["event"] = "keyframe" if r[O_KFID] > 0 else "init"
                    rec["kf_id"] = int(r[O_KFID])
                if r[O_LCONS] > 0.5:
                    loop_queue[s].append((int(r[O_KFID]), int(r[O_LCAND]),
                                          rec))
                self.metrics[s].append(rec)
            if last_active_t < 0:
                continue  # the sequence saw no frames this drain
            n_kf = int(rows_t[last_active_t][s][O_NKF])
            due = (
                (self._vocab_trained_at[s] < 0 and n_kf >= lc.vocab_train_kf)
                or (self._vocab_trained_at[s] >= 0
                    and n_kf - self._vocab_trained_at[s]
                    >= lc.vocab_refresh_kf)
            )
            if due:
                vocab_do[s] = True
                self._vocab_trained_at[s] = n_kf

        # Rounds: at most one candidate per sequence each; a sequence stops
        # once a closure succeeds (later candidates referenced the
        # pre-correction map).  Vocabulary training rides the first round.
        done = np.zeros(self.n_seq, bool)
        round_no = 0
        while vocab_do.any() or any(
                q and not done[s] for s, q in enumerate(loop_queue)):
            loop_do = np.zeros(self.n_seq, bool)
            kf_ids = np.zeros(self.n_seq, np.int64)
            cands = np.full(self.n_seq, -1, np.int64)
            recs = [None] * self.n_seq
            for s in range(self.n_seq):
                if loop_queue[s] and not done[s]:
                    kf_ids[s], cands[s], recs[s] = loop_queue[s].pop(0)
                    loop_do[s] = True
            # Per-sequence event generators from a host counter (rare path).
            base = len(self.metrics[0]) * 64 + round_no
            round_no += 1
            gens = [torch.Generator(device=d).manual_seed(
                        _EVENT_SEED + 1_000_003 * (base * self.n_seq + s))
                    for s, d in enumerate(self.mesh)]
            self.map, self.loop, self.track, closed, n_inl = self._events(
                self.map, self.loop, self.track, gens, vocab_do, kf_ids,
                cands, loop_do, self.sync)
            vocab_do = np.zeros(self.n_seq, bool)
            for s in range(self.n_seq):
                if loop_do[s] and recs[s] is not None:
                    recs[s]["loop_inliers"] = int(n_inl[s])
                    if closed[s]:
                        self.n_loops_closed[s] += 1
                        recs[s]["event"] = "loop_closed"
                        done[s] = True

    # ------------------------------------------------------------------
    def trajectory(self, s: int):
        """Anchored trajectory of sequence ``s`` (see
        ``SlamSystem.trajectory``); culled reference keyframes resolve
        through the sequence's own cull chain."""
        self.flush()
        m = self.map[s]
        out = anchor_trajectory(
            np.stack(self.poses_twc[s]), self.frame_refs[s],
            self.cull_chain[s], m.kf_pose.cpu().numpy(),
            m.kf_valid.cpu().numpy(), m.kf_seq.cpu().numpy(),
        )
        return np.asarray(self.timestamps[s]), out

    def n_keyframes(self, s: int) -> int:
        return int(torch.sum(self.map[s].kf_valid))

    def n_points(self, s: int) -> int:
        return int(torch.sum(self.map[s].pt_valid))


def run_sequences(cfg: SlamConfig, frame_lists, mesh=None, seed: int = 0,
                  chunk: int = 8) -> BatchedSlamSystem:
    """Run S sequences in lockstep; ``frame_lists[s]`` = [(ts, rgb, depth)].

    Sequences may have unequal lengths (real TUM runs do): each runs to its
    own end, and a finished one rides along inactive, with no work and no
    record.  ``mesh`` (``seq_mesh``) places the sequences; by default all
    on the working card."""
    n_seq = len(frame_lists)
    T = max(len(f) for f in frame_lists)
    eng = BatchedSlamSystem(cfg, n_seq, mesh=mesh, seed=seed, chunk=chunk)
    for t in range(T):
        active = [t < len(frame_lists[s]) for s in range(n_seq)]
        idx = [min(t, len(frame_lists[s]) - 1) for s in range(n_seq)]
        eng.feed([frame_lists[s][idx[s]][0] for s in range(n_seq)],
                 [frame_lists[s][idx[s]][1] for s in range(n_seq)],
                 [frame_lists[s][idx[s]][2] for s in range(n_seq)],
                 active=active)
    eng.flush()
    return eng
