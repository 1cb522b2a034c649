"""The kidnap cells: a camera whose sensor is covered and carried elsewhere
while the engine runs (TUM RGB-D fr2/360_kidnap's class), fed through
``SlamSystem.feed`` with ``frames.py``'s stages.

The mix's ``pass`` lists segments of the rendered path: ``{"path": [a,
b]}`` feeds path frames a..b-1, with the segment's ``covered`` offsets
blank (gray 0, depth 0) while the path goes on; ``{"carried": k}`` feeds k
blank frames while the camera is moved, and the next segment picks the
path up elsewhere.  A frame's timestamp is its position over ``fps``.  The
pass replays on a fresh engine, as ``frames.Stream`` does.  The warm-up
feeds the pass's first ``warmup_frames`` positions, which hold the cold
start's cover (relocalization against the whole map, kernel B3), and on
until the vocabulary is trained, then two blank frames and the last view
again (the BoW candidates), and drops the engine.

``MatchProbe`` wraps ``tracking.tracker.fused_match_top2``, the name the
whole-map match calls, and copies on the device the inputs and outputs of
the window's last calls (no host read); the check holds the last one that
had a frame row to match to ``reference.relocalization.match``.  The
traced stage profiles ``trace_frames`` positions after the window and the
first ``trace_cold_frames`` positions of a fresh engine, so that the
trace holds the cold start's B3 launches.  The check adds to
``frames.check``'s ``kp_mismatch`` and the local-BA gaps:

- ``ate_m``: the RMSE over every position with a tracked or relocalized
  pose (blanks and still-lost positions left out) after a rigid float64
  alignment, the largest over the engines' passes;
- ``reloc_pose_err_m``: the largest camera-centre error of a successful
  relocalization under that engine's alignment;
- ``kidnaps_unrecovered``: engines that fed a cover's whole uncovered
  stretch (to the next cover or the pass's end) without a successful
  relocalization;
- ``lost_frames``: losses at positions with no blank (a cover's first
  blank loses the track by design);
- ``reloc_match_mismatch``: the share of the probed call's frame rows
  whose (index, match) differ from the reference's;
- ``reloc_refine_gap``: ``RefineProbe`` keeps the window's last solve that
  recovered a pose, and the reference's float64 damped Gauss-Newton from
  the program's pose lowers motion-only BA's robust cost over the edges
  under their bound by this share: a refined pose sits at the minimum,
  RANSAC's does not.
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import numpy as np
import torch

import frames
import render
from reference import relocalization as ref_reloc

ST_OK = 1      # the engine's status after a frame with a pose
KEEP_CALLS = 4  # whole-map calls the probe keeps: a cover's last is blank


class Pass(NamedTuple):
    frames: list         # (ts, u8 gray, u16 depth) a position
    truth: np.ndarray    # [P, 7] camera-to-world poses; NaN while carried
    blank: np.ndarray    # [P] bool
    covers: list         # [(first, end)] runs of blank positions


def build_pass(rendered, poses, segments, fps: float) -> Pass:
    """The pass from the rendered path's frames and poses."""
    _, g0, d0 = rendered[0]
    dark = (np.zeros_like(g0), np.zeros_like(d0))
    out, truth, blank = [], [], []
    for seg in segments:
        if "carried" in seg:
            n = seg["carried"]
            out += [dark] * n
            truth += [np.full(7, np.nan)] * n
            blank += [True] * n
            continue
        covered = set(seg.get("covered", ()))
        for k, i in enumerate(range(*seg["path"])):
            out.append(dark if k in covered else rendered[i][1:])
            truth.append(poses[i])
            blank.append(k in covered)
    blank = np.array(blank)
    edges = np.flatnonzero(np.diff(np.r_[0, blank.astype(np.int8), 0]))
    return Pass([(p / fps, g, d) for p, (g, d) in enumerate(out)],
                np.array(truth), blank,
                [(int(a), int(b)) for a, b in zip(edges[::2], edges[1::2])])


def stretches(ps: Pass):
    """[(first, end)] each cover's uncovered stretch: from its end to the
    next cover or the pass's end."""
    ends = [a for a, _ in ps.covers[1:]] + [len(ps.frames)]
    return [(b, e) for (_, b), e in zip(ps.covers, ends)]


class MatchProbe:
    """The whole-map match as relocalization calls it, watched from
    outside: while ``on``, ``calls`` holds the newest calls' inputs, settings
    and outputs, copied on the device."""

    def __init__(self, tracker_module):
        self.module = tracker_module
        self.match = tracker_module.fused_match_top2
        self.calls, self.on = [], False
        tracker_module.fused_match_top2 = self

    def __call__(self, *args, **kw):
        out = self.match(*args, **kw)
        if self.on:
            self.calls = self.calls[1 - KEEP_CALLS:] + [(
                tuple(a.clone() for a in args), dict(kw),
                tuple(o.clone() for o in out))]
        return out

    def close(self):
        self.module.fused_match_top2 = self.match

    def probed(self):
        """The last call with a valid frame row, or None."""
        live = [c for c in self.calls if bool(c[0][3].any())]
        return live[-1] if live else None

    def values(self, slam_cfg, device):
        """No whole-map call in the window: the number is missing."""
        call = self.probed()
        if call is None:
            return {}
        args, kw, (idx, ok, _) = call
        ref_idx, ref_ok = ref_reloc.match(*(a.to(device) for a in args), **kw)
        share = ref_reloc.row_mismatch(idx.to(device), ok.to(device), ref_idx,
                                       ref_ok)
        print(f"[slambench] last whole-map match: {args[0].shape[0]} rows "
              f"({int(args[3].sum())} valid) x {args[4].shape[0]} slots "
              f"({int(args[6].sum())} visible); {int(ok.sum())} matches, "
              f"reference {int(ref_ok.sum())}; rows differing {share}",
              file=sys.stderr, flush=True)
        return {"reloc_match_mismatch": share}

    def shape(self):
        call = self.probed()
        if call is None:
            return None
        args = call[0]
        return {"n": args[0].shape[0], "m": args[4].shape[0],
                "v": int(args[6].sum())}


class RefineProbe:
    """Relocalization's solve (``tracking.tracker._reloc_solve``: RANSAC
    PnP and the refine over the candidates), watched from outside: while
    ``on``, ``last`` holds the inputs and outputs of the newest call with a
    recovered pose, kept on the device by a select (no host read)."""

    def __init__(self, tracker_module):
        self.module = tracker_module
        self.solve = tracker_module._reloc_solve
        self.last, self.on = None, False
        tracker_module._reloc_solve = self

    def __call__(self, cfg, pts_w, feats, ok, key):
        good, pose, n_inl = self.solve(cfg, pts_w, feats, ok, key)
        if self.on:
            new = (pts_w, ok, feats.uv, feats.depth, feats.has_depth,
                   feats.octave, good, pose, n_inl)
            if self.last is None:
                self.last = tuple(a.clone() for a in new)
            else:
                take = good.any()
                self.last = tuple(torch.where(take, a, b)
                                  for a, b in zip(new, self.last))
        return good, pose, n_inl

    def close(self):
        self.module._reloc_solve = self.solve

    def values(self, slam_cfg, device):
        """No recovered pose in the window: the number is missing."""
        if self.last is None or not bool(self.last[6].any()):
            return {}
        pts_w, ok, uv, depth, hd, octave, good, pose, n_inl = (
            a.to(device) for a in self.last)
        best = int(torch.argmax(torch.where(good, n_inl, -1)))
        gap, edges = ref_reloc.refine_gap(slam_cfg, pose[best], pts_w[best],
                                          uv, depth, hd, ok[best], octave)
        print(f"[slambench] last recovered relocalization: candidate {best}, "
              f"{int(n_inl[best])} inliers, {edges} edges under their bound; "
              f"refine gap {gap:.3g}", file=sys.stderr, flush=True)
        return {"reloc_refine_gap": gap}


def setup(spec, *, seed, trace, device, rehearsal):
    """``frames.setup`` without its warm-up on the path, then the pass's
    own warm-up: (frames.Setup over the pass, the Pass)."""
    tr = spec["traffic_spec"]
    plan = tr["rehearsal"] if rehearsal else tr
    cold = dict(tr, warmup_frames=0,
                rehearsal=dict(tr["rehearsal"], warmup_frames=0))
    st = frames.setup(dict(spec, traffic_spec=cold), seed=seed, trace=trace,
                      device=device, rehearsal=rehearsal)
    ps = build_pass(st.frames, st.truth.poses_twc, plan["pass"], tr["fps"])
    dark = ps.frames[ps.covers[0][0]]
    warm = st.make_engine()
    for f in ps.frames[:plan["warmup_frames"]]:
        warm.feed(*f)
    # On to the vocabulary's first training, within the first stretch.
    pos = plan["warmup_frames"]
    while not bool(warm.loop.vocab_ready) and pos < stretches(ps)[0][1]:
        warm.feed(*ps.frames[pos])
        pos += 1
    for f in (dark, dark, ps.frames[pos - 1]):
        warm.feed(*f)
    warm.flush()
    paths = [(r.get("reloc_whole_map"), r["reloc_ok"]) for r in warm.metrics
             if r.get("event") == "relocalize"]
    print(f"[slambench] warm-up relocalizations (whole map, ok): {paths}",
          file=sys.stderr, flush=True)
    del warm
    if device.type == "cuda":
        torch.cuda.synchronize()
    ts = np.array([f[0] for f in ps.frames])
    return frames.Setup(ps.frames, render.Trajectory(ps.truth, ts), st.cfg,
                        st.make_engine), ps


def counters(win: frames.Window, ps: Pass):
    """The engines' relocalization counters over the window, and the covers
    they fed the start of; None where the program has no counters."""
    engines = win.stream.engines
    if not all(hasattr(e, "n_reloc_tries") for e in engines):
        return None
    fed = [len(e.metrics) for e in engines]
    return {"tries": sum(e.n_reloc_tries for e in engines),
            "ok": sum(e.n_reloc_ok for e in engines),
            "whole_map": sum(e.n_reloc_whole_map for e in engines),
            "covers": sum(n > a for n in fed for a, _ in ps.covers)}


def kidnap_values(engines, ps: Pass) -> dict:
    """The trajectory's numbers over every engine's fed positions."""
    ate = err_max = 0.0
    unrecovered = lost = 0
    for k, slam in enumerate(engines):
        recs = slam.metrics
        n = len(recs)
        if not n:
            continue
        _, est = slam.trajectory()
        blank = ps.blank[:n]
        posed = np.array([r["status"] == ST_OK for r in recs]) & ~blank
        lost += sum(1 for r, b in zip(recs, blank) if r["lost"] and not b)
        ok_at = [i for i, r in enumerate(recs)
                 if r.get("event") == "relocalize" and r["reloc_ok"]]
        rmse = None
        if posed.sum() >= 3:
            rmse, errs = ref_reloc.centre_errors(est[:, 4:], ps.truth[:n, 4:],
                                                 posed, ok_at)
            ate = max(ate, rmse)
            err_max = max([err_max] + errs)
        missed = [(a, e) for a, e in stretches(ps)
                  if n >= e and not any(a <= i < e for i in ok_at)]
        unrecovered += bool(missed)
        whole = [i for i in ok_at if recs[i].get("reloc_whole_map")]
        print(f"[slambench] engine {k}: {n} positions, relocalized at "
              f"{ok_at} (whole map at {whole}), ate {rmse}, covers "
              f"unrecovered {missed}", file=sys.stderr, flush=True)
    return {"ate_m": ate, "reloc_pose_err_m": err_max,
            "kidnaps_unrecovered": float(unrecovered),
            "lost_frames": float(lost)}


def run(spec, **kw):
    import boslam_tpu_torch.slam as slam_module
    import boslam_tpu_torch.tracking.tracker as tracker

    probes = [frames.LocalBaProbe(slam_module), MatchProbe(tracker),
              RefineProbe(tracker)]
    try:
        return _run(spec, probes, **kw)
    finally:
        for p in probes:
            p.close()


def _run(spec, probes, *, seed, seconds, trace, device, rehearsal, control,
         t_start):
    from boslam_tpu_torch.ops.build import LAUNCHES

    on_card = device.type == "cuda"
    tr = spec["traffic_spec"]
    st, ps = setup(spec, seed=seed, trace=trace, device=device,
                   rehearsal=rehearsal)
    setup_s = time.perf_counter() - t_start
    n = len(ps.frames)

    b3_before = LAUNCHES["fused_match"]
    for p in probes:
        p.on = True
    win = frames.window(st, seconds, min_frames=n if rehearsal else 0,
                        spans=trace)
    for p in probes:
        p.on = False
    e2e, run_rec = frames._report(win, setup_s, spec["config_spec"]["slam"])
    blank = ps.blank[np.arange(len(win.timed)) % n]  # each engine from 0
    recs = [r for _, r, _ in win.timed]
    run_rec["reloc_frame_s"] = [
        t for (t, r, _), b in zip(win.timed, blank)
        if r.get("event") == "relocalize" and not b]
    rc = counters(win, ps)
    if rc is not None:
        run_rec["reloc_counts"] = rc
    lost_branch = sum(r.get("event") == "relocalize" for r in recs)
    print(f"[slambench] lost branch on {lost_branch} of {len(recs)} "
          f"positions ({lost_branch / max(len(recs), 1):.3f}); counters "
          f"{rc}; B3 calls {LAUNCHES['fused_match'] - b3_before}",
          file=sys.stderr, flush=True)

    extra = {}
    if trace and on_card:
        prof = frames.traced(win.stream, tr["trace_frames"])
        run_rec["profile_frames"] = prof
        cold = frames.Stream(st.make_engine, st.frames)
        run_rec["profile_cold"] = frames.traced(cold, tr["trace_cold_frames"])
        del cold
        extra = {"busy_s": prof["busy_s"], "window_s": prof["window_s"],
                 "breakdown": {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}}
    match_call = probes[1].shape()
    if match_call is not None:
        run_rec["match_call"] = match_call
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    mine = kidnap_values(win.stream.engines, ps)
    # frames.check's own ate_m and lost_frames are replaced by the pass's:
    # its ATE runs over the positions before the first cover.
    first = dict(tr, check_frames=int(ps.covers[0][0]))
    values = frames.check(dict(spec, traffic_spec=first), st, win.stream,
                          seed=seed, device=device, control=control,
                          probes=probes)
    values.update(mine)
    failed = int(sum(1 for r, b in zip(recs, blank) if r["lost"] and not b))
    return dict(e2e=e2e, run=run_rec, values=values, attempted=len(recs),
                failed=failed, memory_peak=memory_peak, **extra)
