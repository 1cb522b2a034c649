"""Per-frame metric records to JSONL and TensorBoard, their summary, and a
``torch.profiler`` trace of a run (``boslam_tpu.utils.metrics``).

Every frame appends a dict (n_matches, n_inliers, track state, BA cost
before/after, timings) to ``SlamSystem.metrics``; these helpers write and
aggregate them.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
from typing import Iterable, Optional


class JsonlWriter:
    def __init__(self, path: str):
        self._f = open(path, "a", buffering=1)

    def write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec, default=float) + "\n")

    def close(self) -> None:
        self._f.close()


def dump_metrics(path: str, metrics: Iterable[dict]) -> None:
    with open(path, "w") as f:
        for m in metrics:
            f.write(json.dumps(m, default=float) + "\n")


# A trace records PROFILE_FRAMES frames after two (the first frame builds
# the kernels, the second warms the profiler up).  The eager engine runs
# ~11k device operations a frame: 8 frames at 640x480 made a 191 MB trace
# on an H100.
PROFILE_FRAMES = 4


@contextlib.contextmanager
def profile_trace(logdir: Optional[str], sync=None):
    """``torch.profiler`` trace of a run, written into ``logdir`` as a
    Chrome/TensorBoard trace (``*.pt.trace.json``) when ``logdir`` is given.
    Yields ``step``, to be called after each frame.  With ``sync``, a
    recording ``HostSync``, the spans it closed meanwhile are written
    beside the trace as Chrome trace events on the trace's clock
    (``logdir/spans.json``)."""
    if not logdir:
        yield lambda: None
        return
    import torch
    from torch.profiler import (
        ProfilerActivity, profile, schedule, tensorboard_trace_handler,
    )

    from boslam_tpu_torch.utils import timing

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(
        activities=acts,
        schedule=schedule(skip_first=1, wait=0, warmup=1,
                          active=PROFILE_FRAMES, repeat=1),
        on_trace_ready=tensorboard_trace_handler(logdir),
    ) as prof:
        before = timing.clock_pair()
        yield prof.step
        after = timing.clock_pair()
    if sync is not None:
        traces = sorted(glob.glob(os.path.join(logdir, "*.pt.trace.json")),
                        key=os.path.getmtime)
        base = timing.trace_base_ns(traces[-1]) if traces else 0
        events = timing.chrome_events(sync.drain(),
                                      timing.clock_map(before, after), base)
        with open(os.path.join(logdir, "spans.json"), "w") as f:
            json.dump({"displayTimeUnit": "ms", "baseTimeNanoseconds": base,
                       "traceEvents": events}, f)


def summarize(metrics: list) -> dict:
    """Aggregate a run's metric records."""
    frames = [m for m in metrics if "n_inliers" in m]
    kf = [m for m in metrics
          if m.get("event") == "keyframe" or m.get("event") == "loop_closed"]
    out = {
        "n_frames": len(metrics),
        "n_keyframe_events": len(kf),
        "n_lost": sum(1 for m in metrics if m.get("lost", False)),
        "n_loops": sum(1 for m in metrics if m.get("event") == "loop_closed"),
    }
    if frames:
        inl = [m["n_inliers"] for m in frames]
        out["mean_inliers"] = sum(inl) / len(inl)
    dts = [m["dt_ms"] for m in metrics if "dt_ms" in m]
    if dts:
        dts_sorted = sorted(dts)
        out["median_frame_ms"] = dts_sorted[len(dts) // 2]
        out["p90_frame_ms"] = dts_sorted[int(len(dts) * 0.9)]
    return out


# Scalar fields of a frame record mirrored to TensorBoard; each event type
# becomes a 0/1 scalar, so keyframe/loop/lost activity reads as a timeline.
_TB_SCALARS = ("n_inliers", "n_matches", "n_visible", "dt_ms",
               "ba_cost0", "ba_cost1", "ba_edges", "loop_score",
               "loop_inliers")
_TB_EVENTS = ("keyframe", "loop_closed", "lost", "relocalize")


def export_tensorboard(logdir: str, metrics: Iterable[dict]) -> str:
    """Mirror per-frame metric records as TensorBoard scalars with the
    ``tensorboard`` package's event-file writer (imported here: the package
    is optional).  Returns the logdir."""
    from tensorboard.compat.proto.event_pb2 import Event
    from tensorboard.compat.proto.summary_pb2 import Summary
    from tensorboard.summary.writer.event_file_writer import EventFileWriter

    w = EventFileWriter(logdir)
    try:
        for step, m in enumerate(metrics):
            values = [
                Summary.Value(tag=f"frame/{k}", simple_value=float(m[k]))
                for k in _TB_SCALARS if k in m
            ]
            ev_name = m.get("event")
            values += [
                Summary.Value(
                    tag=f"event/{name}",
                    simple_value=float(bool(
                        ev_name == name
                        or (name == "lost" and m.get("lost", False))
                    )),
                )
                for name in _TB_EVENTS
            ]
            if values:
                w.add_event(Event(
                    wall_time=float(m.get("ts", step)), step=step,
                    summary=Summary(value=values),
                ))
    finally:
        w.close()
    return logdir
