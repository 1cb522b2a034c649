"""The traced window: card activity under ``torch.profiler``, read from the
trace's raw events.

``device_events`` is a frozen copy of ``boslam_tpu_torch/utils/timing.py``
(``_profile``, ``_device_events``) at commit bd2752c, extended to keep each
event's interval: the busy time is the union of the intervals (two
streams' overlapping kernels count once), and the idle gaps between them
are named by the operations on either side.  Building the profiler's event
tree for ~10^5 events a frame takes minutes, so only the raw events are
read.  Nothing imports the port.
"""

from __future__ import annotations

import time

import torch


def profiler():
    """A profiler of the card's activity only: recording every host
    operation too would slow the host it measures."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def device_events(prof):
    """[(start ns, end ns, name)] of the kernels, copies and fills."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        t0 = e.start_ns()
        out.append((t0, t0 + e.duration_ns(), e.name()))
    out.sort()
    return out


def summarize(events, wall_s: float, top: int = 10) -> dict:
    """Busy seconds (union of the intervals), operation count, seconds and
    count by name, and the ``top`` longest operations by name and idle gaps
    inside the events' span."""
    busy_ns, n = 0, len(events)
    by_name: dict = {}
    gaps = []
    cur_end, cur_name = None, None
    for t0, t1, name in events:
        rec = by_name.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (t1 - t0) / 1e9
        if cur_end is None or t0 > cur_end:
            if cur_end is not None:
                gaps.append((t0 - cur_end, f"{cur_name[:60]} -> {name[:60]}"))
            busy_ns += t1 - t0
            cur_end, cur_name = t1, name
        elif t1 > cur_end:
            busy_ns += t1 - cur_end
            cur_end, cur_name = t1, name
    gaps.sort(reverse=True)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": wall_s,
        "n_ops": n,
        "by_name": by_name,
        "device_ops": [[k[:120], v[1]] for k, v in ops],
        "idle_gaps": [[name, g / 1e9] for g, name in gaps[:top]],
    }


def traced(fn):
    """Run ``fn()`` under the profiler, the clock ending in a device
    synchronization; returns (fn's result, summary)."""
    torch.cuda.synchronize()
    with profiler() as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    if not events:
        raise RuntimeError("torch.profiler recorded no device activity")
    return out, summarize(events, wall)
