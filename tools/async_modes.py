"""Host cost of local mapping on the CUDA card, mode by mode, in turns.

    python tools/async_modes.py [--rounds 2]

Runs the 120-frame full-width orbit of ``chip_smoke.py`` phase 3 in six
modes: ``inline`` (local BA in the keyframe event), ``async`` and
``stream`` (deferred solves on the tracking stream / a second stream),
each solve replayed from a CUDA graph, as the engine runs them on a card,
and ``inline-eager`` / ``async-eager`` / ``stream-eager`` (the same with
the solves enqueued eagerly, as on the CPU: the graph factories,
``local_ba.inline_graph`` and the engine's ``DeferredBaGraph``, are
replaced by ones that return None).  Each round runs the modes in one order and then in the
reverse, so that a drift of the host's speed falls on every mode alike.
Prints each run's report (``chip_smoke.run_mode``: fps after the 10-frame
warm-up, host ms of keyframe frames, of other frames and of flushes, host
syncs per frame, ATE, events, launches), whether every mode's trajectory
equals the ``async`` run's bit for bit and each eager mode's its graph
mode's, the card's name and power limit,
and one JSON line of medians per mode.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

MODES = ("inline", "inline-eager", "async-eager", "async", "stream",
         "stream-eager")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from boslam_tpu_torch import slam as slam_mod
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.io import synthetic
    from boslam_tpu_torch.ops import frontend_cuda as fc
    from boslam_tpu_torch.solvers import local_ba

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    fc.build_kernels()
    cfg = SlamConfig()
    traj = synthetic.orbit_trajectory(chip_smoke.N_FRAMES, radius=0.6,
                                      yaw_amplitude=0.3)
    frames = synthetic.render_sequence(cfg.camera, traj, depth_noise=0.01,
                                       seed=0)
    graph_factory = slam_mod.DeferredBaGraph
    inline_factory = local_ba.inline_graph
    reports = {m: [] for m in MODES}
    ests = {}
    order = list(MODES) + list(reversed(MODES))
    for _ in range(args.rounds):
        for mode in order:
            eager = mode.endswith("-eager")
            if eager:
                slam_mod.DeferredBaGraph = local_ba.inline_graph = \
                    lambda cfg, state: None
            try:
                _, rep, est = chip_smoke.run_mode(
                    cfg, traj, frames, mode.split("-")[0], fc)
            finally:
                slam_mod.DeferredBaGraph = graph_factory
                local_ba.inline_graph = inline_factory
            reports[mode].append(rep)
            ests.setdefault(mode, est)
    same = {m: bool(np.array_equal(ests[m], ests["async"])) for m in MODES}
    print(f"trajectory bit-equal to the async run's: {json.dumps(same)}")
    same = {m: bool(np.array_equal(ests[m], ests[m.split("-")[0]]))
            for m in MODES if m.endswith("-eager")}
    print(f"eager solves' trajectory bit-equal to the graph's: "
          f"{json.dumps(same)}")
    print(card)
    keys = ("fps_after_warmup", "kf_frame_host_ms_median",
            "other_frame_host_ms_median", "flush_host_ms_median",
            "flush_host_ms_max", "host_syncs_per_frame", "ate_m")
    print(json.dumps({"card": card, "runs_per_mode": 2 * args.rounds,
                      "medians": {m: {k: float(np.median([r[k] for r in rs]))
                                      for k in keys}
                                  for m, rs in reports.items()}}))


if __name__ == "__main__":
    main()
