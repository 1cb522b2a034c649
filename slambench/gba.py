"""The global-BA cell: solve after solve of one seeded synthetic problem
through ``solvers.global_ba.global_bundle_adjustment``.

Set-up makes the problem (``problem.make``), puts it on the device as the
engine's map and runs one solve.  The window runs solves, each from the
same perturbed map, until its seconds are up; a solve is timed to a device
synchronization.  The traced run profiles one more solve.  The check, once
the window has closed and the program's state is freed, holds the last
solve to the plain reference (``reference.ba``, float64): its reported
costs against the objective evaluated at its input and at its output, and
its output's cost against that of the reference's own LM solve.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

import problem
import profiling
from reference import ba as ref_ba


def _program_map(cfg, raw, device):
    from boslam_tpu_torch.mapping.map_state import empty_map

    st = empty_map(cfg, device)
    t = {k: torch.from_numpy(np.asarray(raw[k])).to(device) for k in (
        "kf_pose", "kf_uv", "kf_depth", "kf_kpv", "kf_valid", "kf_seq",
        "pt_xyz", "pt_valid")}
    return st._replace(
        kf_pose=t["kf_pose"], kf_uv=t["kf_uv"], kf_depth=t["kf_depth"],
        kf_obs_pt=torch.from_numpy(raw["kf_obs"]).to(device),
        kf_kp_valid=t["kf_kpv"], kf_valid=t["kf_valid"], kf_seq=t["kf_seq"],
        n_kf=torch.tensor(raw["n_kf"], dtype=torch.int32, device=device),
        pt_xyz=t["pt_xyz"], pt_valid=t["pt_valid"])


def _reference_solve(slam_cfg, raw, lm_iters, dtype, device, tf32=False):
    """The reference's LM in ``dtype`` (float32 products in TF32 with
    ``tf32``) from the problem's raw arrays: (poses, points, cost before,
    cost after)."""
    cam = ref_ba.camera(slam_cfg)
    e = ref_ba.edges_from_map(raw, slam_cfg["orb"]["scale_factor"], dtype, device)
    poses = torch.from_numpy(raw["kf_pose"]).to(device, dtype)
    pts = torch.from_numpy(raw["pt_xyz"]).to(device, dtype)
    opt = torch.from_numpy(raw["kf_valid"]).to(device)
    opt[0] = False
    return ref_ba.levenberg_marquardt(cam, poses, pts, e, opt, lm_iters, tf32)


def run(spec, *, seed, seconds, trace, device, rehearsal, control, t_start):
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.solvers.global_ba import global_bundle_adjustment
    from boslam_tpu_torch.tracking.tracker import HostSync

    on_card = device.type == "cuda"
    slam_cfg = spec["config_spec"]["slam"]
    tr = dict(spec["traffic_spec"])
    if rehearsal:
        tr.update(tr["rehearsal"])
    cfg = SlamConfig.from_dict(slam_cfg)
    raw = problem.make(tr, slam_cfg, seed)
    lm_iters, cg_iters = tr["lm_iters"], tr["cg_iters"]

    if control == "reference_tf32":
        # The reference in the program's place, in float32, its products
        # in TF32.
        def solve():
            p, x, c0, c1 = _reference_solve(slam_cfg, raw, lm_iters,
                                            torch.float32, device, tf32=True)
            return (p, x), (c0, c1, [0] * lm_iters)
    else:
        state = _program_map(cfg, raw, device)

        def solve():
            out, stats = global_bundle_adjustment(
                cfg, state, lm_iters=lm_iters, cg_iters=cg_iters,
                sync=HostSync())
            return (out.kf_pose, out.pt_xyz), (stats.cost0, stats.cost1,
                                               list(stats.pcg_steps))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    solve()
    sync()
    setup_s = time.perf_counter() - t_start

    solves, pcg = 0, []
    t_open = time.perf_counter()
    while time.perf_counter() - t_open < seconds:
        result, stats = solve()
        sync()
        solves += 1
        pcg += stats[2]
    window_s = time.perf_counter() - t_open

    run_rec = {"kind": "gba", "lm_iters": solves * lm_iters, "pcg_steps": pcg}
    extra = {}
    if trace and on_card:
        _, prof = profiling.traced(solve)
        run_rec["profile_solve"] = prof
        extra = {"busy_s": prof["busy_s"], "window_s": prof["window_s"],
                 "breakdown": {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}}
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    # The check: the last solve of the window against the reference.
    out_poses = result[0].detach().cpu().double()
    out_pts = result[1].detach().cpu().double()
    cost0, cost1 = float(stats[0]), float(stats[1])
    del result, stats, solve
    if control != "reference_tf32":
        del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    f64 = torch.float64
    cam = ref_ba.camera(slam_cfg)
    e = ref_ba.edges_from_map(raw, slam_cfg["orb"]["scale_factor"], f64, device)
    ref_in = float(ref_ba.cost(cam, torch.from_numpy(raw["kf_pose"]).to(device, f64),
                               torch.from_numpy(raw["pt_xyz"]).to(device, f64), e))
    ref_out = float(ref_ba.cost(cam, out_poses.to(device), out_pts.to(device), e))
    _, _, _, ref_best = _reference_solve(slam_cfg, raw, lm_iters, f64, device)
    values = {
        "cost0_rel_gap": abs(cost0 - ref_in) / ref_in,
        "cost1_rel_gap": abs(cost1 - ref_out) / ref_out,
        "cost_excess": ref_out / float(ref_best) - 1.0,
    }
    e2e = {"gba_lm_iters_per_s": solves * lm_iters / window_s,
           "setup_s": setup_s}
    return dict(e2e=e2e, run=run_rec, values=values, attempted=solves,
                failed=0 if np.isfinite(cost1) else 1,
                memory_peak=memory_peak, **extra)
