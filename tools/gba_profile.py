"""Where global BA's time goes on the card: the bench's 50k-landmark
synthetic problem (``chip_smoke.py`` phase 7a's input) under
``torch.profiler``.

    python tools/gba_profile.py [--lm-iters 6] [--cg-iters 40] [--top 15]

After a warm-up solve it prints, as JSON lines: the solve's ms by stage
(assembly, CG, the rest: back-substitution, retraction and cost; CUDA
events); the solve's ms with the CG loop in its shipped form (the exit
read on the host each iteration) and in the other form (the carry frozen
on the device, always the cap), three of each in turns; then, under
``torch.profiler``, one whole solve and 20 CG applications
(``_schur_matvec``): the device's busy ms, its idle share over the solve,
and the operators whose kernels take the most device time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402


def top_ops(prof, n):
    """(name, calls, device ms in all) of the ``n`` PyTorch operators whose
    kernels take the most device time, and the device's busy ms in all
    (the kernels' own rows, so that no time is counted twice)."""
    ops, busy = [], 0.0
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += ms
        elif ms > 0:
            ops.append((e.key, e.count, ms))
    ops.sort(key=lambda r: -r[2])
    return ops[:n], busy


def pcg_frozen(matvec, b, Minv_blocks, iters, rtol=1e-2, sync=None):
    """The other form of the CG loop: always ``iters`` iterations, the
    carry frozen by ``torch.where`` once the exit condition holds, so no
    host read.  Same result as ``global_ba._pcg``; kept here only to time
    what the shipped form's host reads cost."""
    def apply_M(r):
        return torch.einsum("cij,cj->ci", Minv_blocks, r)

    x = torch.zeros_like(b)
    r = b
    z = apply_M(r)
    p = z
    tol = (rtol * rtol) * torch.sum(r * r)
    for _ in range(iters):
        live = torch.sum(r * r) > tol
        Ap = matvec(p)
        rz = torch.sum(r * z)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-12)
        r_new = r - alpha * Ap
        z_new = apply_M(r_new)
        beta = torch.sum(r_new * z_new) / torch.clamp(rz, min=1e-12)
        x = torch.where(live, x + alpha * p, x)
        p = torch.where(live, z_new + beta * p, p)
        r = torch.where(live, r_new, r)
        z = torch.where(live, z_new, z)
    return x, iters


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lm-iters", type=int, default=6)
    ap.add_argument("--cg-iters", type=int, default=40)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import chip_smoke
    from boslam_tpu_torch.solvers import global_ba as gba
    from boslam_tpu_torch.tracking.tracker import HostSync

    if not torch.cuda.is_available():
        sys.exit("no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg, st, _ = chip_smoke.gba_problem(dev)

    # Stage times by CUDA events, wrapped around the module's functions.
    stage = {"assemble": [], "pcg": []}
    orig = {name: getattr(gba, name) for name in ("_assemble", "_pcg")}

    def timed(name, key):
        def wrap(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = orig[name](*a, **k)
            e1.record()
            stage[key].append((e0, e1))
            return out
        return wrap

    def solve():
        return gba.global_bundle_adjustment(
            cfg, st, lm_iters=args.lm_iters, cg_iters=args.cg_iters,
            sync=HostSync())

    solve()
    torch.cuda.synchronize()
    gba._assemble, gba._pcg = timed("_assemble", "assemble"), timed("_pcg", "pcg")
    try:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        _, stats = solve()
        e1.record()
        torch.cuda.synchronize()
    finally:
        gba._assemble, gba._pcg = orig["_assemble"], orig["_pcg"]
    total = e0.elapsed_time(e1)
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in stage.items()}
    ms["rest"] = total - ms["assemble"] - ms["pcg"]
    print(json.dumps(dict(card=torch.cuda.get_device_name(0), solve_ms=total,
                          stage_ms=ms, pcg_steps=list(stats.pcg_steps))),
          flush=True)

    # The CG loop's two forms, in turns: host read per iteration (shipped)
    # and frozen carry (no read, always the cap).
    def timed_solve():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st2, s = solve()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b), s, st2

    forms = {"host_read": [], "frozen": []}
    results = {}
    for form in ("host_read", "frozen", "frozen", "host_read",
                 "host_read", "frozen"):
        gba._pcg = pcg_frozen if form == "frozen" else orig["_pcg"]
        try:
            ms_, s, st2 = timed_solve()
        finally:
            gba._pcg = orig["_pcg"]
        forms[form].append(ms_)
        results[form] = (float(s.cost1), st2.kf_pose)
    same = torch.equal(results["host_read"][1], results["frozen"][1])
    print(json.dumps(dict(
        pcg_form_solve_ms=forms, cost1={k: v[0] for k, v in results.items()},
        kf_pose_bit_equal=same)), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, busy = top_ops(prof, args.top)
    print(json.dumps(dict(what="solve", wall_ms_profiled=wall, device_busy_ms=busy,
                          idle_share=1 - busy / wall, top=rows)), flush=True)

    # One CG application on the first LM iteration's system.
    P = st.pt_xyz.shape[0]
    K, N = st.kf_obs_pt.shape
    edges = gba.build_global_edges(cfg, st)
    sched = gba._point_schedule(edges, P)
    mask = st.kf_valid & (torch.arange(K, device=dev) > 0)
    terms = gba._assemble(cfg, st.kf_pose, st.pt_xyz, edges, sched, mask,
                          torch.tensor(1e-4, device=dev),
                          cfg.local_ba.huber_delta, K, N)
    _, Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d, _, Hpp_inv, _ = terms
    x = torch.randn(K, 6, device=dev) * mask[:, None]
    margs = (Jc, J_pt, w, Jc_s, Jp_s, w_s, Hcc_d, Hpp_inv, edges, sched, K, N)
    for _ in range(3):
        gba._schur_matvec(x, *margs)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(20):
            gba._schur_matvec(x, *margs)
        torch.cuda.synchronize()
    rows, busy = top_ops(prof, args.top)
    print(json.dumps(dict(what="cg_application x20", device_busy_ms=busy,
                          top=rows)), flush=True)


if __name__ == "__main__":
    main()
