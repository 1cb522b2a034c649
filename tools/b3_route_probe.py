"""Probe the routes for kernel B3's distance stage on the card.

    python tools/b3_route_probe.py [--n 512] [--m 65536]

Builds ``tools/b3_routes.cu`` once per route (``-DROUTE=0..3``: the
``__popc`` loop, ``mma.sync`` m16n8k256 b1, ``wgmma`` m64n128k32 u8 on bits
unpacked in shared memory, ``wgmma`` m64n128k256 b1), all ``nvcc`` runs
started together with ``-Xptxas -v``; a route that does not build is
reported with the compiler's words.  Each built route then runs in its own
process (a faulting launch cannot spoil the others): one launch at N x M
random 256-bit descriptors, the per-row smallest (distance, column) held
exactly against ``hamming_matrix_mxu`` + argmin, and its device ms by
CUDA-graph replay (the ``wgmma`` descriptors: no swizzle, 16-byte rows of
8-row core matrices, the leading offset along K, the stride along M/N).
Last, the shipped kernel's
two passes are timed apart under ``torch.profiler`` (dense, windowed and
live-map problems of ``chip_smoke.py``).  Prints one JSON line per route,
one for the shipped kernel, and the card's name and power limit.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ROUTES = ("popc", "mma_b1", "wgmma_u8", "wgmma_b1")
SRC = ROOT / "tools" / "b3_routes.cu"
OUT = ROOT / "build" / "b3_probe"


def build() -> dict:
    from boslam_tpu_torch.ops.build import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(ROUTES):
        lib = OUT / f"lib{name}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", f"-DROUTE={i}", "-o",
               str(lib), str(SRC)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        print(f"[nvcc {name}] exit {proc.returncode}\n{log}", flush=True)
        if proc.returncode == 0:
            built[name] = lib
    return built


def run_route(name: str, n: int, m: int) -> dict:
    import numpy as np
    import torch

    from boslam_tpu_torch.matching import hamming
    from chip_smoke import device_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    da = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    db = rng.integers(0, 2**32, size=(m, 8), dtype=np.uint64).astype(np.uint32)
    rows = rng.permutation(n)[: n // 2]
    cols = rng.choice(m, size=rows.size, replace=False)
    db[cols] = da[rows] ^ (np.uint32(1) << rng.integers(0, 32, (rows.size, 8)).astype(np.uint32))
    a = torch.from_numpy(da.view(np.int32)).to(dev)
    b = torch.from_numpy(db.view(np.int32)).to(dev)
    dist = hamming.hamming_matrix_mxu(a, b)
    ref_d, ref_i = torch.min(dist, dim=1)  # first index of the minimum
    lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    fn = lib.b3_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tiles = m // 128
    part = torch.empty((tiles, n), dtype=torch.int32, device=dev)

    def launch():
        err = fn(a.data_ptr(), n, b.data_ptr(), m, part.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed, CUDA error {err}")
    part.fill_(-1)
    launch()
    torch.cuda.synchronize()
    key = part.long() & 0xFFFFFFFF
    col = (key & 255) + 128 * torch.arange(tiles, device=dev)[:, None]
    best = ((key >> 8) << 32 | col).min(dim=0).values
    res = dict(route=name, n=n, m=m, equal=bool(
        torch.equal(best >> 32, ref_d.long())
        and torch.equal(best & 0xFFFFFFFF, ref_i.long())))
    if res["equal"]:
        res["ms"] = device_ms(launch)
    res["plain_ms"] = device_ms(
        lambda: torch.min(hamming.hamming_matrix_mxu(a, b), dim=1), iters=3)
    return res


def profile_shipped() -> dict:
    """Device ms per call of each of the shipped B3's two kernels
    (``torch.profiler``), dense and on a live map, at chip_smoke's
    problems."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from boslam_tpu_torch.ops import hamming_cuda as hc

    dev = torch.device("cuda")
    kw = dict(max_dist=50, ratio=0.85, mutual=True)
    out = {}
    for name, prob in (
            ("dense", cs.match_problem(dev, 512, 65536, True)),
            ("window", cs.match_problem(dev, 512, 65536, False)),
            ("live_map", cs.match_problem(dev, 512, 65536, True,
                                          live=cs.LIVE_SLOTS))):
        for _ in range(5):
            hc.fused_match_top2(*prob, **kw)
        torch.cuda.synchronize()
        calls = 50
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                hc.fused_match_top2(*prob, **kw)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = ev.cuda_time_total
            if "kernel" in ev.key and dev_us:
                out[f"{name}:{ev.key}"] = dev_us / calls / 1e3
    return out


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--m", type=int, default=65536)
    p.add_argument("--run", choices=ROUTES + ("shipped",))
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        sys.exit(2)
    if args.run == "shipped":
        print(json.dumps(profile_shipped()), flush=True)
        return
    if args.run:
        print(json.dumps(run_route(args.run, args.n, args.m)), flush=True)
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    built = build()
    for name in ROUTES + ("shipped",):
        if name != "shipped" and name not in built:
            print(json.dumps(dict(route=name, built=False)), flush=True)
            continue
        r = subprocess.run([sys.executable, __file__, "--run", name, "--n",
                            str(args.n), "--m", str(args.m)],
                           capture_output=True, text=True, cwd=ROOT,
                           env=dict(os.environ))
        out = r.stdout.strip().splitlines()
        print(out[-1] if r.returncode == 0 and out else json.dumps(dict(
            route=name, built=True, exit=r.returncode,
            error=(r.stderr or r.stdout)[-2000:])), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
