"""Run one benchmark cell once and print its result line.

    python3 slambench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell is
``slambench/workloads/CELL.json``; its traffic mix's ``kind`` names the
module beside this file that runs it (``core.runner``).  The last line on
standard output is one JSON object with ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number of the correctness check beside its limit,
which also end standard error.  Without a CUDA card, or with fewer cards
than the cell needs, it exits 3 and prints no result; it exits 4 if JAX
or the JAX package was loaded.

``--device cpu`` rehearses a cell on the plain path at the mix's small
``rehearsal`` size; such a line has no device numbers and is no
measurement.  ``--control program_tf32`` runs the program with TF32 on and
``--control reference_tf32`` puts the reference, in float32 with TF32 on,
in the program's place: the controls that the correctness limits were
set against, never run by a measurement.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import core  # noqa: E402


def _args(argv):
    ap = argparse.ArgumentParser(prog="slambench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--control", choices=("program_tf32", "reference_tf32"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    spec = core.cell(args.workload)
    sys.path.insert(1, str(core.ROOT))  # the program under test
    # Build and kernel caches at fixed paths inside the checkout.
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(core.ROOT / "build" / "slambench" / sub)
    import torch

    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < spec["chips"]):
        print(f"slambench: {spec['chips']} CUDA card(s) needed, found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device(args.device)
    # The configurations state float32 with TF32 off.
    tf32 = args.control == "program_tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_num_threads(min(4, os.cpu_count() or 1))

    runner = core.runner(spec["traffic_spec"]["kind"])
    res = runner.run(spec, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=device,
                     rehearsal=args.device == "cpu", control=args.control,
                     t_start=T_START)

    found = core.forbidden_modules()
    if found:
        print(f"slambench: the run loaded {found}", file=sys.stderr)
        return 4
    bench = core.benchmark()
    if args.device == "cuda":
        res["run"]["card"] = torch.cuda.get_device_name(0)
    if args.trace:
        metrics = core.per_layer(res["run"], args.workload, bench["per_layer"])
    else:
        metrics = {m["name"]: {"value": float(res["e2e"][m["name"]]),
                               "unit": m["unit"]}
                   for m in core.listed(bench["end_to_end"], args.workload)}
    if args.device == "cuda":
        from kernels import power_limit_w

        device_rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                      "count": spec["chips"],
                      "memory_peak_bytes": int(res["memory_peak"]),
                      "power_limit_w": power_limit_w()}
        if args.trace:
            device_rec.update(busy_s=res["busy_s"], window_s=res["window_s"])
    else:
        device_rec = {"platform": "cpu", "kind": "rehearsal", "count": 0,
                      "memory_peak_bytes": 0}
    correct, checks = core.judge(res["values"], spec["limits"])
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device_rec}
    if args.trace and "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    core.print_checks(checks)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
