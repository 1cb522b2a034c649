"""What the harness finds by name, and the line it prints.

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``), a traffic mix (``traffic/<mix>.json``), the
chips it needs, why it exists and the limits of its correctness check.
The mix's ``kind`` names the module that runs the cell, ``<kind>.py``
beside this one (``runner``), which has a ``run`` callable.  Per-layer
metrics are ``metrics/<metric>.py`` files, each with a ``read(run)`` that
returns a number or None; its unit, layer and the end-to-end metric it
moves are its entry in ``BENCHMARK.json``.
Nothing here imports the port.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "boslam_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def names(kind: str, suffix: str = ".json"):
    return sorted(p.name[:-len(suffix)] for p in (HERE / kind).glob(f"*{suffix}"))


def cell(name: str) -> dict:
    """The cell with its configuration and mix resolved."""
    spec = load_json("workloads", name)
    return dict(spec, name=name, config_spec=load_json("configs", spec["config"]),
                traffic_spec=load_json("traffic", spec["traffic"]))


def runner(kind: str):
    """The module that runs a mix of this ``kind``: ``<kind>.py`` beside
    this file, imported by its own name as ``run.py``'s modules are."""
    if not (kind.isidentifier() and (HERE / f"{kind}.py").is_file()):
        raise ValueError(f"no runner {kind}.py in {HERE}")
    return importlib.import_module(kind)


def metric_module(name: str):
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def listed(entries, cell_name: str):
    """The metric entries of BENCHMARK.json that this cell reports."""
    return [m for m in entries if cell_name in m.get("workloads", [cell_name])]


def per_layer(run: dict, cell_name: str, entries) -> dict:
    """The per-layer metrics whose reader finds something in ``run``."""
    out = {}
    for m in listed(entries, cell_name):
        value = metric_module(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``boslam_tpu_torch`` is not ``boslam_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def judge(values: dict, limits: dict):
    """(correct, checks): each number compared beside its limit; a number
    that is missing or not finite fails."""
    checks, ok = {}, True
    for key, limit in limits.items():
        v = values.get(key)
        good = v is not None and math.isfinite(v) and v <= limit
        ok &= good
        checks[key] = {"value": v, "limit": limit}
    return ok, checks


def print_checks(checks: dict) -> None:
    for key, c in checks.items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
