"""BENCHMARK.json against the contract's character rules and against the
files the harness finds by name."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = core.benchmark()


def _all_names():
    yield from (c["name"] for c in BENCH["configs"])
    for w in BENCH["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"])
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_all_names())))
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    for key in ("layer",):
        if key in metric:
            assert 1 <= len(metric[key]) <= 200 and "\n" not in metric[key]


def test_top_level_keys_and_limits():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_listed_files_are_found_by_name():
    assert sorted(c["name"] for c in BENCH["configs"]) == core.names("configs")
    assert sorted(w["name"] for w in BENCH["workloads"]) == core.names("workloads")
    assert sorted(m["name"] for m in BENCH["per_layer"]) == core.names("metrics", ".py")
    used = {w["traffic"] for w in BENCH["workloads"]}
    assert used == set(core.names("traffic"))
    for c in BENCH["configs"]:
        spec = core.load_json("configs", c["name"])
        assert c["file"] == f"slambench/configs/{c['name']}.json"
        assert c["source"] == spec["source"] and c["reduced"] == spec["reduced"]
    for w in BENCH["workloads"]:
        spec = core.cell(w["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert spec[key] == w[key]
        assert callable(core.runner(spec["traffic_spec"]["kind"]).run)
        assert set(spec["limits"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_files_agree_with_the_listing(metric):
    mod = core.metric_module(metric["name"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    moved = e2e[metric["moves"]]
    assert set(metric["workloads"]) <= set(moved.get("workloads",
                                                     metric["workloads"]))
    assert mod.read({}) is None  # nothing to read: nothing reported


THIN_RUNNER = """import frames


def run(spec, **kw):
    import boslam_tpu_torch.slam as slam_module

    return frames.run_cell(spec, [frames.LocalBaProbe(slam_module)], **kw)
"""


@pytest.mark.parametrize("kind", ["frames", "thin"])
def test_a_dropped_in_cell_is_found_without_edits(tmp_path, kind):
    """A cell, and with a new kind its mix and runner module, added as
    files to a copy of the checkout: found by name, and with a new kind
    rehearsed to a result line, with no file of the copy edited."""
    root = tmp_path / "checkout"
    shutil.copytree(core.HERE, root / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    extra = dict(core.load_json("workloads", "hall.live"), why="an extra cell")
    bench = root / "slambench"
    if kind != "frames":
        mix = dict(core.load_json("traffic", "hall_replay_chunk1"), kind=kind)
        (bench / "traffic" / "thin_mix.json").write_text(json.dumps(mix))
        (bench / f"{kind}.py").write_text(THIN_RUNNER)
        extra["traffic"] = "thin_mix"
    (bench / "workloads" / "hall.extra.json").write_text(json.dumps(extra))
    code = ("import core; c = core.cell('hall.extra'); "
            "print(c['config_spec']['slam']['orb']['n_features'], "
            "'hall.extra' in core.names('workloads'), "
            "core.runner(c['traffic_spec']['kind']).__name__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=bench,
                         capture_output=True, text=True, check=True).stdout
    assert out.split() == ["512", "True", kind]
    if kind != "frames":
        # The program is the checkout's; this copy holds the harness only.
        env = dict(os.environ, PYTHONPATH=str(core.ROOT))
        p = subprocess.run(
            [sys.executable, "slambench/run.py", "--workload", "hall.extra",
             "--seed", str(2**31 + 21), "--seconds", "1", "--device", "cpu"],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["attempted"] >= 8, line
    assert all(p.read_bytes() == b for p, b in before.items())


def test_without_the_program_the_run_fails(tmp_path):
    """A directory of BENCHMARK.json and slambench/ alone prints no result."""
    root = tmp_path / "bare"
    shutil.copytree(core.HERE, root / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(core.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for device in ("cuda", "cpu"):
        p = subprocess.run(
            [sys.executable, "slambench/run.py", "--workload", "hall.live",
             "--seed", "1", "--seconds", "1", "--device", device],
            cwd=root, capture_output=True, text=True, timeout=300)
        assert p.returncode != 0 and p.stdout.strip() == ""
