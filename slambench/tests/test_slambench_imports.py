"""Nothing the harness runs imports JAX or the JAX package, and the
reference imports nothing of the port.  Top-level module names are
compared whole: ``boslam_tpu_torch`` begins with ``boslam_tpu`` and is not
it."""

import ast
import sys
from pathlib import Path

import pytest

import core

HARNESS = sorted(p for p in core.HERE.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((core.HERE / "reference").glob("*.py"))


def _top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: p.name)
def test_harness_imports_no_jax(path):
    assert not _top_level_imports(path) & set(core.FORBIDDEN)


@pytest.mark.parametrize("path", REFERENCE + [core.HERE / "render.py",
                                              core.HERE / "problem.py",
                                              core.HERE / "kernels.py",
                                              core.HERE / "profiling.py"],
                         ids=lambda p: p.name)
def test_reference_and_frozen_copies_import_nothing_of_the_port(path):
    assert "boslam_tpu_torch" not in _top_level_imports(path)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    fake = type(sys)("fake")
    for name in ("boslam_tpu_torch_extra", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert core.forbidden_modules() == [m for m in core.FORBIDDEN
                                        if m in {n.split(".")[0]
                                                 for n in sys.modules}]
    monkeypatch.setitem(sys.modules, "boslam_tpu.sub", fake)
    assert "boslam_tpu" in core.forbidden_modules()
