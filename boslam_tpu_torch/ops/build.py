"""Build and bind the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` into ``build/boslam_tpu_torch/`` at the repository root, one
shared library per source with a plain C interface, and bound with
``ctypes``.  A library's name carries a hash of its source and flags, so a
stale build is never loaded.  ``LAUNCHES`` counts kernel launches by name;
each wrapper adds one where it launches its kernel, and nowhere else.  It
also counts local BA's CUDA-graph replays and captures
(``local_ba_graph``, ``local_ba_capture``; ``solvers.local_ba.SolveGraph``).
``launch_floor`` is no kernel of the port: an empty kernel built the same
way, for measuring what one launch costs on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "boslam_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# Kernel name -> (source file, C entry point, ctypes argtypes).  The two
# frontend entries take a pointer to a host-side level table first
# (``ops.frontend_cuda``), and ``pose_gn`` one to its arguments
# (``ops.pose_cuda``), which the entry copies into the launch.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "fast_rank": ("fast_rank.cu", "boslam_fast_rank",
                  [_P, _F, _F, _F, _I, _P]),
    "extract_patches": ("describe_patches.cu", "boslam_describe_patches",
                        [_P, _P, _P, _P, _P, _P]),
    "fused_match": ("fused_match.cu", "boslam_fused_match",
                    [_P, _P, _P, _P, _I, _P, _P, _P, _I, _F, _F, _I, _P, _P,
                     _P, _P, _P, _P, _P]),
    "pose_gn": ("pose_gn.cu", "boslam_pose_gn", [_P, _P]),
}

_SOURCES = dict(KERNELS, launch_floor=("launch_floor.cu", "boslam_launch_floor",
                                       [_P]))

LAUNCHES = {name: 0 for name in (*KERNELS, "local_ba_graph",
                                 "local_ba_capture")}
BUILD_LOGS: dict = {}  # name -> the compiler's report of a verbose build
_LIBS: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def _lib_path(name: str) -> Path:
    src = _CSRC / _SOURCES[name][0]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}.{digest}.so"


def build_kernels(names=None, verbose: bool = False) -> dict:
    """Compile the named sources (default: every kernel and the empty
    ``launch_floor``) that are not built yet, one ``nvcc`` per source, all
    started together.  Returns {name: .so path}.  ``verbose`` adds
    ``-Xptxas -v``, prints the compiler's report and keeps it in
    ``BUILD_LOGS``."""
    names = list(_SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(_CSRC / _SOURCES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if verbose and log:
            BUILD_LOGS[name] = log
            print(f"[nvcc {name}]\n{log}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: _lib_path(name) for name in names}


def kernel_fn(name: str):
    """The bound C entry point of kernel ``name``, built at first use."""
    with _LOCK:
        if name not in _LIBS:
            path = build_kernels([name])[name]
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, _SOURCES[name][1])
            fn.argtypes = _SOURCES[name][2]
            fn.restype = ctypes.c_int
            _LIBS[name] = (lib, fn)
        return _LIBS[name][1]


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
