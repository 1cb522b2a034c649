"""ctypes bindings for the native dataset runtime (``runtime/loader.cpp``,
``boslam_tpu.runtime.native``).

The shared library is built at first use with ``make`` and g++ (it links
libpng) into ``build/boslam_tpu_torch/runtime/`` at the repository root,
under a name that carries a hash of its source, so a stale build is never
loaded.  ``available()`` is False when the toolchain or libpng is missing;
``io.tum.sequence(native=True)`` then raises, and ``native=None`` falls
back to cv2.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "boslam_tpu_torch" / "runtime"
_LOCK = threading.Lock()
_state: dict = {}  # "lib": the loaded CDLL or None once a build failed


def lib_path() -> Path:
    digest = hashlib.sha256(
        (_SRC / "loader.cpp").read_bytes() + (_SRC / "Makefile").read_bytes()
    ).hexdigest()[:12]
    return BUILD_DIR / f"libboslam_runtime.{digest}.so"


def _build(path: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["make", "-s", "-C", str(_SRC), f"OUT={tmp}"],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return True


def _load() -> Optional[ctypes.CDLL]:
    with _LOCK:
        if "lib" in _state:
            return _state["lib"]
        path = lib_path()
        lib = None
        if path.exists() or _build(path):
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                lib = None
        if lib is not None:
            lib.loader_create.restype = ctypes.c_void_p
            lib.loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int, ctypes.c_int,
            ]
            lib.loader_next.restype = ctypes.c_int
            lib.loader_next.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ]
            lib.loader_destroy.restype = None
            lib.loader_destroy.argtypes = [ctypes.c_void_p]
            lib.decode_rgb_gray.restype = ctypes.c_int
            lib.decode_rgb_gray.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.decode_depth.restype = ctypes.c_int
            lib.decode_depth.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.POINTER(ctypes.c_float),
            ]
        _state["lib"] = lib
        return lib


def available() -> bool:
    """Whether the library builds (or is built) and loads."""
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_frame(
    rgb_path: str, depth_path: str, width: int, height: int,
    depth_factor: float = 5000.0,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(gray f32 [H,W] in [0,255], depth f32 metres [H,W]), or None when the
    library is unavailable or a file does not decode at width x height."""
    lib = _load()
    if lib is None:
        return None
    gray = np.empty((height, width), np.float32)
    depth = np.empty((height, width), np.float32)
    ok1 = lib.decode_rgb_gray(rgb_path.encode(), width, height, _fptr(gray))
    ok2 = lib.decode_depth(depth_path.encode(), width, height, depth_factor,
                           _fptr(depth))
    if not (ok1 and ok2):
        return None
    return gray, depth


class NativeLoader:
    """Prefetching frame stream backed by the C++ worker pool: yields
    (gray, depth) in the order of the paths; an unreadable frame is
    skipped."""

    def __init__(
        self,
        rgb_paths: List[str],
        depth_paths: List[str],
        width: int,
        height: int,
        depth_factor: float = 5000.0,
        n_threads: int = 3,
        capacity: int = 8,
    ):
        if len(rgb_paths) != len(depth_paths):
            raise ValueError("rgb_paths and depth_paths differ in length")
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._w, self._h = width, height
        self._n = len(rgb_paths)
        # loader_create copies the path strings.
        rgb = (ctypes.c_char_p * self._n)(*[p.encode() for p in rgb_paths])
        dep = (ctypes.c_char_p * self._n)(*[p.encode() for p in depth_paths])
        self._handle = lib.loader_create(
            rgb, dep, self._n, width, height, ctypes.c_float(depth_factor),
            n_threads, capacity,
        )

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for _ in range(self._n):
            gray = np.empty((self._h, self._w), np.float32)
            depth = np.empty((self._h, self._w), np.float32)
            rc = self._lib.loader_next(self._handle, _fptr(gray), _fptr(depth))
            if rc < 0:
                return
            if rc == 0:
                continue  # unreadable frame: skip
            yield gray, depth

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
