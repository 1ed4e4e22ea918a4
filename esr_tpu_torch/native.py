"""Native host kernels of the event data path: ``csrc/host_kernels.cpp``
built with ``g++`` at first use and bound with ``ctypes`` (counterpart of
``esr_tpu/native/__init__.py``).

The library goes to ``esr_tpu_torch/_build/``, named by a hash of the
source and flags, built with OpenMP when the compiler has it and without
it otherwise. Each binding returns ``None`` when the library is
unavailable (no compiler, a failed build, or ``ESR_TPU_NATIVE=0`` in the
environment, read at every call), exactly where the reference does; the
callers in ``data/np_encodings.py`` then take their numpy twins. ctypes
releases the GIL for the duration of each call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host_kernels.cpp"
BUILD_DIR = _PKG / "_build"
_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_N = ctypes.c_int64


class HostLibrary:
    """The built and loaded library, once per process."""

    def __init__(self, source: Path):
        self.source = source
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._tried = False
        self._lock = threading.Lock()

    def _build(self) -> Tuple[Optional[Path], str]:
        """The library's path (``None`` when it does not build) and the
        compiler's output."""
        tag = hashlib.sha256(self.source.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
        so_path = BUILD_DIR / f"libhost_kernels_{tag}.so"
        if so_path.exists():
            return so_path, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        log = ""
        try:
            # without OpenMP when the compiler has none, as the reference
            for flags in (_FLAGS, tuple(f for f in _FLAGS if f != "-fopenmp")):
                try:
                    proc = subprocess.run(["g++", *flags, str(self.source), "-o", tmp],
                                          capture_output=True, text=True, timeout=120)
                except (OSError, subprocess.TimeoutExpired) as e:
                    return None, log + f"{e}\n"
                log += proc.stdout + proc.stderr
                if proc.returncode == 0:
                    os.replace(tmp, so_path)
                    return so_path, log
            return None, log
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def load(self) -> Optional[ctypes.CDLL]:
        """The library, or ``None`` when it is unavailable. The build runs
        outside ``_lock``, which guards only ``_tried`` and ``_lib``: two
        threads that both find the library missing build it twice, each
        into its own temp file that ``os.replace`` publishes whole, and
        the first to finish is the one kept."""
        if os.environ.get("ESR_TPU_NATIVE", "1") == "0":
            return None
        with self._lock:
            if self._tried:
                return self._lib
        so, log = self._build()
        lib = _declare(ctypes.CDLL(str(so))) if so is not None else None
        with self._lock:
            if not self._tried:
                self._tried, self._lib = True, lib
                self.build_log += log
            return self._lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.rasterize_counts.argtypes = [_F32, _F32, _F32, _N, _N, _N, _F32]
    lib.rasterize_stack.argtypes = [_F32, _F32, _F32, _F32, _N, _N, _N, _N, _F32]
    lib.rescatter_counts.argtypes = [_F32, _F32, _F32, _N, _N, _N, _F32]
    lib.rasterize_counts_batch.argtypes = [_F32, _F32, _F32, _I64, _N, _N, _N, _F32]
    for fn in (lib.rasterize_counts, lib.rasterize_stack, lib.rescatter_counts,
               lib.rasterize_counts_batch):
        fn.restype = None
    return lib


LIBRARY = HostLibrary(SOURCE)


def available() -> bool:
    return LIBRARY.load() is not None


def _c32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _same_length(*arrays) -> int:
    n = len(arrays[0])
    if any(len(a) != n for a in arrays):
        raise ValueError(f"event arrays differ in length: {[len(a) for a in arrays]}")
    return n


def rasterize_counts(xs, ys, ps, sensor_size) -> Optional[np.ndarray]:
    """``[H, W, 2]`` count image (positive, negative), or ``None``."""
    lib = LIBRARY.load()
    if lib is None:
        return None
    h, w = sensor_size
    xs, ys, ps = _c32(xs), _c32(ys), _c32(ps)
    out = np.zeros((h, w, 2), np.float32)
    lib.rasterize_counts(xs, ys, ps, _same_length(xs, ys, ps), h, w, out)
    return out


def rasterize_stack(xs, ys, ts, ps, num_bins, sensor_size) -> Optional[np.ndarray]:
    """``[H, W, num_bins]`` signed stack, half-open time bins, or ``None``."""
    lib = LIBRARY.load()
    if lib is None:
        return None
    h, w = sensor_size
    xs, ys, ts, ps = _c32(xs), _c32(ys), _c32(ts), _c32(ps)
    out = np.zeros((h, w, num_bins), np.float32)
    lib.rasterize_stack(xs, ys, ts, ps, _same_length(xs, ys, ts, ps), num_bins, h, w, out)
    return out


def rescatter_counts(xs_norm, ys_norm, ps, sensor_size) -> Optional[np.ndarray]:
    """Coordinates in [0, 1) scaled onto ``sensor_size`` and counted:
    ``[H, W, 2]``, or ``None``."""
    lib = LIBRARY.load()
    if lib is None:
        return None
    h, w = sensor_size
    xs, ys, ps = _c32(xs_norm), _c32(ys_norm), _c32(ps)
    out = np.zeros((h, w, 2), np.float32)
    lib.rescatter_counts(xs, ys, ps, _same_length(xs, ys, ps), h, w, out)
    return out


def rasterize_counts_batch(xs, ys, ps, offsets, sensor_size) -> Optional[np.ndarray]:
    """Concatenated events and ``offsets [items + 1]`` -> ``[items, H, W,
    2]``, items in parallel (OpenMP), or ``None``."""
    lib = LIBRARY.load()
    if lib is None:
        return None
    h, w = sensor_size
    xs, ys, ps = _c32(xs), _c32(ys), _c32(ps)
    n = _same_length(xs, ys, ps)
    offsets = np.ascontiguousarray(offsets, np.int64)
    if offsets.ndim != 1 or len(offsets) < 1 or offsets[0] < 0 or offsets[-1] > n or (
            np.diff(offsets) < 0).any():
        raise ValueError("offsets must rise from >= 0 to <= the number of events")
    items = len(offsets) - 1
    out = np.zeros((items, h, w, 2), np.float32)
    lib.rasterize_counts_batch(xs, ys, ps, offsets, items, h, w, out)
    return out
