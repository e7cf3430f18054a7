"""ctypes bindings for the native (C++) data loader.

A copy of rvio_tpu/dataio/native_loader.py that builds the repository's
native/dataloader.cpp on first use (g++ -O3 -shared, linked against system
zlib) into the port's git-ignored build directory (rvio_tpu_torch/build/).
Where the toolchain is missing the build raises (OSError or
subprocess.CalledProcessError); the replay drivers then decode with the
pure-python codec and record that choice (DriverResult.decoder).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "dataloader.cpp")
_SO = os.path.join(_PKG, "build", "librvio_dataloader.so")

_lib = None
_lock = threading.Lock()


def _build() -> str:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        # build beside the target and rename, so a concurrent process never
        # loads a half-written library
        tmp = f"{_SO}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                 "-fPIC", _SRC, "-o", tmp, "-lz", "-lpthread"],
                check=True, capture_output=True)
            os.replace(tmp, _SO)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return _SO


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.rvio_png_info.argtypes = [ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_int)]
            lib.rvio_png_info.restype = ctypes.c_int
            lib.rvio_png_decode.argtypes = [ctypes.c_char_p,
                                            ctypes.POINTER(ctypes.c_uint8),
                                            ctypes.c_long]
            lib.rvio_png_decode.restype = ctypes.c_int
            lib.rvio_batch_create.argtypes = [ctypes.c_int]
            lib.rvio_batch_create.restype = ctypes.c_void_p
            lib.rvio_batch_submit.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_char_p]
            lib.rvio_batch_wait.argtypes = [ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_uint8),
                                            ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int]
            lib.rvio_batch_wait.restype = ctypes.c_int
            lib.rvio_batch_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def decode_png_gray(path: str) -> np.ndarray:
    """Decode one PNG to (H, W) uint8 via the native library."""
    lib = get_lib()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.rvio_png_info(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise IOError(f"failed to read PNG header: {path}")
    out = np.empty((h.value, w.value), np.uint8)
    rc = lib.rvio_png_decode(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size)
    if rc != 0:
        raise IOError(f"failed to decode PNG ({rc}): {path}")
    return out


class BatchLoader:
    """Threaded image prefetcher — the native InputBuffer equivalent.

    Decodes batches of frames concurrently with filter compute
    (reference role: src/rvio/InputBuffer.{h,cc} + the ROS spinner threads).
    """

    def __init__(self, n_threads: int = 4):
        self._lib = get_lib()
        self._pool = self._lib.rvio_batch_create(n_threads)
        self._inflight: Optional[int] = None
        self._shape = None

    def submit(self, paths: List[str], width: int, height: int) -> None:
        assert self._inflight is None, "previous batch not collected"
        for i, p in enumerate(paths):
            self._lib.rvio_batch_submit(self._pool, i, p.encode())
        self._inflight = len(paths)
        self._shape = (height, width)

    def collect(self) -> np.ndarray:
        assert self._inflight is not None
        h, w = self._shape
        out = np.empty((self._inflight, h, w), np.uint8)
        rc = self._lib.rvio_batch_wait(
            self._pool, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            w, h, self._inflight)
        if rc != 0:
            raise IOError(f"batch decode failed ({rc})")
        self._inflight = None
        return out

    def close(self) -> None:
        if self._pool:
            self._lib.rvio_batch_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
