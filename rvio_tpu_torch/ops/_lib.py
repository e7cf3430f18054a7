"""Build, load and call the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (``build/lib<name>-<hash>.so``, the hash
covering the source, the shared ``csrc/common.cuh`` and the flags, so a
stale library is never loaded) and
bound with ``ctypes``.  Nothing is built or loaded at import: the first
launch builds what it needs, and :func:`build` compiles every library at
once, one ``nvcc`` process per source.

Every exported C function takes device pointers, sizes, scalars and the
CUDA stream, launches on that stream without synchronizing, and returns
``cudaGetLastError()``; :func:`call` raises on a non-zero code.

Each wrapper counts its launches in ``<wrapper>.launches`` through
:func:`launched`.  A call made while a CUDA graph is being captured
launches nothing: it goes to the capture's tally (:func:`tally`), and each
replay of the graph adds the tally to the counts (runtime/graph.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("propagate_block", "lm_triangulate", "jac_project", "spd_solve",
           "tile_gather", "lk_level", "subpix_refine", "shi_tomasi_nms",
           "clahe", "ekf_tail", "ekf_tail_wide")
HEADER = "common.cuh"      # included by every source
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}
_capture = threading.local()      # .tally: the capture under way, if any


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or under /usr/local/cuda)")
    return path


def library_path(name: str) -> Path:
    src = b"".join((CSRC / f).read_bytes() for f in (f"{name}.cu", HEADER))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{h}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library of ``names`` not built yet, all nvcc processes
    at once.  Returns each compiled source's nvcc log (register and shared
    memory use from ``-Xptxas -v``)."""
    BUILD.mkdir(exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        logs = {}
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
            os.replace(tmp, out)
            logs[name] = log
        return logs
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def function(lib: str, symbol: str, argtypes) -> object:
    """The C function ``symbol`` of library ``lib``, built and loaded on
    first use, with its ctypes signature set (returns an int error code)."""
    key = f"{lib}:{symbol}"
    fn = _fns.get(key)
    if fn is None:
        handle = _libs.get(lib)
        if handle is None:
            path = library_path(lib)
            if not path.exists():
                build([lib])
            handle = _libs[lib] = ctypes.CDLL(str(path))
            handle.rvio_error_string.argtypes = [ctypes.c_int]
            handle.rvio_error_string.restype = ctypes.c_char_p
        fn = getattr(handle, symbol)
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def call(lib: str, fn, *args, device: torch.device) -> None:
    """Launch ``fn(*args, stream)`` on the current stream; raise on error."""
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = _libs[lib].rvio_error_string(err).decode()
        raise RuntimeError(f"{lib} kernel launch failed: {msg} ({err})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def uses_kernel(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor
    (the plain version runs); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel and no plain path for tensors on "
                     f"{t.device}")


def check(name: str, arg: str, t: torch.Tensor, shape, dtype,
          device: torch.device) -> None:
    """Raise unless ``t`` is what the kernel takes."""
    if t.device != device:
        raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype} {arg}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")


def launched(wrapper: Callable) -> None:
    """Count one launch of ``wrapper``'s kernel: in ``wrapper.launches``,
    or, while this thread captures a CUDA graph (:func:`tally`), in the
    capture's tally."""
    counts = getattr(_capture, "tally", None)
    if counts is None:
        wrapper.launches += 1
    else:
        counts[wrapper] = counts.get(wrapper, 0) + 1


@contextmanager
def tally():
    """Within the block, launches go to the dict it yields (wrapper ->
    launches captured) and not to the wrappers' counts."""
    if getattr(_capture, "tally", None) is not None:
        raise RuntimeError("a capture is already under way on this thread")
    _capture.tally = counts = {}
    try:
        yield counts
    finally:
        _capture.tally = None
