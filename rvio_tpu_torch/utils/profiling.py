"""Profiling instrumentation: spans, counts and the Chrome-trace exporter.

Port of rvio_tpu/utils/profiling.py.  The reference records two wall-clock
numbers per frame into time_cost.dat (reference: System.cc:253-260,
376-379); the drivers here do the same.  This module is the port's one
tracing layer besides them:

- :class:`span` times a block of host code (``time.perf_counter_ns``)
  into process-wide totals by name.  While a torch profiler is running,
  and only then, it also opens a profiler range of the same name, so the
  span lands in the same Kineto trace as the CUDA activity, on its clock,
  and names the host work under the device's idle gaps.  A span adds no
  synchronization, copy or device operation; spans sit at chunk and
  graph-launch granularity, never inside a frame body or anything a CUDA
  graph captures.
- :func:`add` counts (poses, frames) beside the spans.
- :func:`totals` reads both, :func:`reset` clears them; :func:`mark`
  keeps a copy of them at the end of a driver's call, so that a reader
  can take the totals of a run of calls (:func:`marks`).
- :func:`device_trace` traces the host and the card around a block and
  writes a Chrome trace (viewable in Perfetto); ``run.py --profile``.

Spans of the program, each with the metric that reads it, are listed in
PERF.md (section 3).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

_lock = threading.Lock()
_totals: Dict[str, List[int]] = {}     # name -> [nanoseconds, count]
# name -> the totals at the end of each of the last MARKS_KEPT calls
_marks: Dict[str, Deque[Dict[str, Tuple[int, int]]]] = {}
MARKS_KEPT = 4096


class span:
    """``with span(name, **args):`` adds the block's host time and one to
    the totals of ``name``.  Under a running torch profiler the block is
    also a profiler range ``name`` with ``args`` (small ints or strings,
    such as the pass and chunk index) as its arguments; a Chrome trace
    shows them where the profiler records shapes (:func:`device_trace`)."""

    __slots__ = ("name", "args", "t0", "rf")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args
        self.rf = None

    def __enter__(self) -> "span":
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _RecordFunctionFast(self.name, [], self.args)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        with _lock:
            t = _totals.get(self.name)
            if t is None:
                _totals[self.name] = [dt, 1]
            else:
                t[0] += dt
                t[1] += 1
        return False


def add(name: str, n: int = 1) -> None:
    """Count ``n`` more of ``name`` (a count has no seconds)."""
    with _lock:
        t = _totals.get(name)
        if t is None:
            _totals[name] = [0, int(n)]
        else:
            t[1] += int(n)


def count(name: str) -> int:
    """The count of ``name`` so far: spans closed, or what :func:`add`
    added."""
    with _lock:
        t = _totals.get(name)
        return 0 if t is None else t[1]


def totals() -> Dict[str, Dict[str, float]]:
    """A copy of every total: ``{name: {"s": seconds, "n": count}}`` (a
    count's seconds are 0)."""
    with _lock:
        return {k: {"s": ns * 1e-9, "n": n} for k, (ns, n) in _totals.items()}


def mark(name: str) -> None:
    """Keep a copy of the totals as they stand at the end of one call
    ``name`` (a pass of a driver's loop; the last ``MARKS_KEPT`` of each
    name), so that the totals over any run of calls are a difference of
    two marks (:func:`marks`)."""
    with _lock:
        got = {k: (ns, n) for k, (ns, n) in _totals.items()}
        _marks.setdefault(name, deque(maxlen=MARKS_KEPT)).append(got)


def marks(name: str) -> List[Dict[str, Tuple[int, int]]]:
    """The kept marks of ``name``, oldest first: each ``{span or count:
    (nanoseconds, count)}``."""
    with _lock:
        return list(_marks.get(name, ()))


def reset() -> None:
    """Clear every total and mark."""
    with _lock:
        _totals.clear()
        _marks.clear()


@contextlib.contextmanager
def device_trace(path: str):
    """Trace the host and the CUDA device (where there is one) around a
    code block with torch.profiler, shapes and span arguments included;
    writes the Chrome trace to ``path``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=True) as prof:
        yield prof
    prof.export_chrome_trace(path)
