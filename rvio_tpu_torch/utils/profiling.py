"""Profiling instrumentation.

Port of rvio_tpu/utils/profiling.py.  The reference records two wall-clock
numbers per frame into time_cost.dat (reference: System.cc:253-260,
376-379); the drivers here do the same.  For kernel-level analysis this
module wraps a torch.profiler trace (a Chrome trace, viewable in Perfetto)
and provides a stage timer: on the CPU a host clock, on a CUDA device a
pair of CUDA events around the stage on the current stream, read when the
report is made, so timing a stage adds no synchronization to the loop.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List


@contextlib.contextmanager
def device_trace(path: str):
    """Trace the host and the CUDA device (where there is one) around a
    code block with torch.profiler; writes the Chrome trace to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)


class StageTimer:
    """Accumulating stage timer.

    ``stage(name)`` times its block: with ``device`` a CUDA device, by CUDA
    events recorded on the current stream (the device's time between
    them, read at :meth:`report`); otherwise by the host clock.
    """

    def __init__(self, device=None):
        import torch
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._events: Dict[str, List[tuple]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.cuda:
            import torch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._events[name].append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def _settle(self) -> None:
        """Fold the recorded event pairs into the totals (waits for them)."""
        for name, pairs in self._events.items():
            for start, end in pairs:
                end.synchronize()
                self.totals[name] += start.elapsed_time(end) / 1e3
        self._events.clear()

    def report(self) -> str:
        self._settle()
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            ms = self.totals[name] * 1e3
            lines.append(f"{name:28s} {ms:10.2f} ms total "
                         f"{ms / max(n, 1):8.3f} ms/call x{n}")
        return "\n".join(lines)
