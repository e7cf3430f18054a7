"""The traced sub-window of a ``--trace 1`` run: torch.profiler over a
stretch of the window's own calls, reduced to what the per-layer readers
and the result line's ``device`` and ``breakdown`` take.

A full window launches millions of kernels, more than the profiler can
hold, so each driver traces a stretch of it (a few chunks, or a short call
of the same scan) and says how many poses that stretch returned.
"""

from __future__ import annotations

import bisect
import json
import re
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark import counts

HERE = Path(__file__).resolve().parent
KERNELS = json.loads((HERE / "kernels.json").read_text())["kernels"]


def _pattern(p: str):
    return re.compile(r"(?<![A-Za-z0-9_])" + re.escape(p) + r"(?![A-Za-z0-9_])")


_MATCH = [(_pattern(k["pattern"]), k["k"], k["layer"]) for k in KERNELS]


def classify(name: str):
    """(K-number, layer) of a kernel's profiler name, or (None, None)."""
    for pat, k, layer in _MATCH:
        if pat.search(name):
            return k, layer
    return None, None


class Tracer:
    """``start()`` and ``stop(poses)`` around a stretch of the window;
    each synchronizes the card, so the stretch holds its own work."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.t0 = None
        self.window_s = None
        self.poses = 0

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._sync()
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if self.cuda else []))
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, poses: int) -> None:
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.poses = int(poses)

    @property
    def active(self) -> bool:
        return self.prof is not None and self.window_s is None


def _union_s(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-6


def summarize(tracer: Tracer, cfg, batch: int) -> dict:
    """The stretch's device numbers: busy seconds (the union of the device
    operations' intervals), window seconds, kernel launches, device time
    by K-number and layer, the hand kernels' least times, the top device
    operations and the idle gaps by the host operation under them."""
    events = tracer.prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    cpu = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    intervals = [(e.time_range.start, e.time_range.end) for e in dev]
    kernels = [e for e in dev
               if not e.name.startswith(("Memcpy", "Memset", "[memory]"))]
    by_k, by_layer, by_name = {}, {"tracker": 0.0, "filter": 0.0,
                                   "glue": 0.0}, {}
    least, counted = 0.0, 0.0
    unmatched = set()
    for e in kernels:
        t = (e.time_range.end - e.time_range.start) * 1e-6
        by_name[e.name] = by_name.get(e.name, 0.0) + t
        k, layer = classify(e.name)
        if k is None:
            by_layer["glue"] += t
            unmatched.add(e.name)
            continue
        by_k[k] = by_k.get(k, 0.0) + t
        by_layer[layer] += t
        c = counts.launch_counts(k, cfg, batch)
        if c is not None:
            least += counts.least_seconds(*c)
            counted += t
    for e in dev:
        if e.name.startswith(("Memcpy", "Memset", "[memory]")):
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                (e.time_range.end - e.time_range.start) * 1e-6

    # idle gaps between the device's busy intervals, each named by the
    # innermost host operation running at its middle
    gaps = {}
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [c.time_range.start for c in cpu]
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(starts, mid) - 1
        name = "host, no operation"
        for j in range(i, max(i - 200, -1), -1):
            if cpu[j].time_range.end >= mid:
                name = cpu[j].name
                break
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": _union_s(intervals), "window_s": tracer.window_s,
        "poses": tracer.poses, "launches": len(kernels),
        "by_k": by_k, "by_layer": by_layer,
        "least_s": least, "counted_s": counted,
        "unmatched": sorted(unmatched)[:40],
        "breakdown": {"device_ops": [[n[:120], t] for n, t in top],
                      "idle_gaps": [[n[:120], t] for n, t in idle]},
    }
