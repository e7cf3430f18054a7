"""Arithmetic the per-layer metric readers (metrics/*.py) share.  A
reader returns None where its run has nothing for it to read: an
untraced run, another kind of traced stretch, or no launch counted."""

from __future__ import annotations


def summary(run, kind: str):
    s = run.trace_summary
    if s is None or s.get("kind") != kind or not s.get("poses"):
        return None
    return s


def launches_per_pose(run, kind: str):
    s = summary(run, kind)
    return None if s is None else s["launches"] / s["poses"]


def layer_ms_per_pose(run, kind: str, layer: str):
    s = summary(run, kind)
    return None if s is None else s["by_layer"][layer] * 1e3 / s["poses"]


def roofline_share(run, kind: str):
    """The counted hand kernels' least time over their device time, %."""
    s = summary(run, kind)
    if s is None or not s["counted_s"]:
        return None
    return 100.0 * s["least_s"] / s["counted_s"]


def idle_share(run, kind: str):
    s = summary(run, kind)
    if s is None:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def counter(run, name: str):
    return run.counters.get(name)
