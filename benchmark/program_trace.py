"""Arithmetic the readers of the program's own spans and counts share
(rvio_tpu_torch/utils/profiling.py).

A reader reads the window's passes alone.  The program keeps a copy of
its totals at the end of each driver call (``profiling.mark``: the set
replay's ``replay.pass``, one ``run_sequence_set``; the filter batch's
``sequence_scan.call``, one scan call).  Both drivers make one such call
or more in set-up, one a pass in the window (``run.counters["passes"]``)
and, in a traced run, where alone the readers run, one traced call last.
So the window's totals are the mark before the traced call less the mark
``passes`` calls before it: neither the set-up's first calls nor the
traced call, after whose profiler every graph launch costs more host
time, fall into them.

A program without the marks gives None, as does a span or a pose count
of 0 in the window (no graph runs on the CPU, so ``frame_scan.*`` stays
empty there).
"""

from __future__ import annotations


def marks(call: str):
    """The program's marks of ``call``, or None where it keeps none."""
    try:
        from rvio_tpu_torch.utils.profiling import marks as program_marks
    except ImportError:
        return None
    return program_marks(call)


def window(run, call: str):
    """``{span or count: (nanoseconds, count)}`` over the window's passes,
    or None where the marks do not cover them."""
    got = marks(call)
    k = run.counters.get("passes") if run is not None else None
    if not got or not k or len(got) < k + 2:
        return None
    end, start = got[-2], got[-2 - k]
    return {name: (ns - start.get(name, (0, 0))[0],
                   n - start.get(name, (0, 0))[1])
            for name, (ns, n) in end.items()}


def ms_per_pose(run, call: str, spans, poses: str):
    """The window's host milliseconds of the spans ``spans`` over its
    count ``poses``, or None where either is empty."""
    t = window(run, call)
    if t is None:
        return None
    n = t.get(poses, (0, 0))[1]
    got = [t[s] for s in spans if s in t]
    if not n or not sum(c for _, c in got):
        return None
    return 1e-6 * sum(ns for ns, _ in got) / n
