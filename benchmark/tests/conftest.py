"""Shared pieces of the benchmark's CPU tests: a small configuration and
small traffic for each cell, run on the CPU through the port's plain
path."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness

SMALL_CAMERA = dict(fps=20.0, width=320, height=240, fx=200.0, fy=200.0,
                    cx=160.0, cy=120.0, k1=-0.05, k2=0.01, p1=0.0, p2=0.0)
FISHEYE_CAMERA = dict(fps=20.0, width=256, height=256, fx=95.5, fy=95.5,
                      cx=127.5, cy=128.5)
SMALL_TRACKER = dict(num_features=40, max_tracking_length=8,
                     min_tracking_length=3, min_distance=12.0,
                     block_size_x=80, block_size_y=60)
SMALL_TRAFFIC = {
    "set_replay": {"durations_s": [6, 5, 5.5, 6], "warmup_frames": 60,
                   "check_frames": 16, "trace_chunks": [1, 1],
                   "chunk_size": 8},
    "filter_batch": {"batch": 3, "duration_s": 8, "check_frames": 30,
                     "trace_frames": 10},
}
CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


def small_run(workload: str, seed: int = 2 ** 31 + 17, trace=False,
              seconds: float = 0.5, spec=None):
    """A run of ``workload`` on the CPU at the small sizes."""
    spec = spec or harness.load_spec()
    cell = harness.cell_entry(spec, workload)
    kind = harness.read_json("traffic", cell["traffic"])["driver"]
    return harness.make_run(workload, seed, seconds, trace, "cpu", spec,
                            overrides={"camera": SMALL_CAMERA,
                                       "tracker": SMALL_TRACKER,
                                       "traffic": SMALL_TRAFFIC[kind]})


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
