"""The frozen reference (reference/) against the port's plain CPU path on
the first frames of each cell at the small sizes: in the same float32 on
the same device the two are one computation, so every number the check
compares reads 0."""

import pytest

from benchmark import harness
from benchmark.drivers import common
from benchmark.tests.conftest import CELLS, small_run


@pytest.mark.parametrize("workload", CELLS)
def test_reference_reproduces_the_port_on_the_cpu(workload):
    run = small_run(workload)
    drv = harness.driver(run.traffic["driver"])
    state = drv.setup(run)
    out = drv.window(run, state)
    prog = drv.outputs(out)
    ref = drv.reference(run, state)
    readings = drv.judge(run, prog, ref)
    assert readings and all(v == 0.0 for v in readings.values()), readings


def test_gaps_read_a_missing_frame_as_the_largest_float():
    g = common.Gaps()
    g.add([0.0], [[0.0, 0, 0]], [0.0, 1.0], [[0, 0, 0], [1, 1, 1]])
    c = common.compared(g.numbers(), {"pose_gap_m": 1e-3})
    assert c["pose_gap_m"]["value"] > 1e300
    assert c["pose_gap_m"]["limit"] == 1e-3 and list(c) == ["pose_gap_m"]
    assert common.Gaps().numbers()["pose_gap_p60_m"] == float("inf")
    g = common.Gaps()     # the reference has nothing to compare
    nan = float("nan")
    g.add([0, 1], [[0, 0, 0], [0, 0, 0]], [0, 1], [[nan, 0, 0], [0, 0, 0]])
    assert g.numbers()["pose_gap_p60_m"] == float("inf")


def test_gaps_read_a_frame_without_a_finite_pose_as_infinite():
    """A judged frame that is not finite is an infinite gap wherever it
    falls, and is counted; the reference's own first such frame ends the
    track's comparison."""
    nan = float("nan")
    zeros = [[0, 0, 0]] * 10
    for first in (0, 3):
        p = [[0, 0, 0.1]] * first + [[nan, 0, 0]] * (10 - first)
        g = common.Gaps(head=5)
        for _ in range(4):
            g.add(range(10), zeros, range(10), zeros)
        g.add(range(10), p, range(10), zeros)
        n = g.numbers()
        assert n["pose_gap_m"] == float("inf")
        assert n["pose_gap_track_head_m"] == float("inf")
        assert n["nonfinite_poses"] == 10 - first
    g = common.Gaps()
    g.add(range(3), [[0, 0, 0.1], [0, 0, 0.2], [9, 9, 9]], range(3),
          [[0, 0, 0], [0, 0, 0], [nan, 0, 0]])
    n = g.numbers()
    assert n["pose_gap_m"] == pytest.approx(0.2) and n["nonfinite_poses"] == 0
    assert common.compared(n, {})["nonfinite_poses"]["limit"] == -1.0


def test_gaps_hold_each_track_over_its_head():
    """One track of five parted from the reference: the 60th percentile
    over every frame does not see it, the track's own widest gap over its
    first frames does; a track that parts only after them does not count
    there."""
    zeros = [[0, 0, 0]] * 10
    g = common.Gaps(head=4)
    for _ in range(4):
        g.add(range(10), zeros, range(10), zeros)
    g.add(range(10), [[0, 0, 0.05]] * 10, range(10), zeros)
    n = g.numbers()
    assert n["pose_gap_p60_m"] == 0.0
    assert n["pose_gap_track_head_m"] == pytest.approx(0.05)
    g = common.Gaps(head=4)
    g.add(range(10), [[0, 0, 1e-7]] * 4 + [[0, 0, 0.05]] * 6, range(10),
          zeros)
    n = g.numbers()
    assert n["pose_gap_track_head_m"] == pytest.approx(1e-7)
    assert n["pose_gap_m"] == pytest.approx(0.05)
    assert "pose_gap_track_head_m" not in common.Gaps().numbers()


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    """The control (the reference with TF32 products, the step below the
    configuration's float32) in the program's place fails one of the
    cell's compared numbers, at the small sizes on the CPU."""
    run = small_run(workload)
    drv = harness.driver(run.traffic["driver"])
    state = drv.setup(run)
    ref = drv.reference(run, state)
    control = drv.answers(drv.reference(run, state, tf32=True))
    checks = common.compared(drv.judge(run, control, ref), run.limits)
    assert checks and any(c["value"] > c["limit"] for c in checks.values()), \
        checks
