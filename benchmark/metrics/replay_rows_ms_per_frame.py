"""Host time of the set replay's per-frame rows and results (span
replay.rows), per pose returned, over the window's passes."""

from benchmark import program_trace


def read(run):
    return program_trace.ms_per_pose(
        run, "replay.pass", ["replay.rows"], "replay.poses")
