"""Host time of the set replay's passes before their first chunk (init gates,
first frames, the scan built; span replay.init), per pose returned, over the
window's passes."""

from benchmark import program_trace


def read(run):
    return program_trace.ms_per_pose(
        run, "replay.pass", ["replay.init"], "replay.poses")
