"""Host time of the set replay's readbacks, the wait for the card included
(span replay.readback), per pose returned, over the window's passes."""

from benchmark import program_trace


def read(run):
    return program_trace.ms_per_pose(
        run, "replay.pass", ["replay.readback"], "replay.poses")
