"""Host time of the set replay's chunk uploads (span replay.upload), per pose
returned, over the window's passes."""

from benchmark import program_trace


def read(run):
    return program_trace.ms_per_pose(
        run, "replay.pass", ["replay.upload"], "replay.poses")
