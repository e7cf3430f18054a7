"""Host time of the set replay's chunk assembly (zeros, IMU blocks, frame
reads; span replay.assemble), per pose returned, over the window's passes."""

from benchmark import program_trace


def read(run):
    return program_trace.ms_per_pose(
        run, "replay.pass", ["replay.assemble"], "replay.poses")
