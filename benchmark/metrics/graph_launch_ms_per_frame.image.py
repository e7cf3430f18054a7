"""Host time of the set replay's graph launches (span frame_scan.replay), per
pose returned, over the window's passes."""

from benchmark import program_trace


def read(run):
    return program_trace.ms_per_pose(
        run, "replay.pass", ["frame_scan.replay"], "replay.poses")
