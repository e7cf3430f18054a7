"""Host time of the feature batch's graph launches (span frame_scan.replay),
per pose (count sequence_scan.poses), over the window's passes."""

from benchmark import program_trace


def read(run):
    return program_trace.ms_per_pose(
        run, "sequence_scan.call", ["frame_scan.replay"],
        "sequence_scan.poses")
