"""Host time of the feature batch's scan calls outside the frames: the input
rows packed and the outputs split (spans sequence_scan.pack and
sequence_scan.split), per pose (count sequence_scan.poses), over the window's
passes."""

from benchmark import program_trace


def read(run):
    return program_trace.ms_per_pose(
        run, "sequence_scan.call",
        ["sequence_scan.pack", "sequence_scan.split"], "sequence_scan.poses")
