"""Host time of the set replay's graph set-up, each pass's eager first frame
and capture (spans frame_scan.warm and frame_scan.capture), per pose
returned, over the window's passes."""

from benchmark import program_trace


def read(run):
    return program_trace.ms_per_pose(
        run, "replay.pass", ["frame_scan.warm", "frame_scan.capture"],
        "replay.poses")
