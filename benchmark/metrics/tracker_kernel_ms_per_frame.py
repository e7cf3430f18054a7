"""Device time of the tracker's hand kernels (K6-K13) per pose, ms."""

from benchmark import readers


def read(run):
    return readers.layer_ms_per_pose(run, "image", "tracker")
