"""Device kernel launches of the traced feature-batch call per pose."""

from benchmark import readers


def read(run):
    return readers.launches_per_pose(run, "filter")
