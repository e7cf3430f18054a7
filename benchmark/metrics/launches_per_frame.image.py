"""Device kernel launches of the traced image stretch per pose."""

from benchmark import readers


def read(run):
    return readers.launches_per_pose(run, "image")
