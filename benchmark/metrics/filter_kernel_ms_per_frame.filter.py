"""Device time of the filter's hand kernels (K1-K5) per pose in the feature
batch, ms.
"""

from benchmark import readers


def read(run):
    return readers.layer_ms_per_pose(run, "filter", "filter")
