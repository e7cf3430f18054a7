"""Device time of every kernel that is none of K1-K13 per pose in the image
stretch, ms.
"""

from benchmark import readers


def read(run):
    return readers.layer_ms_per_pose(run, "image", "glue")
