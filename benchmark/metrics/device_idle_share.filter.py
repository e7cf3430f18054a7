"""Share of the traced feature-batch call in which no operation ran on the
card, %.
"""

from benchmark import readers


def read(run):
    return readers.idle_share(run, "filter")
