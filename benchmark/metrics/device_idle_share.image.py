"""Share of the traced image stretch in which no operation ran on the card,
%.
"""

from benchmark import readers


def read(run):
    return readers.idle_share(run, "image")
