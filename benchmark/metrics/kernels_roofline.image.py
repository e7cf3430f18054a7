"""Share of the counted hand kernels' roofline in the image stretch: the
sum of their launches' least times (counts.py) over their device time,
%.
"""

from benchmark import readers


def read(run):
    return readers.roofline_share(run, "image")
