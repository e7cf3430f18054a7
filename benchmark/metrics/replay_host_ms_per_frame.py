"""Host time of a set-replay pass outside its chunks' scan-and-readback
walls (the replay's DriverResult.backend_ms), per pose, averaged over
the window's passes.
"""

from benchmark import readers


def read(run):
    return readers.counter(run, "replay_host_ms_per_frame")
