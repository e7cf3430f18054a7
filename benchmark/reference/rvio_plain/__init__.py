"""A frozen plain copy of the tracker, the filter and their state.

Copied from the port's modules (config, core, state, filter, frontend and
the plain halves of ops) with the imports pointed here; ``ops/_lib.py``
replaces the kernel loader, so every operation runs its plain PyTorch
version on whatever device its tensors are on.  It is the benchmark's
yardstick: later changes to the port do not change it.  It imports
nothing of the port.
"""

from benchmark.reference.rvio_plain.config import RVIOConfig  # noqa: F401
