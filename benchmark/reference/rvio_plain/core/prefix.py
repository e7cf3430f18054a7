"""Inclusive prefix scans over one axis of tensors, in log depth.

PyTorch has no ``associative_scan``; the JAX package's parallel forms
(the window chain of filter/update.py, the propagation of
filter/propagation.py) use one, and the port runs them through
:func:`prefix_scan`.
"""

from __future__ import annotations

import torch


def prefix_scan(xs, combine, dim: int):
    """Inclusive prefix of the tuple of tensors ``xs`` along axis ``dim``
    (counted from the front, the same axis of every tensor) under the
    associative ``combine(earlier, later)`` on tuples: Hillis-Steele
    doubling, log2(n) levels, each one batched ``combine`` over every
    position.  Returns a tuple like ``xs``."""
    n = xs[0].shape[dim]
    step = 1
    while step < n:
        done = combine(tuple(x.narrow(dim, 0, n - step) for x in xs),
                       tuple(x.narrow(dim, step, n - step) for x in xs))
        xs = tuple(torch.cat([x.narrow(dim, 0, step), c], dim=dim)
                   for x, c in zip(xs, done))
        step *= 2
    return xs
