"""Segment batching on one card: a batch of independent filters.

Port of rvio_tpu/parallel/segment.py's single-device part.  One filter
instance per sequence segment, every state field and bundle leaf with a
leading segment axis; the filter's one body runs them in lockstep, each
kernel once a frame for the batch (runtime/step.py).  The JAX module's
mesh placement (``make_parallel_step``, ``make_parallel_sequence``,
``shard_*``, ``replicate_scalars``) is the ``torch.distributed`` slice
and is not ported yet.
"""

from __future__ import annotations

import torch

from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.runtime.step import _segment_body
from rvio_tpu_torch.state.filter_state import stack_states

__all__ = ["stack_states"]


def _step_body(cfg: RVIOConfig, device, dtype=torch.float32):
    """The segment body of rvio_tpu/parallel/segment.py ``_step_body``:
    ``body(states, bundles) -> (states, outputs)`` over a leading segment
    axis, with that function's arguments (the window chain in its
    sequential form)."""
    return _segment_body(cfg, device, dtype, parallel_chains=False)
