"""Segment batching on one card, stitching and the warm segment handoff.

Port of rvio_tpu/parallel without its mesh: B segments run in lockstep on
one card (runtime/step.py's segment scan); ``make_mesh``, the sharded
steps and ``launch.py`` are the ``torch.distributed`` slice, still to
come.
"""

from rvio_tpu_torch.parallel.handoff import (bootstrap_velocity_gravity,
                                             make_masked_segment_scan,
                                             run_segments_warm, segment_plan,
                                             stitch_warm_outputs,
                                             warm_initialize, warm_segments)
from rvio_tpu_torch.parallel.segment import stack_states
from rvio_tpu_torch.parallel.stitch import (fit_yaw_transform, prefix_product,
                                            stitch_segments)

__all__ = ["bootstrap_velocity_gravity", "fit_yaw_transform",
           "make_masked_segment_scan", "prefix_product", "run_segments_warm",
           "segment_plan", "stack_states", "stitch_segments",
           "stitch_warm_outputs", "warm_initialize", "warm_segments"]
