"""Scaling layer: device meshes, segment data-parallelism, feature sharding.

Port of rvio_tpu/parallel over ``torch.distributed``: one process a GPU,
a (seg × feat) ``DeviceMesh`` (mesh.py), the sharded segment steps with
their hand-written collectives (segment.py), the launch helpers
(launch.py), stitching (stitch.py) and the warm segment handoff
(handoff.py).  On one card, B segments run in lockstep (runtime/step.py's
segment scan) with no mesh at all.
"""

from rvio_tpu_torch.parallel.handoff import (bootstrap_velocity_gravity,
                                             make_masked_segment_scan,
                                             run_segments_warm, segment_plan,
                                             stitch_warm_outputs,
                                             warm_initialize, warm_segments)
from rvio_tpu_torch.parallel.launch import (host_segment_slice,
                                            initialize_distributed)
from rvio_tpu_torch.parallel.mesh import make_mesh, segment_slice
from rvio_tpu_torch.parallel.segment import (gather_segments,
                                             make_parallel_sequence,
                                             make_parallel_step,
                                             replicate_scalars, shard_bundles,
                                             shard_states, stack_states)
from rvio_tpu_torch.parallel.stitch import (fit_yaw_transform, prefix_product,
                                            stitch_segments)

__all__ = ["make_mesh", "make_parallel_step", "shard_bundles", "shard_states",
           "replicate_scalars", "stitch_segments", "fit_yaw_transform",
           "prefix_product", "bootstrap_velocity_gravity",
           "run_segments_warm", "warm_initialize", "initialize_distributed",
           "host_segment_slice", "gather_segments", "make_masked_segment_scan",
           "make_parallel_sequence", "segment_plan", "segment_slice",
           "stack_states", "stitch_warm_outputs", "warm_segments"]
