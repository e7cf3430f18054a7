"""Runtime: the per-frame step, the graphed frame loops (the sequence scan
and the image chunk scans, each also over a segment axis,
runtime/graph.py), init gate and drivers (feature-level replay, images ->
poses on rendered or replayed frames, a set of sequences in lockstep, the
live OnlineDriver) and the session checkpoint."""

from rvio_tpu_torch.runtime.driver import (DriverResult, InitializationGate,
                                           SequenceDriver, batches_from_sim,
                                           bundle_imu)
from rvio_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from rvio_tpu_torch.runtime.image_driver import (ImagePipeline,
                                                 make_backend_chunk_scan,
                                                 make_batched_image_chunk_scan,
                                                 make_frontend_chunk_scan,
                                                 make_image_chunk_scan,
                                                 run_euroc_sequence,
                                                 run_euroc_sequence_scan,
                                                 run_rendered_sequence_scan)
from rvio_tpu_torch.runtime.input_buffer import InputBuffer
from rvio_tpu_torch.runtime.online import OnlineDriver
from rvio_tpu_torch.runtime.replay_set import run_sequence_set
from rvio_tpu_torch.runtime.step import (FrameBundle,
                                         make_batched_sequence_scan,
                                         make_filter_step, make_sequence_scan)

__all__ = ["DriverResult", "FrameBundle", "ImagePipeline", "InitializationGate",
           "InputBuffer", "OnlineDriver", "SequenceDriver", "batches_from_sim",
           "bundle_imu", "load_checkpoint", "make_backend_chunk_scan",
           "make_batched_image_chunk_scan", "make_batched_sequence_scan",
           "make_filter_step", "make_frontend_chunk_scan",
           "make_image_chunk_scan", "make_sequence_scan", "run_euroc_sequence",
           "run_euroc_sequence_scan", "run_rendered_sequence_scan",
           "run_sequence_set", "save_checkpoint"]
