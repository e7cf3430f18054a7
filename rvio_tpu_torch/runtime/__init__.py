"""Runtime: the per-frame step, the frame loop, init gate and driver."""

from rvio_tpu_torch.runtime.driver import (DriverResult, InitializationGate,
                                           SequenceDriver, batches_from_sim,
                                           bundle_imu)
from rvio_tpu_torch.runtime.step import (FrameBundle, make_filter_step,
                                         make_sequence_scan)

__all__ = ["DriverResult", "FrameBundle", "InitializationGate",
           "SequenceDriver", "batches_from_sim", "bundle_imu",
           "make_filter_step", "make_sequence_scan"]
