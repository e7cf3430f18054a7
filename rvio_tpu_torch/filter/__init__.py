"""Filter stages: IMU propagation and the batched MSCKF update."""

from rvio_tpu_torch.filter.propagation import ImuBlock, make_imu_block, propagate
from rvio_tpu_torch.filter.update import UpdateBatch, msckf_update

__all__ = ["ImuBlock", "make_imu_block", "propagate", "UpdateBatch",
           "msckf_update"]
