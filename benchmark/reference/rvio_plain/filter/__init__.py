"""Filter stages: IMU propagation and the batched MSCKF update."""

from benchmark.reference.rvio_plain.filter.propagation import ImuBlock, make_imu_block, propagate
from benchmark.reference.rvio_plain.filter.update import UpdateBatch, msckf_update

__all__ = ["ImuBlock", "make_imu_block", "propagate", "UpdateBatch",
           "msckf_update"]
