"""rvio_tpu_torch — the PyTorch/CUDA port of rvio_tpu.

A second package beside ``rvio_tpu`` (the JAX reference, which it never
imports): the robocentric sliding-window filter with hand-written Hopper
kernels for its hot per-frame stages.

- ``core``     : JPL quaternion / SO(3) primitives, chi-square gating table.
- ``state``    : fixed-shape filter state (tensors) and its window operations.
- ``filter``   : IMU propagation and the inverse-depth MSCKF update, with the
                 feature axis F an explicit batch dimension.
- ``ops``      : CUDA kernels (sources in ``csrc/``, built with nvcc at first
                 use into ``build/``) beside their plain PyTorch versions.
- ``runtime``  : the per-frame step, the frame loop, init gate and driver.
- ``dataio``   : synthetic IMU/camera simulator, TUM trajectory IO (numpy).
- ``eval``     : ATE/RPE trajectory evaluation (numpy).

Entry points run on the CUDA device unless the caller asks for the CPU; a
CUDA tensor always goes through its kernel (or raises), a CPU tensor takes
the plain version.
"""

import torch as _torch

# The filter's covariance algebra is precision-critical and tiny: f32
# matmuls must run in full f32, never TF32 (the counterpart of the forced
# "highest" matmul precision in the JAX package).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from rvio_tpu_torch.config import RVIOConfig, load_config  # noqa: E402

__all__ = ["RVIOConfig", "load_config"]
__version__ = "0.1.0"
