"""Math primitives: JPL quaternion algebra, SO(3), chi-square gating."""

from benchmark.reference.rvio_plain.core.quaternion import (
    quat_identity,
    quat_mul,
    quat_inv,
    quat_to_rot,
    rot_to_quat,
    small_quat_from_dtheta,
)
from benchmark.reference.rvio_plain.core.so3 import skew, so3_integration_coeffs, delta_rot
from benchmark.reference.rvio_plain.core.chi2 import CHI2_095, chi2_gate_thresholds

__all__ = [
    "quat_identity", "quat_mul", "quat_inv", "quat_to_rot", "rot_to_quat",
    "small_quat_from_dtheta", "skew", "so3_integration_coeffs", "delta_rot",
    "CHI2_095", "chi2_gate_thresholds",
]
