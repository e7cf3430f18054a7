"""JPL-convention quaternion algebra on tensors.

Port of rvio_tpu/core/quaternion.py.  Quaternions are stored ``[x, y, z, w]``
(vector part first) in the JPL convention of the reference's Numerics.h.
Every function is batched over leading axes; branches are ``torch.where``.

- ``quat_mul``   — Numerics.h:30-63  (normalizes, canonicalizes w >= 0)
- ``quat_inv``   — Numerics.h:69-91  (conjugate with w-sign handling)
- ``quat_to_rot``— Numerics.h:111-120 (R = I - 2w[qv]x + 2[qv]x^2)
- ``rot_to_quat``— Numerics.h:126-167 (Breckenridge / JPL branch procedure)
"""

from __future__ import annotations

import torch

from benchmark.reference.rvio_plain.core.so3 import skew


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """[0, 0, 0, 1], made on the device (an item assignment from a Python
    scalar would copy it from the host and synchronize every frame)."""
    return torch.cat([torch.zeros(3, dtype=dtype, device=device),
                      torch.ones(1, dtype=dtype, device=device)])


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalize and canonicalize to w >= 0 (reference convention)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 3:4] < 0, -q, q)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """JPL quaternion product q = q1 (x) q2: R(q) = R(q1) R(q2)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    x = w1 * x2 + z1 * y2 - y1 * z2 + x1 * w2
    y = -z1 * x2 + w1 * y2 + x1 * z2 + y1 * w2
    z = y1 * x2 - x1 * y2 + w1 * z2 + z1 * w2
    w = -x1 * x2 - y1 * y2 - z1 * z2 + w1 * w2
    return quat_normalize(torch.stack([x, y, z, w], dim=-1))


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Quaternion inverse (conjugate for unit quats), Numerics.h:69-91."""
    wpos = q[..., 3:4] > 0
    qi = torch.where(wpos, torch.cat([-q[..., :3], q[..., 3:]], dim=-1),
                     torch.cat([q[..., :3], -q[..., 3:]], dim=-1))
    return qi / torch.linalg.vector_norm(qi, dim=-1, keepdim=True)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """R = I - 2 w [qv]x + 2 [qv]x^2 (JPL; Numerics.h:111-120)."""
    qx = skew(q[..., :3])
    w = q[..., 3]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(qx.shape)
    return eye - 2.0 * w[..., None, None] * qx + 2.0 * (qx @ qx)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> JPL quaternion via the Breckenridge procedure.

    Computes all four of the reference's branches (Numerics.h:126-167) and
    selects by the same priority order.
    """
    r00, r11, r22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    T = r00 + r11 + r22
    tiny = torch.finfo(R.dtype).tiny

    def _safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=tiny))

    # Branch 1: R00 dominant
    q0a = _safe_sqrt((1 + 2 * r00 - T) / 4)
    b1 = torch.stack([
        q0a,
        (R[..., 0, 1] + R[..., 1, 0]) / (4 * q0a),
        (R[..., 0, 2] + R[..., 2, 0]) / (4 * q0a),
        (R[..., 1, 2] - R[..., 2, 1]) / (4 * q0a),
    ], dim=-1)
    # Branch 2: R11 dominant
    q1a = _safe_sqrt((1 + 2 * r11 - T) / 4)
    b2 = torch.stack([
        (R[..., 0, 1] + R[..., 1, 0]) / (4 * q1a),
        q1a,
        (R[..., 1, 2] + R[..., 2, 1]) / (4 * q1a),
        (R[..., 2, 0] - R[..., 0, 2]) / (4 * q1a),
    ], dim=-1)
    # Branch 3: R22 dominant
    q2a = _safe_sqrt((1 + 2 * r22 - T) / 4)
    b3 = torch.stack([
        (R[..., 0, 2] + R[..., 2, 0]) / (4 * q2a),
        (R[..., 1, 2] + R[..., 2, 1]) / (4 * q2a),
        q2a,
        (R[..., 0, 1] - R[..., 1, 0]) / (4 * q2a),
    ], dim=-1)
    # Branch 4: trace dominant
    q3a = _safe_sqrt((1 + T) / 4)
    b4 = torch.stack([
        (R[..., 1, 2] - R[..., 2, 1]) / (4 * q3a),
        (R[..., 2, 0] - R[..., 0, 2]) / (4 * q3a),
        (R[..., 0, 1] - R[..., 1, 0]) / (4 * q3a),
        q3a,
    ], dim=-1)

    c1 = (r00 > T) & (r00 > r11) & (r00 > r22)
    c2 = (r11 > T) & (r11 > r00) & (r11 > r22)
    c3 = (r22 > T) & (r22 > r00) & (r22 > r11)
    q = torch.where(c1[..., None], b1,
        torch.where(c2[..., None], b2,
        torch.where(c3[..., None], b3, b4)))
    return quat_normalize(q)


def small_quat_from_dtheta(dtheta: torch.Tensor) -> torch.Tensor:
    """Error-state retraction quaternion from a small rotation dtheta.

    dq = [dtheta/2, sqrt(1 - |dtheta/2|^2)] with the reference's unit-norm
    guard branch for |dtheta/2| >= 1 (reference: Updater.cc:549-563).
    """
    v = 0.5 * dtheta
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = n2 < 1.0
    w_small = torch.sqrt(torch.clamp(1.0 - n2, min=0.0))
    inv = 1.0 / torch.sqrt(1.0 + n2)
    v_out = torch.where(small, v, v * inv)
    w_out = torch.where(small, w_small, inv)
    return torch.cat([v_out, w_out], dim=-1)
