"""SO(3) primitives: skew, closed-form Rodrigues integration coefficients.

Port of rvio_tpu/core/so3.py.  These implement the exact closed-form
rotation/velocity/position integrals of the reference's propagation loop
(reference: src/rvio/PreIntegrator.cc:109-166), with the small-angle branch
expressed as ``torch.where`` so one batched call handles both regimes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rodrigues_np(w: np.ndarray, dt: float) -> np.ndarray:
    """Exp(w dt) rotation matrix for one body-rate sample, host numpy.

    Used by the host-side init gate (runtime/driver.py) for sample-by-sample
    gyro integration.
    """
    th = np.linalg.norm(w) * dt
    if th < 1e-12:
        return np.eye(3)
    k = w / np.linalg.norm(w)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def skew(w: torch.Tensor) -> torch.Tensor:
    """[w]x skew-symmetric matrix; batched over leading axes (Numerics.h:97-105)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)


def delta_rot(w: torch.Tensor, dt, small_angle: float) -> torch.Tensor:
    """Closed-form incremental rotation for body rate w over dt.

    deltaR = I - (sin(w dt)/|w|)[w]x + ((1-cos(w dt))/|w|^2)[w]x^2, with the
    second-order small-angle expansion below ``small_angle`` rad/s
    (reference: PreIntegrator.cc:145-166).  Maps vectors from the *old*
    frame into the *new* frame (the robocentric convention).
    """
    dt = torch.as_tensor(dt, dtype=w.dtype, device=w.device)
    w1 = torch.linalg.vector_norm(w, dim=-1)
    wx = skew(w)
    wx2 = wx @ wx
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(wx.shape)

    small = w1 < small_angle
    w1s = torch.where(small, torch.ones_like(w1), w1)  # guard /0
    c_sin = (torch.sin(w1s * dt) / w1s)[..., None, None]
    # 1-cos(x) = 2 sin^2(x/2): avoids cancellation near 0
    c_cos = (2.0 * torch.sin(0.5 * w1s * dt) ** 2 / w1s ** 2)[..., None, None]
    exact = eye - c_sin * wx + c_cos * wx2
    approx = eye - dt[..., None, None] * wx + (0.5 * dt ** 2)[..., None, None] * wx2
    return torch.where(small[..., None, None], approx, exact)


def so3_integration_coeffs(w1: torch.Tensor, dt, small_angle: float
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """Closed-form scalar coefficients f1..f4 of the reference's dp/dv integrals.

    f1,f2 weight [w]x and [w]x^2 in the position integral; f3,f4 in the
    velocity integral (reference: PreIntegrator.cc:147-166):

        exact:  f1 = (wdt cos - sin)/w^3          small: f1 = -dt^3/3
                f2 = (wdt^2 - 2cos - 2wdt sin + 2)/(2w^4)   f2 = dt^4/8
                f3 = (cos - 1)/w^2                       f3 = -dt^2/2
                f4 = (wdt - sin)/w^3                     f4 = dt^3/6
    """
    dt = torch.as_tensor(dt, dtype=w1.dtype, device=w1.device)
    small = w1 < small_angle
    w1s = torch.where(small, torch.ones_like(w1), w1)
    wdt = w1s * dt
    coswdt = torch.cos(wdt)
    sinwdt = torch.sin(wdt)
    one_m_cos = 2.0 * torch.sin(0.5 * wdt) ** 2
    f1 = torch.where(small, -dt ** 3 / 3.0, (wdt * coswdt - sinwdt) / w1s ** 3)
    f2 = torch.where(small, dt ** 4 / 8.0,
                     0.5 * (wdt ** 2 + 2.0 * one_m_cos - 2.0 * wdt * sinwdt)
                     / w1s ** 4)
    f3 = torch.where(small, -dt ** 2 / 2.0, -one_m_cos / w1s ** 2)
    f4 = torch.where(small, dt ** 3 / 6.0, (wdt - sinwdt) / w1s ** 3)
    return f1, f2, f3, f4
