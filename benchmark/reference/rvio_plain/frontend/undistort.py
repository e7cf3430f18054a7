"""Point undistortion to normalized camera coordinates.

Port of rvio_tpu/frontend/undistort.py (the reference's
cv::undistortPoints / cv::fisheye::undistortPoints, Tracker.cc:100-132):
batched fixed-point / Newton iterations with a static count.

- radtan (plain):  x_d = x(1 + k1 r^2 + k2 r^4 + k3 r^6) + tangential(p1,p2)
- fisheye (equidistant): theta_d = theta (1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8)
"""

from __future__ import annotations

import torch


def distort_radtan(xy: torch.Tensor, k1, k2, p1, p2, k3=0.0) -> torch.Tensor:
    """Forward radtan distortion on normalized points (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_radtan(xy_d: torch.Tensor, k1, k2, p1, p2, k3=0.0,
                     iters: int = 15) -> torch.Tensor:
    """Invert radtan by fixed-point iteration (OpenCV-style compensation)."""
    xd, yd = xy_d[..., 0], xy_d[..., 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return torch.stack([x, y], dim=-1)


def distort_fisheye(xy: torch.Tensor, k1, k2, k3, k4) -> torch.Tensor:
    """Forward equidistant fisheye distortion on normalized points."""
    x, y = xy[..., 0], xy[..., 1]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-18))
    theta = torch.atan(r)
    th2 = theta * theta
    theta_d = theta * (1 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))
    scale = theta_d / r
    return torch.stack([x * scale, y * scale], dim=-1)


def undistort_fisheye(xy_d: torch.Tensor, k1, k2, k3, k4,
                      iters: int = 10) -> torch.Tensor:
    """Invert the equidistant model: solve theta from theta_d by Newton."""
    xd, yd = xy_d[..., 0], xy_d[..., 1]
    theta_d = torch.sqrt(torch.clamp(xd * xd + yd * yd, min=1e-18))
    theta = theta_d
    for _ in range(iters):
        th2 = theta * theta
        f = theta * (1 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4)))) - theta_d
        fp = (1 + th2 * (3 * k1 + th2 * (5 * k2 + th2 * (7 * k3 + th2 * 9 * k4))))
        theta = theta - f / fp
    scale = torch.tan(theta) / theta_d
    return torch.stack([xd * scale, yd * scale], dim=-1)


def undistort_normalize(pts_px: torch.Tensor, *, fx, fy, cx, cy,
                        k1, k2, p1, p2, k3=0.0, fisheye: bool = False
                        ) -> torch.Tensor:
    """Pixel coords (..., 2) -> undistorted normalized coords (..., 2), the
    reference's UndistortAndNormalize (Tracker.cc:100-132)."""
    x = (pts_px[..., 0] - cx) / fx
    y = (pts_px[..., 1] - cy) / fy
    xy = torch.stack([x, y], dim=-1)
    if fisheye:
        # fisheye model: distortion coeffs are k1..k4 (p1,p2 slots)
        return undistort_fisheye(xy, k1, k2, p1, p2)
    return undistort_radtan(xy, k1, k2, p1, p2, k3)


def project_to_pixels(xy_n: torch.Tensor, *, fx, fy, cx, cy,
                      k1, k2, p1, p2, k3=0.0, fisheye: bool = False
                      ) -> torch.Tensor:
    """Normalized coords -> distorted pixel coords."""
    if fisheye:
        d = distort_fisheye(xy_n, k1, k2, p1, p2)
    else:
        d = distort_radtan(xy_n, k1, k2, p1, p2, k3)
    return torch.stack([d[..., 0] * fx + cx, d[..., 1] * fy + cy], dim=-1)
