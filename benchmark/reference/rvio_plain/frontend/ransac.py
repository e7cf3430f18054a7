"""Gyro-aided 2-point RANSAC for inter-frame outlier rejection.

Port of rvio_tpu/frontend/ransac.py (reference Ransac, src/rvio/Ransac.cc):
all hypotheses are built and scored at once.  The JAX package draws its
sampling keys with ``jax.random.uniform(key, (N,))``; torch cannot
reproduce that stream, so the port takes the N uniform draws ``u`` as an
input (the driver draws a whole run's table from a seeded generator, and
the tests pass the JAX chain's draws).

Model (Ransac.cc:86-117): with the gyro-integrated inter-frame rotation R
(camera frame), the translation direction t(alpha, beta) follows in closed
form from two correspondences via p2^T [t]x R p1 = 0; the hypothesis is
E = [t]x R.  Inliers are counted with the Sampson (or algebraic) error and
the most-voted hypothesis re-scores every candidate (Ransac.cc:180-247).
Both functions also take a leading segment axis B (a batched tracker's
frames): each segment draws, votes and gates on its own candidates, with
no host read.
"""

from __future__ import annotations

import torch

from benchmark.reference.rvio_plain.core.so3 import delta_rot, skew


def integrate_gyro_rotation(w: torch.Tensor, dt: torch.Tensor,
                            valid: torch.Tensor, R_bc: torch.Tensor,
                            small_angle: float) -> torch.Tensor:
    """Inter-frame rotation from raw gyro, conjugated into the camera frame
    (Ransac::GetRotation, Ransac.cc:120-155): deltaR products over the
    frame's valid IMU samples, then R_cb R R_bc.  B frames' blocks
    (B, K, ...) give (B, 3, 3)."""
    dR = delta_rot(w, dt, small_angle)                 # (..., K, 3, 3)
    R = torch.eye(3, dtype=w.dtype, device=w.device).expand(dR.shape[:-3]
                                                            + (3, 3))
    for k in range(w.shape[-2]):
        R = torch.where(valid[..., k, None, None], dR[..., k, :, :] @ R, R)
    return R_bc.T @ R @ R_bc


def _two_point_translation(pA1, pA2, pB1, pB2, R):
    """Closed-form translation directions (..., H, 3) from pairs of
    correspondences (..., H, 3) each and rotations (..., 3, 3)
    (Ransac.cc:86-117)."""
    pA0 = pA1 @ R.transpose(-1, -2)
    pB0 = pB1 @ R.transpose(-1, -2)
    c1 = pA2[..., 0] * pA0[..., 1] - pA0[..., 0] * pA2[..., 1]
    c2 = pA0[..., 1] * pA2[..., 2] - pA2[..., 1] * pA0[..., 2]
    c3 = pA2[..., 0] * pA0[..., 2] - pA0[..., 0] * pA2[..., 2]
    c4 = pB2[..., 0] * pB0[..., 1] - pB0[..., 0] * pB2[..., 1]
    c5 = pB0[..., 1] * pB2[..., 2] - pB2[..., 1] * pB0[..., 2]
    c6 = pB2[..., 0] * pB0[..., 2] - pB0[..., 0] * pB2[..., 2]
    alpha = torch.atan2(c3 * c5 - c2 * c6, c1 * c6 - c3 * c4)
    beta = torch.atan2(-c3, c1 * torch.sin(alpha) + c2 * torch.cos(alpha))
    return torch.stack([torch.sin(beta) * torch.cos(alpha), torch.cos(beta),
                        -torch.sin(beta) * torch.sin(alpha)], dim=-1)


def _sampson_error(p1, p2, E):
    """Sampson distances (..., H, N) (Ransac.cc:250-258); p1/p2 (..., N, 3),
    E (..., H, 3, 3)."""
    p1, p2 = p1.unsqueeze(-3), p2.unsqueeze(-3)
    Ep1 = p1 @ E.transpose(-1, -2)          # (..., H, N, 3)
    Etp2 = p2 @ E                           # (..., H, N, 3)
    num = torch.sum(p2 * Ep1, dim=-1) ** 2
    den = (Ep1[..., 0] ** 2 + Ep1[..., 1] ** 2 + Etp2[..., 0] ** 2
           + Etp2[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-30)


def _algebraic_error(p1, p2, E):
    p1, p2 = p1.unsqueeze(-3), p2.unsqueeze(-3)
    return torch.abs(torch.sum(p2 * (p1 @ E.transpose(-1, -2)), dim=-1))


def gyro_ransac(u: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor,
                candidate: torch.Tensor, R_cam: torch.Tensor,
                inlier_threshold: float, *, n_hypotheses: int = 16,
                use_sampson: bool = True) -> torch.Tensor:
    """Refine inlier flags with gyro-aided 2-point RANSAC.

    u: (N,) uniform draws in [0, 1) (the sampling keys); pts1/pts2: (N, 3)
    homogeneous normalized points in the previous/current frame;
    candidate: (N,) bool KLT survivors; R_cam: gyro inter-frame rotation
    in the camera frame.  Returns the refined (N,) flags; with fewer than
    2 * n_hypotheses candidates the flags pass through (Ransac.cc:201-205).
    With a leading segment axis B on every argument ((B, N) draws and
    flags, (B, N, 3) points, (B, 3, 3) rotations), each segment on its own.
    """
    if u.dim() == 1:
        return gyro_ransac(u[None], pts1[None], pts2[None], candidate[None],
                           R_cam[None], inlier_threshold,
                           n_hypotheses=n_hypotheses,
                           use_sampson=use_sampson)[0]
    n_cand = torch.sum(candidate.int(), dim=1, keepdim=True)
    # 2H distinct candidate slots: sort the keys with non-candidates pushed
    # to the end, pair consecutive entries (a draw without replacement,
    # Ransac.cc:50-83)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    scores = u + torch.where(candidate, zero, zero + 10.0)
    order = torch.argsort(scores, dim=1, stable=True)

    def pick(p, idx):
        return torch.gather(p, 1, idx[:, :, None].expand(-1, -1, 3))

    idxA = order[:, 0:2 * n_hypotheses:2]
    idxB = order[:, 1:2 * n_hypotheses:2]
    t = _two_point_translation(pick(pts1, idxA), pick(pts2, idxA),
                               pick(pts1, idxB), pick(pts2, idxB), R_cam)
    E_all = skew(t) @ R_cam[:, None]                         # (B, H, 3, 3)

    err_fn = _sampson_error if use_sampson else _algebraic_error
    errs = err_fn(pts1, pts2, E_all)                         # (B, H, N)
    votes = torch.sum((errs < inlier_threshold) & candidate[:, None, :],
                      dim=2)
    # a gather keeps each segment's argmax on the device (a 0-d tensor
    # index would read it back)
    best = torch.argmax(votes, dim=1)
    e_best = torch.gather(errs, 1, best[:, None, None].expand(
        -1, 1, errs.shape[2]))[:, 0]
    keep = candidate & (e_best <= inlier_threshold) & torch.isfinite(e_best)
    return torch.where(n_cand >= 2 * n_hypotheses, keep, candidate)
