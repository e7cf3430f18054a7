"""Absolute/relative trajectory error, evo-compatible methodology.

The reference has no built-in evaluation — it writes TUM files for external
tools (reference: README + System.cc:371-374).  We implement the standard
SE(3) (optionally Sim(3)) Umeyama alignment + ATE RMSE so accuracy gates run
inside the test suite and the benchmark.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning x -> y (both (N,3)).

    Returns (R, t, s) minimizing || y - (s R x + t) ||^2 (Umeyama 1991).
    """
    mx = x.mean(axis=0)
    my = y.mean(axis=0)
    xc = x - mx
    yc = y - my
    cov = yc.T @ xc / x.shape[0]
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_x = (xc ** 2).sum() / x.shape[0]
        s = float(np.trace(np.diag(d) @ S) / var_x)
    else:
        s = 1.0
    t = my - s * R @ mx
    return R, t, s


def ate_rmse(est_p: np.ndarray, gt_p: np.ndarray, with_scale: bool = False
             ) -> float:
    """Aligned absolute trajectory error RMSE [m]."""
    R, t, s = umeyama_alignment(est_p, gt_p, with_scale)
    aligned = (s * (R @ est_p.T)).T + t
    err = np.linalg.norm(aligned - gt_p, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def match_nearest(gt_t: np.ndarray, est_t: np.ndarray, max_dt: float = 0.02
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp matching of estimates to ground truth.

    Returns (gt_indices, ok_mask): for each estimate timestamp, the index of
    the closest gt timestamp, and whether it is within max_dt.  This is the
    standard evo-style association; a bare searchsorted (first gt >= t) is
    biased by up to one gt sample and has no tolerance at sequence edges.
    """
    gi = np.clip(np.searchsorted(gt_t, est_t), 1, len(gt_t) - 1)
    gi = np.where(np.abs(gt_t[gi - 1] - est_t) < np.abs(gt_t[gi] - est_t),
                  gi - 1, gi)
    ok = np.abs(gt_t[gi] - est_t) <= max_dt
    return gi, ok


def rpe_rmse(est_p: np.ndarray, gt_p: np.ndarray, delta: int = 20) -> float:
    """Relative pose (translation drift) error RMSE over a frame delta."""
    d_est = est_p[delta:] - est_p[:-delta]
    d_gt = gt_p[delta:] - gt_p[:-delta]
    # rotationally align the deltas (drift direction drifts with heading)
    R, t, _ = umeyama_alignment(est_p, gt_p)
    d_est = (R @ d_est.T).T
    err = np.linalg.norm(d_est - d_gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))
