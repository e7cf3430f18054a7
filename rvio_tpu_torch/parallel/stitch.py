"""Composition-chain stitching of segment-parallel trajectories.

A copy of rvio_tpu/parallel/stitch.py (numpy only; the port imports
nothing of the JAX package), held to it by tests/test_torch_stitch.py.

Each segment's filter reports poses relative to its own gravity-aligned
start frame {G_s}.  Because the robocentric composition makes per-segment
outputs *relative* transforms, they compose associatively
(SURVEY.md section 5, long-context): the stitched global trajectory is a
prefix product of boundary transforms.  The per-pair boundary transforms
are independent (each needs only the two adjacent segments' overlap data),
and the prefix product is computed with a log-depth doubling scan over
batched 4x4 matmuls — so stitching itself parallelizes across segments.

Gravity observability makes roll/pitch absolute per segment; stitching is a
4-DOF (yaw + translation) alignment at the boundaries, the honest choice
for a drifting odometry chain.  When per-frame orientation estimates are
available the yaw comes from the rotation overlap (a chordal-L2 average of
R_prev R_cur^T, far better conditioned than trajectory tangents when the
overlap motion is small); translation from the position centroids.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _yaw_matrix(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def fit_yaw_transform(cur_p: np.ndarray, prev_p: np.ndarray,
                      cur_R: Optional[np.ndarray] = None,
                      prev_R: Optional[np.ndarray] = None) -> np.ndarray:
    """4-DOF (yaw+translation) T with prev ≈ T ∘ cur over the overlap.

    cur_p/prev_p: (N, 3) positions of the same frames expressed in the two
    segments' own world frames.  cur_R/prev_R: optional (N, 3, 3)
    world-from-body rotations; when given, yaw is the chordal-mean of
    prev_R cur_R^T (both segments share roll/pitch through gravity), which
    stays well conditioned even when the overlap barely translates.
    """
    if cur_R is not None and prev_R is not None:
        Msum = np.einsum("nij,nkj->ik", prev_R, cur_R)  # sum prev R cur R^T
        yaw = np.arctan2(Msum[1, 0] - Msum[0, 1], Msum[0, 0] + Msum[1, 1])
    else:
        ca, cb = cur_p.mean(0), prev_p.mean(0)
        a0, b0 = (cur_p - ca)[:, :2], (prev_p - cb)[:, :2]
        num = np.sum(a0[:, 0] * b0[:, 1] - a0[:, 1] * b0[:, 0])
        den = np.sum(a0[:, 0] * b0[:, 0] + a0[:, 1] * b0[:, 1])
        yaw = np.arctan2(num, den)
    R = _yaw_matrix(yaw)
    t = prev_p.mean(0) - R @ cur_p.mean(0)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def prefix_product(Ts: np.ndarray) -> np.ndarray:
    """Inclusive left-to-right prefix product of (S, 4, 4) transforms.

    out[s] = Ts[0] @ Ts[1] @ ... @ Ts[s], computed with a Hillis-Steele
    doubling scan: ceil(log2 S) rounds of batched matmuls (matrix product
    is associative), instead of a length-S sequential chain.
    """
    out = np.array(Ts, dtype=np.float64, copy=True)
    d = 1
    while d < len(out):
        nxt = out.copy()
        nxt[d:] = np.matmul(out[:-d], out[d:])
        out = nxt
        d *= 2
    return out


def boundary_transforms(seg_positions, seg_rotations) -> np.ndarray:
    """Per-segment end transform (4x4) in the segment's own frame."""
    out = []
    for p, R in zip(seg_positions, seg_rotations):
        T = np.eye(4)
        T[:3, :3] = R[-1]
        T[:3, 3] = p[-1]
        out.append(T)
    return np.asarray(out)


def stitch_segments(seg_positions, seg_rotations=None,
                    overlaps=None) -> Tuple[np.ndarray, np.ndarray]:
    """Chain per-segment trajectories into one global trajectory.

    seg_positions: list of (T_s, 3) per-segment positions (each from its own
    origin).  seg_rotations: optional list of (T_s, 3, 3) world-from-body
    rotations in the segment's own frame; used both for the overlap yaw fit
    and for the hard chain when no overlap exists.  overlaps: optional list
    of frame-overlap counts between consecutive segments; overlapping frames
    are aligned (4-DOF least squares on the overlap) instead of hard-chained.

    Returns (positions, offsets) where positions is the stitched (sum T, 3)
    trajectory and offsets the per-segment cumulative 4x4 transforms.
    """
    n = len(seg_positions)

    # Pairwise boundary transforms — each depends only on segments s-1, s.
    pair = [np.eye(4)]
    for s in range(1, n):
        prev_p = np.asarray(seg_positions[s - 1])
        cur_p = np.asarray(seg_positions[s])
        ov = overlaps[s - 1] if overlaps is not None else 0
        if ov and ov >= 2:
            cR = pR = None
            if seg_rotations is not None:
                cR = np.asarray(seg_rotations[s])[:ov]
                pR = np.asarray(seg_rotations[s - 1])[-ov:]
            T = fit_yaw_transform(cur_p[:ov], prev_p[-ov:], cR, pR)
        elif seg_rotations is not None:
            # hard chain: previous segment's end pose maps the new origin
            R_end = np.asarray(seg_rotations[s - 1])[-1]
            yaw = np.arctan2(R_end[1, 0], R_end[0, 0])
            T = np.eye(4)
            T[:3, :3] = _yaw_matrix(yaw)
            T[:3, 3] = prev_p[-1]
        else:
            T = np.eye(4)
            T[:3, 3] = prev_p[-1]
        pair.append(T)

    offsets = prefix_product(np.asarray(pair))

    stitched = [np.asarray(seg_positions[0])]
    for s in range(1, n):
        cur_p = np.asarray(seg_positions[s])
        skip = overlaps[s - 1] if overlaps is not None else 0
        cum = offsets[s]
        stitched.append((cum[:3, :3] @ cur_p[skip:].T).T + cum[:3, 3])
    return np.concatenate(stitched, axis=0), offsets
