"""Trajectory plot — the rviz trajectory/landmark topics, dependency-free.

The SVG half of rvio_tpu/utils/visualize.py, copied (numpy only).  The
reference publishes the trajectory and landmark topics for rviz
(reference: System.cc:386-434, Updater.cc:431-458); here a standalone SVG
of the estimated (and ground-truth) trajectory and the landmark map.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def trajectory_svg(est_p: np.ndarray,
                   gt_p: Optional[np.ndarray] = None,
                   landmarks: Optional[np.ndarray] = None,
                   axes=(0, 1), size: int = 640,
                   landmark_scale: Optional[float] = None) -> str:
    """Top-down (or chosen-axes) trajectory plot as an SVG string.

    ``landmark_scale`` is the landmark marker size in world units
    (Landmark.nScale, the reference's rviz cube edge, Updater.cc:61-63);
    None draws a fixed 1.2 px dot.
    """
    a, b = axes
    pts = [np.asarray(est_p)[:, [a, b]]]
    if gt_p is not None:
        pts.append(np.asarray(gt_p)[:, [a, b]])
    if landmarks is not None and len(landmarks):
        # include the cloud in the view, but robustly (5th..95th pctile so a
        # few far-away triangulations don't shrink the trajectory to a dot)
        lm2 = np.asarray(landmarks)[:, [a, b]]
        pts.append(np.percentile(lm2, [5, 95], axis=0))
    allp = np.concatenate(pts, axis=0)
    lo = allp.min(axis=0)
    hi = allp.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    pad = 0.05 * span

    def to_px(p):
        q = (p - lo + pad) / (span + 2 * pad) * (size - 20) + 10
        return q[:, 0], size - q[:, 1]

    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
             f'height="{size}" style="background:#fff">']
    if landmarks is not None:
        if landmark_scale is not None:
            # world units -> px via the plot's meters-per-pixel
            r = max(0.4, landmark_scale / float(max(span + 2 * pad))
                    * (size - 20) / 2)
        else:
            r = 1.2
        lx, ly = to_px(np.asarray(landmarks)[:, [a, b]])
        for x, y in zip(lx, ly):
            parts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="{r:.1f}" '
                         'fill="#bbb"/>')

    def polyline(p, color, width):
        x, y = to_px(p)
        s = " ".join(f"{xi:.1f},{yi:.1f}" for xi, yi in zip(x, y))
        parts.append(f'<polyline points="{s}" fill="none" stroke="{color}" '
                     f'stroke-width="{width}"/>')

    if gt_p is not None:
        polyline(np.asarray(gt_p)[:, [a, b]], "#2a7", 1.5)
    polyline(np.asarray(est_p)[:, [a, b]], "#d33", 1.5)
    parts.append('<text x="12" y="20" font-size="13" fill="#d33">estimate'
                 '</text>')
    if gt_p is not None:
        parts.append('<text x="12" y="38" font-size="13" fill="#2a7">ground '
                     'truth</text>')
    parts.append("</svg>")
    return "\n".join(parts)


def plot_trajectory_svg(path: str, est_p: np.ndarray,
                        gt_p: Optional[np.ndarray] = None,
                        landmarks: Optional[np.ndarray] = None,
                        axes=(0, 1), size: int = 640,
                        landmark_scale: Optional[float] = None) -> None:
    """Write :func:`trajectory_svg` to a file."""
    with open(path, "w") as f:
        f.write(trajectory_svg(est_p, gt_p=gt_p, landmarks=landmarks,
                               axes=axes, size=size,
                               landmark_scale=landmark_scale))
