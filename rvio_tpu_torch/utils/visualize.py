"""Debug visualization — the rviz-topic equivalents, dependency-free.

A copy of rvio_tpu/utils/visualize.py (numpy and the port's PNG writer).
The reference publishes tracked-feature and new-feature debug images plus
the trajectory/landmark topics for rviz (reference: Tracker.cc:135-176
DisplayTrack/DisplayNewer, System.cc:386-434, Updater.cc:431-458).
Headless equivalents here: annotated PNGs (tracks/detections over the
camera frame) and a standalone SVG of the estimated (and ground-truth)
trajectory and the landmark map.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from rvio_tpu_torch.dataio.png import write_png_gray


def _draw_disk(img, x, y, r, val):
    h, w = img.shape[:2]
    xi, yi = int(round(x)), int(round(y))
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dx * dx + dy * dy <= r * r:
                yy, xx = yi + dy, xi + dx
                if 0 <= yy < h and 0 <= xx < w:
                    img[yy, xx] = val


def _draw_line(img, x0, y0, x1, y1, val):
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    for i in range(n + 1):
        t = i / n
        x = int(round(x0 + t * (x1 - x0)))
        y = int(round(y0 + t * (y1 - y0)))
        if 0 <= y < img.shape[0] and 0 <= x < img.shape[1]:
            img[y, x] = val


def draw_tracks(image: np.ndarray, prev_pts: np.ndarray, new_pts: np.ndarray,
                inlier: np.ndarray) -> np.ndarray:
    """Annotate tracks like DisplayTrack: inliers disk+motion line (bright),
    outliers ring (dark)."""
    img = np.asarray(image, np.float32).copy()
    for p0, p1, ok in zip(np.asarray(prev_pts), np.asarray(new_pts),
                          np.asarray(inlier)):
        if ok:
            _draw_disk(img, p1[0], p1[1], 3, 255.0)
            _draw_line(img, p0[0], p0[1], p1[0], p1[1], 255.0)
        else:
            _draw_disk(img, p0[0], p0[1], 2, 0.0)
    return img


def draw_detections(image: np.ndarray, existing: np.ndarray,
                    new_pts: np.ndarray) -> np.ndarray:
    """Annotate detections like DisplayNewer: existing rings, new disks."""
    img = np.asarray(image, np.float32).copy()
    for p in np.asarray(existing):
        _draw_disk(img, p[0], p[1], 2, 0.0)
    for p in np.asarray(new_pts):
        _draw_disk(img, p[0], p[1], 3, 255.0)
    return img


def save_debug_image(path: str, img: np.ndarray) -> None:
    write_png_gray(path, np.clip(img, 0, 255).astype(np.uint8))


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
