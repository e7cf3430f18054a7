"""EuRoC MAV dataset loader (ASL folder format, no ROS required).

A copy of rvio_tpu/dataio/euroc.py; ``load_image`` can be told which
decoder to use.

The reference consumes EuRoC via rosbag replay with topic remapping
(reference: README.md:70-86).  We read the ASL directory layout directly:

    <root>/mav0/imu0/data.csv     timestamp[ns], w_xyz [rad/s], a_xyz [m/s^2]
    <root>/mav0/cam0/data.csv     timestamp[ns], filename
    <root>/mav0/cam0/data/*.png   8-bit grayscale frames

plus the ground truth for evaluation:

    <root>/mav0/state_groundtruth_estimate0/data.csv

Images decode through the C++ fast loader when built (native/dataloader),
else the pure-python PNG codec.
"""

from __future__ import annotations

import csv
import os
import subprocess
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from rvio_tpu_torch.dataio.png import read_png_gray


@dataclass
class EurocSequence:
    imu_t: np.ndarray        # (Ni,) seconds
    imu_w: np.ndarray        # (Ni,3)
    imu_a: np.ndarray        # (Ni,3)
    cam_t: np.ndarray        # (T,) seconds
    cam_files: List[str]     # (T,) png paths
    gt_t: Optional[np.ndarray] = None
    gt_p: Optional[np.ndarray] = None
    gt_q: Optional[np.ndarray] = None   # [w? no: qw qx qy qz per ASL]


def _read_csv(path: str):
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            rows.append(row)
    return rows


def load_euroc(root: str, skip_s: float = 0.0) -> EurocSequence:
    """Load a EuRoC sequence directory (the folder containing mav0/).

    ``skip_s`` drops the first seconds of data — the reference needs ~40 s
    skipped on the MH_* sequences before initialization (README.md:84).
    """
    mav = os.path.join(root, "mav0")
    imu_rows = _read_csv(os.path.join(mav, "imu0", "data.csv"))
    imu = np.asarray([[float(v) for v in r] for r in imu_rows])
    imu_t = imu[:, 0] * 1e-9
    imu_w = imu[:, 1:4]
    imu_a = imu[:, 4:7]

    cam_rows = _read_csv(os.path.join(mav, "cam0", "data.csv"))
    cam_t = np.asarray([float(r[0]) for r in cam_rows]) * 1e-9
    cam_files = [os.path.join(mav, "cam0", "data", r[1].strip())
                 for r in cam_rows]

    gt_t = gt_p = gt_q = None
    gt_path = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_path):
        gt_rows = _read_csv(gt_path)
        gt = np.asarray([[float(v) for v in r] for r in gt_rows])
        gt_t = gt[:, 0] * 1e-9
        gt_p = gt[:, 1:4]
        gt_q = gt[:, 4:8]

    if skip_s > 0:
        t0 = cam_t[0] + skip_s
        mi = imu_t >= t0 - 1.0 / 200.0
        imu_t, imu_w, imu_a = imu_t[mi], imu_w[mi], imu_a[mi]
        ci = cam_t >= t0
        cam_t = cam_t[ci]
        cam_files = [f for f, keep in zip(cam_files, ci) if keep]
        if gt_t is not None:
            gi = gt_t >= t0
            gt_t, gt_p, gt_q = gt_t[gi], gt_p[gi], gt_q[gi]

    return EurocSequence(imu_t=imu_t, imu_w=imu_w, imu_a=imu_a, cam_t=cam_t,
                         cam_files=cam_files, gt_t=gt_t, gt_p=gt_p, gt_q=gt_q)


def load_image(path: str, native: Optional[bool] = None) -> np.ndarray:
    """Decode one camera frame to (H, W) uint8: with the native loader
    (``native=True``; raises where it cannot be built), the pure-python
    codec (``False``), or the native loader where it builds, else the
    python codec (``None``)."""
    if native is False:
        return read_png_gray(path)
    from rvio_tpu_torch.dataio.native_loader import decode_png_gray
    if native:
        return decode_png_gray(path)
    try:
        return decode_png_gray(path)
    except (OSError, subprocess.CalledProcessError):
        return read_png_gray(path)


def iter_images(seq: EurocSequence) -> Iterator[Tuple[float, np.ndarray]]:
    for t, f in zip(seq.cam_t, seq.cam_files):
        yield t, load_image(f)
