"""The operations and bytes a hand-written kernel's launch needs, from its
shapes alone: a frozen copy of the counting functions of the port's
ops/checks.py, and the published peaks of the card they are held against.

Only kernels whose counts follow from the configuration's shapes are
counted: K5 (the narrow EKF tail, n = 6 M, D = 24 + 6 M), K10 and K11
(CLAHE), K12 and K13 (Shi-Tomasi).  K1-K4 and K6-K9 need the data (valid
IMU samples, track lengths, LM iterations, KLT trips, refill corners),
which a launch does not report, so they are left out of the share.
"""

from __future__ import annotations

import numpy as np

F32 = 4                      # bytes of a float32
PEAK_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bytes/s

CLAHE_HIST_FLOPS_PER_PX = 4
CLAHE_LUT_FLOPS_PER_BIN = 8
CLAHE_APPLY_FLOPS_PER_PX = 12
CLAHE_AXIS_FLOPS = 10
SHI_NMS_FLOPS_PER_PX = 58
SHI_FLOPS_PER_PX = SHI_NMS_FLOPS_PER_PX - 8


def tile_shape(H: int, W: int, grid: int):
    return -(-H // grid), -(-W // grid)


def _chol_flops(n: int) -> int:
    w = np.arange(n)[::-1]
    return int((w * (w + 1) + w + 1).sum())


def ekf_tail_flops(n: int, D: int, fallback: bool = False) -> int:
    tri = n * (n + 1)
    k = np.arange(n)
    return int(_chol_flops(n) * (2 if fallback else 1) + n * n + D * tri
               + 2 * int(((n - k) ** 2).sum()) + n + _chol_flops(n)
               + 2 * D * n * n + 2 * n * D + D * tri + 2 * n * D * D
               + (D * (D + 1) // 2) * (4 * n + 2))


def ekf_tail_bytes(n: int, D: int) -> int:
    return (F32 * (n * (n + 1) // 2 + n + D * (D + 1) // 2 + 1)
            + F32 * (D + D * D) + 1)


def launch_counts(k: str, cfg, B: int):
    """(operations, bytes) of one launch of kernel ``k`` over a batch of B
    at ``cfg``'s shapes, or None where the count needs the data."""
    H, W = cfg.camera.height, cfg.camera.width
    g = 5
    if k == "K5":
        M = cfg.window_size
        n, D = 6 * M, 24 + 6 * M
        if n > 92:           # the wide route: several launches a call
            return None
        return B * ekf_tail_flops(n, D), B * ekf_tail_bytes(n, D)
    if k == "K10":
        th, tw = tile_shape(H, W, g)
        return (B * (CLAHE_HIST_FLOPS_PER_PX * th * tw * g * g
                     + CLAHE_LUT_FLOPS_PER_BIN * 256 * g * g),
                B * (F32 * H * W + F32 * 256 * g * g))
    if k == "K11":
        return (B * (CLAHE_APPLY_FLOPS_PER_PX * H * W
                     + CLAHE_AXIS_FLOPS * (H + W)),
                B * (F32 * (H * W + 256 * g * g) + F32 * H * W))
    if k == "K12":
        return B * SHI_FLOPS_PER_PX * H * W, B * 2 * F32 * H * W
    if k == "K13":
        return B * SHI_NMS_FLOPS_PER_PX * H * W, B * 2 * F32 * H * W
    return None


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
