"""TUM trajectory format IO.

The reference records ``timestamp px py pz qx qy qz qw`` lines
(reference: src/rvio/System.cc:371-374) consumable by standard ATE tools
(evo, rpg_trajectory_evaluation); we read/write the same format.
"""

from __future__ import annotations

import numpy as np


def write_tum(path: str, timestamps, positions, quaternions) -> None:
    """Write a TUM-format trajectory file (quat order x y z w)."""
    with open(path, "w") as f:
        for t, p, q in zip(np.asarray(timestamps), np.asarray(positions),
                           np.asarray(quaternions)):
            f.write(f"{t:.9f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")


def read_tum(path: str):
    """Read a TUM trajectory; returns (timestamps, positions, quaternions)."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    return data[:, 0], data[:, 1:4], data[:, 4:8]
