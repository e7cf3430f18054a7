"""Chi-square 95% gating thresholds.

The reference bakes a 500-entry chi2(0.95, dof) lookup table into a header
(reference: src/util/Numerics.h:173-224).  We generate the same table at
import time with scipy (values agree to the reference's 6 printed decimals)
and expose it as a device-constant array for the Mahalanobis gate.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import chi2 as _chi2

MAX_DOF = 500

# chi2(0.95, dof) for dof = 1..500; index [dof-1] like the reference table.
CHI2_095: np.ndarray = _chi2.ppf(0.95, np.arange(1, MAX_DOF + 1)).astype(np.float64)


def chi2_gate_thresholds(max_dof: int, dtype=np.float32) -> np.ndarray:
    """First ``max_dof`` thresholds as the requested dtype (device constant)."""
    if max_dof > MAX_DOF:
        raise ValueError(f"max_dof {max_dof} exceeds table size {MAX_DOF}")
    return CHI2_095[:max_dof].astype(dtype)


def chi2_truncated_means(max_dof: int, dtype=np.float32) -> np.ndarray:
    """E[X | X < chi2(0.95, m)] for X ~ chi2_m, m = 1..max_dof.

    The adaptive-noise estimator compares accepted features' Mahalanobis
    distances against their expectation, but acceptance truncates the
    distribution at the 95th percentile — the consistent-filter target is
    this truncated mean, not m.  Identity: E[X 1{X<q}] = m F_{m+2}(q), so
    E[X | X<q] = m F_{m+2}(q) / 0.95.
    """
    if max_dof > MAX_DOF:
        raise ValueError(f"max_dof {max_dof} exceeds table size {MAX_DOF}")
    m = np.arange(1, max_dof + 1)
    q = CHI2_095[:max_dof]
    return (m * _chi2.cdf(q, m + 2) / 0.95).astype(dtype)
