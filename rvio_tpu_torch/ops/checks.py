"""Kernel-versus-plain checks at the filter's operating point.

For each kernel: seeded inputs (numpy, then moved to the device) at the
shapes the main path gives it under ``RVIOConfig()`` (K=16 IMU samples,
F=100 update features, L=15 track length, M=14 clones), a comparison of the
kernel's result with its plain version's on the same inputs with a stated
tolerance, the operations the function needs on these inputs (for the
roofline bound: from the structure of the matrices, and only the samples,
iterations, rows and columns this data uses), and, where one PyTorch call
computes the same function, that call.  ``chip_smoke.py`` and the GPU
tests run them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.core.so3 import rodrigues_np
from rvio_tpu_torch.ops import jac_project as k3
from rvio_tpu_torch.ops import lm_triangulate as k2
from rvio_tpu_torch.ops import propagate_block as k1
from rvio_tpu_torch.ops import spd_solve as k4


@dataclass
class KernelCheck:
    name: str
    source: str            # CUDA source, repo path
    replaces: str          # the TPU kernel's pallas_call, file:line
    kernel: Callable       # the wrapper (launches the kernel on CUDA)
    plain: Callable
    args: tuple
    kwargs: dict
    tolerance: str
    compare: Callable      # (kernel_out, plain_out) -> error; raises if over
    flops: float           # operations the function needs on these inputs
    library: Optional[Callable] = None   # one PyTorch call, same function

    def run_kernel(self):
        return self.kernel(*self.args, **self.kwargs)

    def run_plain(self):
        return self.plain(*self.args, **self.kwargs)

    def check(self) -> float:
        """Kernel vs plain on the same inputs; returns the compared error,
        raises AssertionError over the tolerance."""
        return self.compare(self.run_kernel(), self.run_plain())

    def tensors(self):
        """Every tensor the call reads, and (after a run) writes."""
        ins = [a for a in self.args if isinstance(a, torch.Tensor)]
        ins += [a for a in self.kwargs.values() if isinstance(a, torch.Tensor)]
        out = self.run_kernel()
        outs = list(out) if isinstance(out, tuple) else [out]
        return ins, outs


def _np(t):
    return t.detach().double().cpu().numpy()


def _fail(name, what, err, tol):
    raise AssertionError(f"{name}: {what} error {err:.3e} over tolerance {tol:.1e}")


# Nonzeros of Phi = I + dt F (PreIntegrator.cc:122-142): the diagonal, four
# skew blocks of 6, two identity blocks of 3 and three dense 3x3 blocks.
PHI_NNZ = 24 + 4 * 6 + 2 * 3 + 3 * 9
# Products in G Sigma G^T: G's columns 0-2 hold 3 nonzeros each, 3-11 one.
Q_PRODUCTS = 3 * 3 ** 2 + 9 * 1 ** 2
# The rest of one sample: Rodrigues and the f1..f4 coefficients, five 3x3
# products, four 3x3-by-vector products, and the entries of F and Phi
# (counted from propagate_block_plain, a transcendental as 10).
STATE_FLOPS = 640


def propagate_flops(n_valid: int) -> int:
    """Operations of K1 over ``n_valid`` samples with dt > 0 (a padded
    sample, dt = 0, is an identity step and needs none): P <- Phi P Phi^T
    and Psi <- Phi Psi as products with the nonzeros of Phi, Q's products
    with P's update, and the state."""
    per_sample = 3 * 2 * 24 * PHI_NNZ + 3 * Q_PRODUCTS + STATE_FLOPS
    return n_valid * per_sample


def _propagate_case(cfg, dev, rng) -> KernelCheck:
    """The case of the JAX package's TestPropagateBlockKernel: 11 valid
    samples of 16 (padding: dt = 0), one small-angle sample."""
    K = cfg.tpu.imu_block
    A = rng.normal(size=(24, 24)) * 0.01
    P0 = A @ A.T + np.eye(24) * 1e-4
    ax = rng.normal(size=3)
    R0 = rodrigues_np(ax / np.linalg.norm(ax), 1.0)
    w = rng.normal(size=(K, 3)) * 0.4
    w[3] = 1e-8
    a = rng.normal(size=(K, 3)) * 2.0 + [0, 0, 9.8]
    dte = np.where(np.arange(K) < 11, 0.005, 0.0)
    g = np.array([0.05, -0.02, 0.998])
    vecs = [rng.normal(size=3), g / np.linalg.norm(g),
            rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.05]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32)[None], device=dev)

    args = (t(w), t(a), t(dte), t(R0), *(t(v) for v in vecs), t(P0))
    kwargs = dict(gravity=cfg.imu.gravity, small_angle=cfg.imu.small_angle,
                  sigma_g=cfg.imu.sigma_g, sigma_wg=cfg.imu.sigma_wg,
                  sigma_a=cfg.imu.sigma_a, sigma_wa=cfg.imu.sigma_wa)
    tol = 1e-5

    def compare(ko, po):
        errs = []
        for i, (x, y) in enumerate(zip(ko, po)):
            x, y = _np(x), _np(y)
            s = np.abs(y).max() if i == 3 else 1.0     # P relative to its scale
            errs.append(np.abs(x - y).max() / s)
        err = max(errs)
        if not err <= tol:
            _fail("propagate_block", "max abs (P relative)", err, tol)
        return float(err)

    flops = propagate_flops(int((dte > 0).sum()))
    return KernelCheck(
        "propagate_block", "rvio_tpu_torch/csrc/propagate_block.cu",
        "rvio_tpu/ops/propagate_block.py:212", k1.propagate_block,
        k1.propagate_block_plain, args, kwargs,
        "max abs 1e-5 (P relative to max|P|)", compare, float(flops))


def _feature_geometry(cfg, rng, F, L):
    """Features seen along small-motion chains: relative chains (Rrel,
    trel), camera chains (Rc, tc), points at 2-8 m in camera frame 0 and
    their noisy normalized measurements."""
    R_bc, t_bc = cfg.camera.R_bc, cfg.camera.t_bc
    R_cb, t_cb = R_bc.T, -R_bc.T @ t_bc
    Rrel = np.zeros((F, L, 3, 3))
    trel = np.zeros((F, L, 3))
    for f in range(F):
        R, tv = np.eye(3), np.zeros(3)
        for m in range(L):
            if m:
                dR = rodrigues_np(rng.normal(size=3), 0.02)
                R, tv = dR @ R, dR @ (tv - rng.normal(size=3) * 0.05)
            Rrel[f, m], trel[f, m] = R, tv
    Rc = np.einsum("ab,flbc,cd->flad", R_cb, Rrel, R_bc)
    tc = (np.einsum("ab,flbc,c->fla", R_cb, Rrel, t_bc)
          + np.einsum("ab,flb->fla", R_cb, trel) + t_cb)
    d = np.stack([rng.uniform(-0.3, 0.3, F), rng.uniform(-0.3, 0.3, F),
                  np.ones(F)], axis=1)
    pts = rng.uniform(2.0, 8.0, (F, 1)) * d / np.linalg.norm(d, axis=1,
                                                             keepdims=True)
    h = np.einsum("flij,fj->fli", Rc, pts) + tc
    z = h[..., :2] / h[..., 2:] + rng.normal(size=(F, L, 2)) * 1e-3
    return Rrel, trel, Rc, tc, pts, z


def _lm_case(cfg, dev, rng) -> KernelCheck:
    F, L = cfg.tracker.max_update_features, cfg.tracker.max_tracking_length
    _, _, Rc, tc, _, z = _feature_geometry(cfg, rng, F, L)
    tl = rng.integers(2, L + 1, size=F)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    args = (t(z), t(Rc), t(tc), torch.as_tensor(tl, device=dev))
    kwargs = dict(sigma_im=cfg.camera.sigma_image)
    tol = 1e-4

    def compare(ko, po):
        ok = _np(po[3]).astype(bool)
        if not np.array_equal(_np(ko[3]).astype(bool), ok):
            raise AssertionError("lm_triangulate: ok flags differ")
        err = max(np.abs(_np(x) - _np(y))[ok].max(initial=0.0)
                  for x, y in zip(ko[:3], po[:3]))
        if not err <= tol:
            _fail("lm_triangulate", "phi/psi/rho max abs", err, tol)
        return float(err)

    # per iteration: 145 per measurement (chain point, projection, normal
    # equations), 90 for the damped 3x3 solve
    its = _np(k2.lm_iterations(*args, **kwargs))
    flops = int((its * (145 * tl + 90)).sum())
    return KernelCheck(
        "lm_triangulate", "rvio_tpu_torch/csrc/lm_triangulate.cu",
        "rvio_tpu/ops/lm_triangulate.py:177", k2.lm_triangulate,
        k2.lm_triangulate_plain, args, kwargs,
        "ok identical; phi/psi/rho max abs 1e-4", compare, float(flops))


def _jac_case(cfg, dev, rng) -> KernelCheck:
    F, L = cfg.tracker.max_update_features, cfg.tracker.max_tracking_length
    M = cfg.window_size
    J = L - 1
    Rrel, trel, Rc, tc, pts, z = _feature_geometry(cfg, rng, F, L)
    nrm = np.linalg.norm(pts, axis=1)
    phi = np.arcsin(pts[:, 1] / nrm) + rng.normal(size=F) * 1e-3
    psi = np.arctan2(pts[:, 0], pts[:, 2]) + rng.normal(size=F) * 1e-3
    rho = 1.0 / nrm * (1 + rng.normal(size=F) * 1e-2)
    t_eff = rng.integers(2, L + 1, size=F)
    c0 = rng.integers(0, M - t_eff + 2)           # c0 + t_eff - 1 <= M

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    args = (t(z), t(Rc), t(tc), t(Rrel), t(trel), t(Rc), t(tc), t(phi),
            t(psi), t(rho), torch.as_tensor(t_eff, device=dev),
            torch.as_tensor(c0, device=dev), t(cfg.camera.R_bc),
            t(cfg.camera.t_bc), M)
    tol_inv, tol_hfn = 1e-3, 1e-4

    def compare(ko, po):
        (rk, hk, fk), (rp, hp, fp) = ([_np(x) for x in o] for o in (ko, po))
        err_h = np.max(np.abs(fk - fp) / np.maximum(np.abs(fp), 1.0))
        if not err_h <= tol_hfn:
            _fail("jac_project", "hfn relative", err_h, tol_hfn)
        err = 0.0
        for a, b in ((np.einsum("frc,frd->fcd", hp, hp),
                      np.einsum("frc,frd->fcd", hk, hk)),
                     (np.einsum("frc,fr->fc", hp, rp),
                      np.einsum("frc,fr->fc", hk, rk)),
                     (np.einsum("fr,fr->f", rp, rp),
                      np.einsum("fr,fr->f", rk, rk))):
            sc = max(np.abs(a).max(), 1.0)
            err = max(err, np.abs(a - b).max() / sc)
        if not err <= tol_inv:
            _fail("jac_project", "H^T H / H^T r / r^T r scaled", err, tol_inv)
        return float(max(err, err_h))

    return KernelCheck(
        "jac_project", "rvio_tpu_torch/csrc/jac_project.cu",
        "rvio_tpu/ops/jac_project.py:262", k3.jac_project,
        functools.partial(k3.jac_project_plain, eps=k3.KERNEL_EPS), args, {},
        "H^T H, H^T r, r^T r within 1e-3 of their scale; hfn rtol 1e-4",
        compare, float(jac_project_flops(t_eff)))


def jac_project_flops(t_eff) -> int:
    """Operations of K3 for features using ``t_eff`` measurements each: the
    rows of those measurements and the chain columns they reach; the rows
    and columns beyond are zero and need no work."""
    total = 0
    for te in np.asarray(t_eff, np.int64):
        rows, cols = 2 * te, 3 + 6 * (te - 1) + 1
        total += 150 * te               # chain point, residual, Hf rows
        total += 80 * (te - 1)          # dpx and subH per chain column
        total += 72 * te * (te - 1) // 2   # Hx blocks: (2x3) @ (3x6)
        # reflection k: the norm, v^T A and the rank-1 update of the
        # (rows - k) x (cols - k) trailing block
        total += sum(4 * (rows - k) * (cols - k) for k in range(3))
    return int(total)


def _quadform_library(S, r):
    """One batched PyTorch Cholesky solve computing D (never used by the
    port; a yardstick)."""
    L, _ = torch.linalg.cholesky_ex(S)
    return torch.sum(r * torch.cholesky_solve(r[..., None], L)[..., 0], -1)


def _quadform_case(cfg, dev, rng, bad_lane=7) -> KernelCheck:
    F, m = cfg.tracker.max_update_features, 2 * cfg.tracker.max_tracking_length
    A = rng.normal(size=(F, m, m))
    S = A @ np.transpose(A, (0, 2, 1)) + 1e-2 * np.eye(m)
    S[bad_lane] -= 2 * np.abs(np.linalg.eigvalsh(S[bad_lane])).max() * np.eye(m)
    r = rng.normal(size=(F, m))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    tol = 2e-3   # f32 Cholesky; cond(S) reaches ~1e4 for these S

    def compare(ko, po):
        k, p = _np(ko), _np(po)
        nan = np.isnan(p)
        if not (np.array_equal(np.isnan(k), nan) and nan[bad_lane]
                and nan.sum() == 1):
            raise AssertionError("batched_quadform: the indefinite lane must "
                                 "be NaN and only it")
        err = np.max(np.abs(k - p)[~nan] / np.abs(p[~nan]))
        if not err <= tol:
            _fail("batched_quadform", "relative", err, tol)
        return float(err)

    # Cholesky: the lower trailing update of step k, (m-k-1)(m-k) / 2 entries
    # at 2 operations, its sqrt and m-k-1 divisions; forward substitution
    # m^2; the dot product 2m.  About F (m^3/3 + m^2).
    n = np.arange(m)
    flops = F * (int((n * (n + 1)).sum()) + m + int(n.sum()) + m * m + 2 * m)
    return KernelCheck(
        "batched_quadform", "rvio_tpu_torch/csrc/spd_solve.cu",
        "rvio_tpu/ops/spd_solve.py:75", k4.batched_quadform,
        k4.batched_quadform_plain, (t(S), t(r)), {},
        "rtol 2e-3; the indefinite lane NaN in both", compare, float(flops),
        library=_quadform_library)


def kernel_checks(device, seed: int = 0) -> List[KernelCheck]:
    """One check per kernel of the filter step, in the order it runs them."""
    cfg = RVIOConfig()
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    return [_propagate_case(cfg, dev, rng), _lm_case(cfg, dev, rng),
            _jac_case(cfg, dev, rng), _quadform_case(cfg, dev, rng)]
