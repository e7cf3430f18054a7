"""Kernel-versus-plain checks at the main paths' operating points.

For each kernel: seeded inputs (numpy, then moved to the device) at the
shapes the main path gives it under ``RVIOConfig()`` (filter: K=16 IMU
samples, F=100 update features, L=15 track length, M=14 clones; image
front-end: 752 x 480 frames, a 5 x 5 CLAHE grid, N=200 feature slots,
40 x 32 tiles (40 x 256 for K7), a 15 x 15 LK window, 10 subpix
iterations), a comparison of the kernel's result with
its plain version's on the same inputs with a stated tolerance, the
bytes the function must read and write and the operations it needs on
these inputs (for the roofline bound: from the structure of the matrices,
and only the samples, iterations, measurements and pixels this data uses;
never the size of an argument the function reads in part), and, where one
PyTorch call computes the same function, that call.  ``chip_smoke.py`` and
the GPU tests run them.  The case constructors (``propagate_case``,
``lm_case``, ``jac_case``, ``quadform_case``, ``ekf_tail_case``) also take
a real frame's inputs, and the segment-batched filter's shapes (B streams
or systems, B·F feature rows): ``batch_checks`` on seeded inputs,
chip_smoke.py on frame 100 of 16 segments.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.core.so3 import rodrigues_np
from rvio_tpu_torch.ops import ekf_tail as k5
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
    bytes_read: int        # bytes of input it needs, each read once
    bytes_written: int     # bytes of output, each written once
    library: Optional[Callable] = None   # one PyTorch call, same function
    info: dict = field(default_factory=dict)   # what ``compare`` counted
    check_launches: int = 1   # kernel launches one ``check`` makes

    def run_kernel(self):
        return self.kernel(*self.args, **self.kwargs)

    def run_plain(self):
        return self.plain(*self.args, **self.kwargs)

    def check(self) -> float:
        """Kernel vs plain on the same inputs; returns the compared error,
        raises AssertionError over the tolerance."""
        return self.compare(self.run_kernel(), self.run_plain())


def _np(t):
    return t.detach().double().cpu().numpy()


def _fail(name, what, err, tol):
    raise AssertionError(f"{name}: {what} error {err:.3e} over tolerance {tol:.1e}")


F32 = 4   # bytes of one f32 (and of one int32)
I64 = 8


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
    return propagate_case(cfg, dev, [x[None] for x in (w, a, dte, R0, *vecs,
                                                      P0)])


def propagate_case(cfg, dev, inputs, what: str = "") -> KernelCheck:
    """K1 on ``inputs`` (w, a, dte, R0, vR, gR, bg, ba, P0 with a leading
    stream axis, arrays or tensors, taken as f32) at ``cfg``'s IMU
    constants."""
    args = tuple(torch.as_tensor(np.asarray(x, np.float32), device=dev)
                 for x in inputs)
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
            _fail("propagate_block", f"max abs (P relative){what}", err, tol)
        return float(err)

    dte = _np(args[2])
    B, K = dte.shape
    n_valid = int((dte > 0).sum())
    # w and a of the samples with dt > 0, dte, R0, four vectors, P0 in;
    # R, p, v, P and Psi out
    read = F32 * (6 * n_valid + B * (K + 9 + 12 + 24 * 24))
    written = F32 * B * (9 + 3 + 3 + 2 * 24 * 24)
    return KernelCheck(
        "propagate_block", "rvio_tpu_torch/csrc/propagate_block.cu",
        "rvio_tpu/ops/propagate_block.py:212", k1.propagate_block,
        k1.propagate_block_plain, args, kwargs,
        "max abs 1e-5 (P relative to max|P|)", compare,
        float(propagate_flops(n_valid)), read, written,
        info={"valid samples": n_valid})


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
    return lm_case(dev, z, Rc, tc, tl, cfg.camera.sigma_image)


def lm_case(dev, z, Rc, tc, tl, sigma_im: float, what: str = ""
            ) -> KernelCheck:
    """K2 on ``z`` (F, L, 2), ``Rc`` (F, L, 3, 3), ``tc`` (F, L, 3) and the
    track lengths ``tl`` (F,) (arrays or tensors, taken as f32 and int64):
    the ok flags identical, phi/psi/rho of the ok features within 1e-4."""
    def t(x, dtype=np.float32):
        x = x.detach().cpu().numpy() if torch.is_tensor(x) else x
        return torch.as_tensor(np.asarray(x, dtype), device=dev)

    args = (t(z), t(Rc), t(tc), t(tl, np.int64))
    tl = _np(args[3]).astype(np.int64)
    F = len(tl)
    kwargs = dict(sigma_im=sigma_im)
    tol = 1e-4

    def compare(ko, po):
        ok = _np(po[3]).astype(bool)
        if not np.array_equal(_np(ko[3]).astype(bool), ok):
            raise AssertionError(f"lm_triangulate: ok flags differ{what}")
        err = max(np.abs(_np(x) - _np(y))[ok].max(initial=0.0)
                  for x, y in zip(ko[:3], po[:3]))
        if not err <= tol:
            _fail("lm_triangulate", f"phi/psi/rho max abs{what}", err, tol)
        return float(err)

    # per iteration: 145 per measurement (chain point, projection, normal
    # equations), 90 for the damped 3x3 solve
    its = _np(k2.lm_iterations(*args, **kwargs))
    flops = int((its * (145 * np.clip(tl, 0, None) + 90)).sum())
    # z, Rc, tc of each feature's tl measurements and tl in; phi, psi,
    # rho and ok out
    read = F32 * 14 * int(np.clip(tl, 0, None).sum()) + I64 * F
    written = (3 * F32 + 1) * F
    return KernelCheck(
        "lm_triangulate", "rvio_tpu_torch/csrc/lm_triangulate.cu",
        "rvio_tpu/ops/lm_triangulate.py:177", k2.lm_triangulate,
        k2.lm_triangulate_plain, args, kwargs,
        "ok identical; phi/psi/rho max abs 1e-4", compare, float(flops),
        read, written, info={"features": F})


def jac_inputs(cfg, rng, F: int, L: int, M: int, t_eff=None, c0=None):
    """K3's arguments (numpy, f32 values as f64 arrays, then t_eff, c0 as
    int64, then R_bc, t_bc, M) for F features of track length L in a
    window of M clones: small-motion chains, points at 2-8 m, triangulated
    angles and inverse depth with small errors; ``t_eff`` (F,) uniform in
    [2, L] and ``c0`` (F,) uniform with c0 + t_eff - 1 <= M unless given."""
    Rrel, trel, Rc, tc, pts, z = _feature_geometry(cfg, rng, F, L)
    nrm = np.linalg.norm(pts, axis=1)
    phi = np.arcsin(pts[:, 1] / nrm) + rng.normal(size=F) * 1e-3
    psi = np.arctan2(pts[:, 0], pts[:, 2]) + rng.normal(size=F) * 1e-3
    rho = 1.0 / nrm * (1 + rng.normal(size=F) * 1e-2)
    if t_eff is None:
        t_eff = rng.integers(2, L + 1, size=F)
    if c0 is None:
        c0 = rng.integers(0, M - t_eff + 2)       # c0 + t_eff - 1 <= M
    return [z, Rc, tc, Rrel, trel, Rc, tc, phi, psi, rho,
            np.asarray(t_eff, np.int64), np.asarray(c0, np.int64),
            cfg.camera.R_bc, cfg.camera.t_bc, M]


def _jac_case(cfg, dev, rng) -> KernelCheck:
    F, L = cfg.tracker.max_update_features, cfg.tracker.max_tracking_length
    return jac_case(dev, jac_inputs(cfg, rng, F, L, cfg.window_size))


def jac_case(dev, inputs, what: str = "") -> KernelCheck:
    """K3 on ``inputs`` (the 14 arrays or tensors of ``jac_project``, any
    device, floats taken as f32, t_eff and c0 as integers, then M)."""
    *arrays, M = inputs

    def t(x, dtype=np.float32):
        x = x.detach().cpu().numpy() if torch.is_tensor(x) else x
        return torch.as_tensor(np.asarray(x, dtype), device=dev)

    args = tuple(t(x, np.int64 if i in (10, 11) else np.float32)
                 for i, x in enumerate(arrays)) + (M,)
    t_eff = _np(args[10]).astype(np.int64)
    F, L = args[0].shape[:2]
    tol_inv, tol_hfn = 1e-3, 1e-4

    def compare(ko, po):
        (rk, hk, fk), (rp, hp, fp) = ([_np(x) for x in o] for o in (ko, po))
        err_h = np.max(np.abs(fk - fp) / np.maximum(np.abs(fp), 1.0),
                       initial=0.0)
        if not err_h <= tol_hfn:
            _fail("jac_project", f"hfn relative{what}", err_h, tol_hfn)
        err = 0.0
        for a, b in ((np.einsum("frc,frd->fcd", hp, hp),
                      np.einsum("frc,frd->fcd", hk, hk)),
                     (np.einsum("frc,fr->fc", hp, rp),
                      np.einsum("frc,fr->fc", hk, rk)),
                     (np.einsum("fr,fr->f", rp, rp),
                      np.einsum("fr,fr->f", rk, rk))):
            sc = max(np.abs(a).max(initial=0.0), 1.0)
            err = max(err, np.abs(a - b).max(initial=0.0) / sc)
        if not err <= tol_inv:
            _fail("jac_project", f"H^T H / H^T r / r^T r scaled{what}", err,
                  tol_inv)
        return float(max(err, err_h))

    # for each feature's t_eff measurements z (2 floats) and six chain
    # entries (Rc, tc, Rrel, trel at the linearization point, Rc, tc at
    # the estimate: 36), then phi, psi, rho, t_eff, c0, R_bc, t_bc in;
    # r, Hx and hfn out, whole
    read = F32 * (38 * int(t_eff.sum()) + 3 * F + 12) + 2 * I64 * F
    written = F32 * F * (2 * L + 2 * L * 6 * M + 1)
    return KernelCheck(
        "jac_project", "rvio_tpu_torch/csrc/jac_project.cu",
        "rvio_tpu/ops/jac_project.py:262", k3.jac_project,
        functools.partial(k3.jac_project_plain, eps=k3.KERNEL_EPS), args, {},
        "H^T H, H^T r, r^T r within 1e-3 of their scale; hfn rtol 1e-4",
        compare, float(jac_project_flops(t_eff)), read, written)


def jac_project_flops(t_eff) -> int:
    """Operations of K3 for features using ``t_eff`` measurements each: the
    rows of those measurements and the chain columns they reach; the rows
    and columns beyond are zero and need no work, nor does a feature with
    fewer than two measurements (its outputs are all masked)."""
    total = 0
    for te in np.asarray(t_eff, np.int64):
        if te < 2:              # every row masked: no work
            continue
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


def spd_systems(rng, F: int, m: int):
    """F seeded symmetric positive definite systems of order m (A A^T / m
    + 1e-2 I for a normal A: cond(S) at most about 400) and right-hand
    sides."""
    A = rng.normal(size=(F, m, m)) / np.sqrt(m)
    return A @ np.transpose(A, (0, 2, 1)) + 1e-2 * np.eye(m), \
        rng.normal(size=(F, m))


def _quadform_case(cfg, dev, rng, bad_lane=7) -> KernelCheck:
    F, m = cfg.tracker.max_update_features, 2 * cfg.tracker.max_tracking_length
    A = rng.normal(size=(F, m, m))
    S = A @ np.transpose(A, (0, 2, 1)) + 1e-2 * np.eye(m)
    S[bad_lane] -= 2 * np.abs(np.linalg.eigvalsh(S[bad_lane])).max() * np.eye(m)
    r = rng.normal(size=(F, m))
    return quadform_case(dev, S, r, nan_lanes=[bad_lane])


def quadform_case(dev, S, r, nan_lanes=None, what: str = "") -> KernelCheck:
    """K4 on ``S`` (F, m, m) and ``r`` (F, m) (arrays or tensors, taken
    as f32): NaN in the same lanes as the plain version (exactly
    ``nan_lanes`` where given), D within rtol 2e-3 elsewhere, and 0 where
    the plain version's D is 0 (a lane with r = 0)."""
    def t(x):
        x = x.detach().cpu().numpy() if torch.is_tensor(x) else x
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    args = (t(S), t(r))
    F, m = args[1].shape
    tol = 2e-3   # f32 Cholesky; cond(S) reaches ~1e4 for these S

    def compare(ko, po):
        k, p = _np(ko), _np(po)
        nan = np.isnan(p)
        if not np.array_equal(np.isnan(k), nan) or (
                nan_lanes is not None
                and not np.array_equal(np.flatnonzero(nan), nan_lanes)):
            raise AssertionError(f"batched_quadform: NaN lanes differ{what}")
        zero = ~nan & (p == 0)
        if not (k[zero] == 0).all():
            raise AssertionError(f"batched_quadform: D not 0 where the plain "
                                 f"version's is{what}")
        live = ~nan & ~zero
        err = np.max(np.abs(k - p)[live] / np.abs(p[live]), initial=0.0)
        if not err <= tol:
            _fail("batched_quadform", f"relative{what}", err, tol)
        return float(err)

    # Cholesky: the lower trailing update of step k, (m-k-1)(m-k) / 2 entries
    # at 2 operations, its sqrt and m-k-1 divisions; forward substitution
    # m^2; the dot product 2m.  About F (m^3/3 + m^2).
    n = np.arange(m)
    flops = F * (int((n * (n + 1)).sum()) + m + int(n.sum()) + m * m + 2 * m)
    # the lower triangle of S (all a Cholesky reads) and r in; D out
    read = F32 * F * (m * (m + 1) // 2 + m)
    return KernelCheck(
        "batched_quadform", "rvio_tpu_torch/csrc/spd_solve.cu",
        "rvio_tpu/ops/spd_solve.py:75", k4.batched_quadform,
        k4.batched_quadform_plain, args, {},
        "rtol 2e-3; NaN lanes identical" + (
            " (the indefinite lane)" if nan_lanes is not None else ""),
        compare, float(flops), read, F32 * F, library=_quadform_library,
        info={"features": F})


# --- image front-end (K6, K8, K9, K13) ----------------------------------------

def _texture(rng, H, W, passes=3):
    """A smooth random 0-255 image (box-blurred noise), f64 on the CPU."""
    x = torch.as_tensor(rng.uniform(0, 255, (1, 1, H + 8, W + 8)))
    for _ in range(passes):
        x = torch.nn.functional.avg_pool2d(x, 3, stride=1, padding=1,
                                           count_include_pad=False)
    x = x[0, 0, 4:-4, 4:-4]
    return (x - x.min()) / (x.max() - x.min()) * 255.0


def _frame_pair(cfg, rng, shift=(3.3, -2.1)):
    """A full-size textured frame and the same frame moved by ``shift``
    (x, y) px, both f32 on the CPU, and 200 feature points on it (grid
    points, jittered, some within a few px of the border)."""
    from rvio_tpu_torch.frontend.image import bilinear_sample
    H, W = cfg.camera.height, cfg.camera.width
    N = cfg.tracker.num_features
    base = _texture(rng, H + 40, W + 40)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                            torch.arange(W, dtype=torch.float64), indexing="ij")
    src = torch.stack([xx + 20 - shift[0], yy + 20 - shift[1]], -1)
    img1 = base[20:20 + H, 20:20 + W]
    img2 = bilinear_sample(base, src)
    gy, gx = np.meshgrid(np.linspace(3, H - 4, 10), np.linspace(3, W - 4, 20),
                         indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel()], -1)[:N]
    pts = pts + rng.uniform(-2, 2, pts.shape)
    return img1.float(), img2.float(), pts


def _tap_span(loc, taps: int, r: int, size: int):
    """First and last index (rows or columns) that ``taps`` bilinear taps
    starting ``r`` before ``floor(loc)`` read in a tile of ``size``, each
    tap's pair clipped to [0, size-2] (the oracle's ``_sample_patches``)."""
    f = np.floor(np.asarray(loc, np.float64)).astype(np.int64)
    return (np.clip(f - r, 0, size - 2),
            np.clip(f - r + taps - 1, 0, size - 2) + 1)


def _box_union(shape, boxes) -> int:
    """Pixels of ``shape`` (N, TH, TW) covered by per-tile boxes: each box
    (y0, y1, x0, x1, on) holds (N,) inclusive bounds and a mask of the
    tiles it applies to."""
    N, TH, TW = shape
    hit = np.zeros(shape, bool)
    rows, cols = np.arange(TH), np.arange(TW)
    for y0, y1, x0, x1, on in boxes:
        ry = (rows >= y0[:, None]) & (rows <= y1[:, None])
        rx = (cols >= x0[:, None]) & (cols <= x1[:, None])
        hit |= ry[:, :, None] & rx[:, None, :] & np.asarray(on)[:, None, None]
    return int(hit.sum())


# operations per pixel of K13: Sobel pair 14, products 3, box sums 3 x 8,
# eigenvalue 9 (sqrt as 1), NMS 8 comparisons
SHI_NMS_FLOPS_PER_PX = 58


def shi_library(img: torch.Tensor):
    """K12's yardstick, a chain of library calls computing the same map
    (no single PyTorch call does): the Sobel/8 gradients and the 3x3 box
    sums by ``F.conv2d``, the eigenvalue formula, and the 2-px border by
    ``torch.where``.  Returns the function of ``img``, its constants made
    once on ``img``'s device (so a CUDA graph can capture it)."""
    F = torch.nn.functional
    H, W = img.shape
    dt, dev = img.dtype, img.device
    sob = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                       dtype=dt, device=dev) / 8
    grad_w = torch.stack([sob, sob.T])[:, None]          # (2, 1, 3, 3)
    box_w = torch.ones((3, 1, 3, 3), dtype=dt, device=dev)
    row = torch.arange(H, device=dev)[:, None]
    col = torch.arange(W, device=dev)[None, :]
    inner = (row >= 2) & (row < H - 2) & (col >= 2) & (col < W - 2)
    zero = torch.zeros((), dtype=dt, device=dev)

    def run(x):
        g = F.conv2d(x[None, None], grad_w, padding=1)
        ix, iy = g[:, :1], g[:, 1:]
        s = F.conv2d(torch.cat([ix * ix, ix * iy, iy * iy], 1), box_w,
                     padding=1, groups=3)[0]
        tr = s[0] + s[2]
        det = s[0] * s[2] - s[1] * s[1]
        return torch.where(inner, (tr - torch.sqrt(
            torch.clamp(tr * tr - 4 * det, min=0.0))) * 0.5, zero)

    return run


def shi_nms_library(img: torch.Tensor):
    """K13's yardstick: :func:`shi_library`'s chain, then the 3x3 maximum
    by ``F.max_pool2d(3, 1, 1)`` and the mask by equality and
    ``torch.where``."""
    response = shi_library(img)
    ninf = torch.full((), float("-inf"), dtype=img.dtype, device=img.device)

    def run(x):
        resp = response(x)
        peak = torch.nn.functional.max_pool2d(resp[None, None], 3, 1, 1)[0, 0]
        return torch.where(resp == peak, resp, ninf)

    return run


def shi_nms_case(dev, img: torch.Tensor, what: str = "") -> KernelCheck:
    """K13 on an (H, W) f32 image (the tracker's level 0 after CLAHE)."""
    from rvio_tpu_torch.ops import shi_tomasi as k13
    img = img.to(dev)
    H, W = img.shape
    tol = 1e-5
    info = {}

    def compare(ko, po):
        k, p = _np(ko), _np(po)
        fk, fp = np.isfinite(k), np.isfinite(p)
        both = fk & fp
        info["pixels_differing"] = int((k.view(np.int64) != p.view(np.int64))
                                       .sum())
        err = float(np.max(np.abs(k[both] - p[both])
                           / np.maximum(np.abs(p[both]), 1e-30),
                           initial=0.0))
        flips = np.argwhere(fk != fp)
        info["mask_flips"] = len(flips)
        if len(flips):
            # a flip is allowed only on a near-tie of the response with a
            # neighbour
            resp = _np(k13.shi_tomasi_response(img))
            rp = np.pad(resp, 1, constant_values=-np.inf)
            for y, x in flips:
                nb = np.delete(rp[y:y + 3, x:x + 3].ravel(), 4).max()
                if abs(resp[y, x] - nb) > tol * max(abs(resp[y, x]), 1e-30):
                    raise AssertionError(f"shi_tomasi_nms{what}: mask flip "
                                         f"at {(y, x)} is no near-tie")
        if not err <= tol:
            _fail("shi_tomasi_nms", "relative", err, tol)
        return err

    return KernelCheck(
        "shi_tomasi_nms", "rvio_tpu_torch/csrc/shi_tomasi_nms.cu",
        "rvio_tpu/ops/shi_tomasi.py:165", k13.shi_tomasi_nms,
        k13.shi_tomasi_nms_plain, (img,), {},
        "rel 1e-5 where both finite; -inf mask flips only on near-ties "
        "(bitwise expected; differing pixels counted)",
        compare, float(SHI_NMS_FLOPS_PER_PX * H * W), F32 * H * W,
        F32 * H * W, library=shi_nms_library(img), info=info)


def _shi_nms_case(cfg, dev, rng) -> KernelCheck:
    H, W = cfg.camera.height, cfg.camera.width
    return shi_nms_case(dev, _texture(rng, H, W, passes=1).float())


def _tile_case(cfg, dev, rng) -> KernelCheck:
    from rvio_tpu_torch.frontend.klt import tile_origins
    img, _, pts = _frame_pair(cfg, rng)
    H, W = img.shape
    return tile_case(dev, img, tile_origins(torch.as_tensor(pts), H, W))


def tile_case(dev, img, o, what: str = "") -> KernelCheck:
    """K6 on an (H, W) f32 image and (N, 2) int32 origins (any device; the
    check runs on ``dev``), compared bitwise."""
    from rvio_tpu_torch.frontend.klt import TILE, TILE_H
    from rvio_tpu_torch.ops import tile_gather as k6
    H, W = img.shape
    o = o.to(dev)
    img = img.to(dev)
    # the tiles' pixel indices, clamped as the plain version clamps them
    # (tiles taller or wider than the image repeat its last row or column)
    oy = torch.clamp(o[:, 1], 0, max(H - TILE_H, 0))
    ox = torch.clamp(o[:, 0], 0, max(W - TILE, 0))
    rows = torch.clamp(oy[:, None] + torch.arange(TILE_H, device=dev),
                       max=H - 1).long()
    cols = torch.clamp(ox[:, None] + torch.arange(TILE, device=dev),
                       max=W - 1).long()

    def library(*_):
        """The one indexing call (the clamped indices made beforehand)."""
        return img[rows[:, :, None], cols[:, None, :]]

    def compare(ko, po):
        if not torch.equal(ko, po):
            raise AssertionError(f"gather_tiles{what}: kernel and plain "
                                 f"differ")
        return 0.0

    # the image pixels the clamped tiles cover (their union: tiles may
    # overlap) and the origins in; the tiles out
    oc = o.cpu().numpy()
    y0 = np.clip(oc[:, 1], 0, max(H - TILE_H, 0))
    x0 = np.clip(oc[:, 0], 0, max(W - TILE, 0))
    covered = np.zeros((H, W), bool)
    for y, x in zip(y0, x0):
        covered[y:y + TILE_H, x:x + TILE] = True
    N = len(oc)
    return KernelCheck(
        "gather_tiles", "rvio_tpu_torch/csrc/tile_gather.cu",
        "rvio_tpu/ops/tile_gather.py:157", k6.gather_tiles,
        k6.gather_tiles_plain, (img, o, TILE_H, TILE), {}, "exact", compare,
        0.0, F32 * (int(covered.sum()) + 2 * N), F32 * N * TILE_H * TILE,
        library=library)


def _lk_inputs(cfg, rng):
    img1, img2, pts = _frame_pair(cfg, rng)
    return lk_inputs(img1, img2, pts, cfg.tracker.klt_window)


def lk_inputs(img1, img2, pts, win: int):
    """K8's arguments at level 0 for points ``pts`` (N, 2) xy of ``img1``
    tracked into ``img2`` from their own positions: the tiles around them,
    status the in-bounds test.  Returns (args, (H, W))."""
    from rvio_tpu_torch.frontend.klt import TILE, TILE_H, tile_origins
    from rvio_tpu_torch.ops.tile_gather import gather_tiles_plain
    H, W = img1.shape
    p = torch.as_tensor(pts, dtype=torch.float32)
    o = tile_origins(p, H, W)
    r = win // 2 + 1
    inb = ((p[:, 0] > r) & (p[:, 0] < W - r - 1)
           & (p[:, 1] > r) & (p[:, 1] < H - r - 1))
    t_tiles = gather_tiles_plain(img1, o, TILE_H, TILE)
    n_tiles = gather_tiles_plain(img2, o, TILE_H, TILE)
    return (t_tiles, n_tiles, p - o.float(), p, o, inb), (H, W)


def lk_level_flops(trips, TH: int, TW: int, win: int, last: bool) -> int:
    """Operations of K8: per feature the tile Scharr (10 a pixel), three
    sampled patches (8 a tap) and the 2x2 system (6 a tap), then for each
    Gauss-Newton trip it ran one sampled patch and its right-hand side
    (13 a tap, 20 for the step), and at the last level the error (10 a
    tap)."""
    area = win * win
    setup = 10 * TH * TW + 3 * 8 * area + 6 * area + (10 * area if last else 0)
    trips = np.asarray(trips, np.int64)
    return int(len(trips) * setup + trips.sum() * (13 * area + 20))


def lk_level_reads(args, kwargs) -> int:
    """Tile pixels one LK level reads, by the plain version's run on these
    inputs: around each template centre the window's bilinear support
    and the Scharr halo, and in each search tile the union of the window
    supports at every position a live trip samples (and, at the last
    level, the final one)."""
    from rvio_tpu_torch.ops import klt_iterate as k8
    t_tiles, n_tiles, loc0, g_init, o1, status = args
    N, TH, TW = t_tiles.shape
    win = kwargs["win"]
    r = win // 2
    every = np.ones(N, bool)
    pixels = _box_union((N, TH, TW), [(
        *(x.numpy() for x in k8.template_support(loc0, win, TH, TW)),
        every)])

    def after(k):
        kw = dict(kwargs, max_iters=k, last=False)
        g, alive, _, trips = k8.lk_level_trips(*args, **kw)
        return g.double().numpy(), alive.numpy(), trips.numpy()

    o = o1.double().numpy()
    boxes = []
    g, _, trips = after(0)
    for k in range(kwargs["max_iters"]):
        g_next, alive_next, trips_next = after(k + 1)
        # trip k + 1 samples where the feature ran it and passed its
        # wander test
        on = (trips_next > trips) & alive_next
        if not on.any():
            break
        loc = np.stack([np.clip(g[:, 0] - o[:, 0], 0, TW - 1),
                        np.clip(g[:, 1] - o[:, 1], 0, TH - 1)], -1)
        boxes.append((*_tap_span(loc[:, 1], win, r, TH),
                      *_tap_span(loc[:, 0], win, r, TW), on))
        g, trips = g_next, trips_next
    if kwargs["last"]:
        loc = np.stack([np.clip(g[:, 0] - o[:, 0], 0, TW - 1),
                        np.clip(g[:, 1] - o[:, 1], 0, TH - 1)], -1)
        boxes.append((*_tap_span(loc[:, 1], win, r, TH),
                      *_tap_span(loc[:, 0], win, r, TW), every))
    return pixels + _box_union((N, TH, TW), boxes)


def _lk_case(cfg, dev, rng) -> KernelCheck:
    from rvio_tpu_torch.frontend.klt import TILE
    args, hw = _lk_inputs(cfg, rng)
    win = cfg.tracker.klt_window
    kwargs = dict(win=win, max_iters=cfg.tracker.klt_max_iters,
                  eps=cfg.tracker.klt_eps, min_eig=cfg.tracker.klt_min_eig,
                  wander=float(TILE - win) / 2.0 - 1.0, last=True, hw=hw)
    return lk_case(dev, args, kwargs)


LK_POS_TOL = 1e-3
LK_ALIVE_AGREE = 0.995


def compare_lk(ko, po, what: str = "", info=None) -> float:
    """K8's outputs (guess, status, err) against its plain version's: the
    status flags agree on at least LK_ALIVE_AGREE of the features, and
    where both are alive positions and errors within LK_POS_TOL px (two
    summation orders; a feature whose trips end at the wander or eps test
    may part).  Returns that error, raises over the tolerance; ``info``
    gets the agreement and the alive count."""
    info = {} if info is None else info
    (gk, sk, ek), (gp, sp, ep) = ([_np(x) for x in o] for o in (ko, po))
    sk, sp = sk.astype(bool), sp.astype(bool)
    info["alive_agree"] = float((sk == sp).mean()) if len(sp) else 1.0
    info["alive"] = int(sp.sum())
    if not info["alive_agree"] >= LK_ALIVE_AGREE:
        raise AssertionError(f"lk_level{what}: alive flags agree on "
                             f"{info['alive_agree']:.3f} < {LK_ALIVE_AGREE}")
    both = sk & sp
    err = float(max(np.abs(gk - gp)[both].max(initial=0.0),
                    np.abs(ek - ep)[both].max(initial=0.0)))
    if not err <= LK_POS_TOL:
        _fail(f"lk_level{what}", "position/err max abs (alive in both)",
              err, LK_POS_TOL)
    return err


def lk_well_posed(args, kwargs) -> torch.Tensor:
    """The features on which one LK level is well posed in f32: its
    plain version in f32 (CPU tensors ``args``) keeps the f64 status and,
    where live, lands within a quarter of LK_POS_TOL of the f64 result.  A
    feature that oscillates through all its trips parts by more than that
    between any two f32 summation orders (tests/test_torch_cuda.py
    ``_lk_against_plain``); raises if more than a tenth of the features
    live in f64 are not well posed."""
    from rvio_tpu_torch.ops import klt_iterate as k8
    g32, s32, _ = k8.lk_level_plain(*args, **kwargs)
    g64, s64, _ = k8.lk_level_plain(*(x.double() if x.is_floating_point()
                                      else x for x in args), **kwargs)
    off = (g32.double() - g64).abs().amax(dim=1) > LK_POS_TOL / 4
    posed = (s32 == s64) & ~(s64 & off)
    if int((~posed).sum()) > 0.1 * max(int(s64.sum()), 1):
        raise AssertionError(f"lk_level: {int((~posed).sum())} of "
                             f"{int(s64.sum())} live features are not well "
                             f"posed in f32 (more than a tenth)")
    return posed


def lk_case(dev, args, kwargs, what: str = "",
            well_posed: bool = False) -> KernelCheck:
    """K8 on ``args`` (t_tiles, n_tiles, loc0, g_init, o1, status; any
    device, the check runs on ``dev``) and ``kwargs``; ``info["trips"]``
    holds each feature's trip count from the plain version.  With
    ``well_posed`` the comparison takes only the features of
    :func:`lk_well_posed` (``info["set_aside"]`` counts the others)."""
    from rvio_tpu_torch.ops import klt_iterate as k8
    args = tuple(x.cpu() for x in args)
    N, TH, TW = args[0].shape
    win = kwargs["win"]
    trips = _np(k8.lk_level_trips(*args, **kwargs)[3]).astype(np.int64)
    # tile pixels, then loc0, g_init, o1 and status in; the guess, the
    # status and err out
    read = F32 * (lk_level_reads(args, kwargs) + 6 * N) + N
    written = (3 * F32 + 1) * N
    keep = lk_well_posed(args, kwargs) if well_posed else None
    args = tuple(x.to(dev) for x in args)
    info = {}
    tol = ("alive agree >= 99.5 %; position and err 1e-3 where both "
           "alive")
    if keep is not None:
        info["set_aside"] = int((~keep).sum())
        tol += (" (on the features well posed in f32: the plain f32 keeps "
                "the f64 status and lies within 2.5e-4 px of it; at most a "
                "tenth of the live set aside)")
        keep = keep.to(dev)

    def compare(ko, po):
        if keep is not None:
            ko, po = (tuple(x[keep] for x in o) for o in (ko, po))
        return compare_lk(ko, po, what, info)

    chk = KernelCheck(
        "lk_level", "rvio_tpu_torch/csrc/lk_level.cu",
        "rvio_tpu/ops/klt_iterate.py:265", k8.lk_level, k8.lk_level_plain,
        args, kwargs, tol, compare,
        float(lk_level_flops(trips, TH, TW, win, kwargs["last"])), read,
        written, info=info)
    chk.trips = trips
    return chk


def subpix_flops(n: int, win: int, iters: int) -> int:
    """Operations of K9: per corner and iteration the (2 win + 3)^2 patch
    (8 a tap), the 15 x 15 gradient products and sums (24 a tap) and the
    2x2 solve (20)."""
    size = 2 * win + 1
    return n * iters * (8 * (size + 2) ** 2 + 24 * size * size + 20)


def subpix_reads(tiles, origin, pts, win: int, iters: int) -> int:
    """Tile pixels cornerSubPix reads, by the plain version's run: the
    union over the iterations of each corner's (2 win + 3)^2 patch
    support."""
    from rvio_tpu_torch.ops import klt_iterate as k9
    N, TH, TW = tiles.shape
    ps = 2 * win + 3
    o = origin.double().numpy()
    boxes = []
    for k in range(iters):
        c = k9.subpix_refine_plain(tiles, origin, pts, win=win,
                                   iters=k).double().numpy()
        ly = np.clip(c[:, 1] - o[:, 1], 0, TH - 1)
        lx = np.clip(c[:, 0] - o[:, 0], 0, TW - 1)
        boxes.append((*_tap_span(ly, ps, ps // 2, TH),
                      *_tap_span(lx, ps, ps // 2, TW), np.ones(N, bool)))
    return _box_union((N, TH, TW), boxes)


def subpix_case(dev, tiles, origin, pts, win: int, iters: int,
                what: str = "") -> KernelCheck:
    """K9 on (N, TH, TW) f32 tiles at int32 origins (N, 2) and f32 corners
    (N, 2), CPU tensors."""
    from rvio_tpu_torch.ops import klt_iterate as k9
    tiles, origin, pts = (x.detach().cpu() for x in (tiles, origin, pts))
    N = len(pts)
    tol = 1e-3
    info = {}

    def compare(ko, po):
        e = np.abs(_np(ko) - _np(po)).max(axis=1, initial=0.0)
        if not len(e):
            return 0.0
        n = int(np.argmax(e))
        err = float(e[n])
        # the worst corner's 2 x 2 system at the plain version's result:
        # its determinant and the condition number of the structure tensor
        g = [_np(x)[0] for x in k9.subpix_system(
            tiles[n:n + 1], origin[n:n + 1],
            po.detach().cpu()[n:n + 1].float(), win)]
        gxx, gxy, gyy = (float(x) for x in g[:3])
        ev = np.linalg.eigvalsh(np.array([[gxx, gxy], [gxy, gyy]]))
        info.update(worst_corner=n, worst_at=[round(float(x), 3)
                                             for x in _np(po)[n]],
                    worst_det=float(gxx * gyy - gxy * gxy),
                    worst_cond=float(ev[1] / max(ev[0], 1e-30)),
                    median_err=float(np.median(e)))
        if len(po) == N:
            # how far the function itself parts between f32 and f64 here
            p64 = k9.subpix_refine_plain(tiles.double(), origin,
                                         pts.double(), win=win, iters=iters)
            info["plain_f32_vs_f64"] = float(np.abs(_np(po) - p64.numpy())
                                             .max())
        if not err <= tol:
            _fail(f"subpix_refine{what}", "max abs px", err, tol)
        return err

    # tile pixels, the origins and the corners in; the corners out
    read = F32 * (subpix_reads(tiles, origin, pts, win, iters) + 4 * N)
    return KernelCheck(
        "subpix_refine", "rvio_tpu_torch/csrc/subpix_refine.cu",
        "rvio_tpu/ops/klt_iterate.py:361", k9.subpix_refine,
        k9.subpix_refine_plain,
        (tiles.to(dev), origin.to(dev), pts.to(dev)),
        dict(win=win, iters=iters), "max abs 1e-3 px", compare,
        float(subpix_flops(N, win, iters)), read, F32 * 2 * N, info=info)


def _subpix_case(cfg, dev, rng) -> KernelCheck:
    from rvio_tpu_torch.frontend.klt import TILE, TILE_H, tile_origins
    from rvio_tpu_torch.ops.tile_gather import gather_tiles_plain
    img, _, pts = _frame_pair(cfg, rng)
    H, W = img.shape
    p = torch.as_tensor(pts, dtype=torch.float32)
    o = tile_origins(p, H, W)
    tiles = gather_tiles_plain(img, o, TILE_H, TILE)
    return subpix_case(dev, tiles, o, p,
                       int(cfg.tracker.min_distance) // 2,
                       cfg.tracker.subpix_iters)


# --- CLAHE (K10, K11), the response alone (K12), aligned tiles (K7) ----------

def _checker_frame(rng, H, W, n_corners=150, blob=4):
    """A frame as the synthetic renderer draws one (dataio/synthetic.py
    render_frame): a background of 80 +- 20 gray levels and a 2 x 2
    checker corner of 230 and 20 at each of ``n_corners`` random points,
    f32 on the CPU.  Its pixels fall on few histogram bins, as the main
    path's frames do."""
    yy, xx = np.mgrid[0:H, 0:W]
    img = 80.0 + 20.0 * np.cos(2 * np.pi * xx / W) * np.cos(2 * np.pi * yy / H)
    for x, y in zip(rng.integers(0, W, n_corners), rng.integers(0, H, n_corners)):
        x0, x1 = max(x - blob, 0), min(x + blob, W)
        y0, y1 = max(y - blob, 0), min(y + blob, H)
        img[y0:y, x0:x] = img[y:y1, x:x1] = 230.0
        img[y0:y, x:x1] = img[y:y1, x0:x] = 20.0
    return torch.as_tensor(img, dtype=torch.float32)


# operations of K10 per pixel (clamp, truncate, count) and per bin (clip,
# excess, spread, CDF, scale, round); of K11 per pixel (bin, four LUT
# reads, the row and column blends: 2 products and a fused product-sum
# per tile column, 2 products and a sum; the tile coordinates per row and
# column are counted once each)
CLAHE_HIST_FLOPS_PER_PX = 4
CLAHE_LUT_FLOPS_PER_BIN = 8
CLAHE_APPLY_FLOPS_PER_PX = 12
CLAHE_AXIS_FLOPS = 10


def _clahe_luts_case(cfg, dev, rng) -> KernelCheck:
    img = _checker_frame(rng, cfg.camera.height, cfg.camera.width)
    return clahe_luts_case(dev, img)


def clahe_luts_case(dev, img, clip: float = 3.0, g: int = 5,
                    what: str = "") -> KernelCheck:
    """K10 on the (H, W) image ``img`` (any device; f32): LUTs bitwise and
    histograms exact against the plain versions run on the CPU."""
    from rvio_tpu_torch.ops import clahe as k10
    img = img.detach().float().cpu()
    H, W = img.shape
    cpu_luts = k10.clahe_luts_plain(img, clip, g)
    cpu_hist = k10.clahe_hist_plain(img, g)
    img = img.to(dev)
    th, tw = k10.tile_shape(H, W, g)
    x = torch.nn.functional.pad(img[None, None], (0, tw * g - W, 0, th * g - H),
                                mode="reflect")[0, 0]
    tile = ((torch.arange(th * g, device=dev) // th)[:, None] * g
            + (torch.arange(tw * g, device=dev) // tw)[None, :])
    key = (tile * 256 + torch.clamp(x, 0, 255).long()).reshape(-1)
    info = {}

    def library(*_):
        """The histogram half alone: one bincount of tile * 256 + bin."""
        return torch.bincount(key, minlength=g * g * 256)

    def compare(ko, po):
        # the histograms from a second launch that also writes them out;
        # the timed call is the tracker's, which writes the LUTs alone
        hist = k10._luts_and_hist(img, clip, g)[1].cpu()
        if not torch.equal(hist.long(), cpu_hist):
            raise AssertionError(f"clahe_luts: histograms differ from the "
                                 f"plain version's{what}")
        luts = ko.cpu()
        info["lut_entries_differing_from_cpu_plain"] = int(
            (luts != cpu_luts).sum())
        info["lut_entries_differing_from_card_plain"] = int(
            (luts != po.cpu()).sum())
        if info["lut_entries_differing_from_cpu_plain"]:
            raise AssertionError(f"clahe_luts: {info['lut_entries_differing_from_cpu_plain']}"
                                 f" LUT entries differ from the CPU plain "
                                 f"version{what}")
        return float((luts - cpu_luts).abs().max())

    return KernelCheck(
        "clahe_luts", "rvio_tpu_torch/csrc/clahe.cu",
        "rvio_tpu/ops/clahe.py:94", k10.clahe_luts, k10.clahe_luts_plain,
        (img,), dict(clip_limit=clip, grid=g),
        "histograms exact, LUTs bitwise with the plain version on the CPU",
        compare, float(CLAHE_HIST_FLOPS_PER_PX * th * tw * g * g
                       + CLAHE_LUT_FLOPS_PER_BIN * 256 * g * g),
        F32 * H * W, F32 * 256 * g * g, library=library, info=info,
        check_launches=2)


def clahe_apply_library(img: torch.Tensor, grid: int = 5):
    """K11's yardstick, a chain of library calls computing the same map
    (no single PyTorch call does): the bins by ``torch.clamp`` and a
    conversion, the four LUT entries by indexing on the tile and bin
    indices, the row blends by ``torch.addcmul`` and the column blend.  The
    tiles and weights of each row and column, which depend on the shape
    alone, are made once on ``img``'s device, so the chain reads nothing
    back and a CUDA graph can capture it; returns its function of (image,
    LUTs)."""
    from rvio_tpu_torch.ops import clahe as k11
    H, W = img.shape
    th, tw = k11.tile_shape(H, W, grid)
    ty0, ty1, wy0, wy1 = (x[:, None] for x in k11.blend_axis(
        H, th, grid, img.dtype, img.device))
    tx0, tx1, wx0, wx1 = k11.blend_axis(W, tw, grid, img.dtype, img.device)
    rows = [t * grid for t in (ty0, ty1)]

    def run(x, luts):
        b = torch.clamp(x, 0, luts.shape[1] - 1).long()
        s = [torch.addcmul(wy0 * luts[rows[0] + tj, b], wy1,
                           luts[rows[1] + tj, b]) for tj in (tx0, tx1)]
        return s[0] * wx0 + s[1] * wx1

    return run


def _clahe_apply_case(cfg, dev, rng) -> KernelCheck:
    from rvio_tpu_torch.ops import clahe as k11
    img = _checker_frame(rng, cfg.camera.height, cfg.camera.width)
    return clahe_apply_case(dev, img, k11.clahe_luts_plain(img, 3.0, 5), 5)


def clahe_apply_case(dev, img, luts, g: int, what: str = "") -> KernelCheck:
    """K11 on the (H, W) f32 image ``img`` and its (g^2, 256) LUTs (CPU
    tensors): bitwise expected against the plain version on the CPU."""
    from rvio_tpu_torch.ops import clahe as k11
    img, luts = img.detach().float().cpu(), luts.detach().float().cpu()
    H, W = img.shape
    cpu_out = k11.clahe_apply_plain(img, luts, g)
    tol = 1e-3
    info = {}
    img, luts = img.to(dev), luts.to(dev)

    def compare(ko, po):
        k = ko.cpu()
        info["pixels_differing_from_cpu_plain"] = int((k != cpu_out).sum())
        info["max_abs_vs_card_plain"] = float((k - po.cpu()).abs().max())
        err = float((k - cpu_out).abs().max())
        if not err <= tol:
            _fail(f"clahe_apply{what}", "max abs gray vs the CPU plain "
                  "version", err, tol)
        return err

    return KernelCheck(
        "clahe_apply", "rvio_tpu_torch/csrc/clahe.cu",
        "rvio_tpu/ops/clahe.py:132", k11.clahe_apply, k11.clahe_apply_plain,
        (img, luts), dict(grid=g),
        "max abs 1e-3 gray vs the plain version on the CPU (bitwise "
        "expected; differing pixels counted)", compare,
        float(CLAHE_APPLY_FLOPS_PER_PX * H * W + CLAHE_AXIS_FLOPS * (H + W)),
        F32 * (H * W + 256 * g * g), F32 * H * W,
        library=clahe_apply_library(img, g), info=info)


# operations per pixel of K12: K13's without the 8 NMS comparisons
SHI_FLOPS_PER_PX = SHI_NMS_FLOPS_PER_PX - 8


def _shi_case(cfg, dev, rng) -> KernelCheck:
    H, W = cfg.camera.height, cfg.camera.width
    return shi_case(dev, _texture(rng, H, W, passes=1).float())


def shi_case(dev, img: torch.Tensor, what: str = "") -> KernelCheck:
    """K12 on an (H, W) f32 image."""
    from rvio_tpu_torch.ops import shi_tomasi as k12
    img = img.to(dev)
    H, W = img.shape
    tol = 1e-5
    info = {}

    def compare(ko, po):
        k, p = _np(ko), _np(po)
        info["pixels_differing"] = int((k != p).sum())
        err = float(np.max(np.abs(k - p) / np.maximum(np.abs(p), 1e-30)))
        if not err <= tol:
            _fail(f"shi_tomasi{what}", "relative", err, tol)
        return err

    return KernelCheck(
        "shi_tomasi", "rvio_tpu_torch/csrc/shi_tomasi_nms.cu",
        "rvio_tpu/ops/shi_tomasi.py:90", k12.shi_tomasi,
        k12.shi_tomasi_response, (img,), {},
        "rel 1e-5 (bitwise expected; differing pixels counted)", compare,
        float(SHI_FLOPS_PER_PX * H * W), F32 * H * W, F32 * H * W,
        library=shi_library(img), info=info)


def aligned_tile_reads(origin, H: int, W: int, th: int, tw: int) -> int:
    """Image pixels K7's tiles cover (their union) at these origins."""
    from rvio_tpu_torch.ops.tile_gather import aligned_origins
    o = aligned_origins(torch.as_tensor(origin).cpu(), H, W, th, tw).numpy()
    covered = np.zeros((H, W), bool)
    for x, y in o:
        covered[y:y + th, x:x + tw] = True
    return int(covered.sum())


def _aligned_tile_case(cfg, dev, rng) -> KernelCheck:
    from rvio_tpu_torch.ops import tile_gather as k7
    img, _, pts = _frame_pair(cfg, rng)
    H, W = img.shape
    th, tw = 40, 256
    # tiles centred on the 200 feature points, as a wide-window tracker
    # would place them
    o = torch.as_tensor(np.round(pts - [tw / 2, th / 2]).astype(np.int32))
    oa = k7.aligned_origins(o, H, W, th, tw).to(dev)
    img, o = img.to(dev), o.to(dev)
    rows = (oa[:, 1, None] + torch.arange(th, device=dev)).long()
    cols = (oa[:, 0, None] + torch.arange(tw, device=dev)).long()

    def library(*_):
        """The one indexing call (aligned origins already in bounds)."""
        return img[rows[:, :, None], cols[:, None, :]]

    def compare(ko, po):
        if not torch.equal(ko, po):
            raise AssertionError("gather_tiles_aligned: kernel and plain "
                                 "differ")
        return 0.0

    N = o.shape[0]
    return KernelCheck(
        "gather_tiles_aligned", "rvio_tpu_torch/csrc/tile_gather.cu",
        "rvio_tpu/ops/tile_gather.py:124", k7.gather_tiles_aligned,
        k7.gather_tiles_aligned_plain, (img, o), dict(th=th, tw=tw), "exact",
        compare, 0.0,
        F32 * (aligned_tile_reads(o, H, W, th, tw) + 2 * N),
        F32 * N * th * tw, library=library)


# --- the fused EKF tail (K5) -------------------------------------------------

def _chol_flops(n: int) -> int:
    """A lower Cholesky factorization: the lower half of each trailing
    update (2 a entry), the column's divisions and the pivot's sqrt."""
    w = np.arange(n)[::-1]            # trailing width after each pivot
    return int((w * (w + 1) + w + 1).sum())


def ekf_tail_flops(n: int, D: int, fallback: bool) -> int:
    """Operations of K5 for one system, from the structure of its matrices:
    the factor of C (twice where the wider ridge was taken), rn, the
    triangular product Lc^T P[24:, :], the lower half of S and its factor,
    the two triangular solves for K^T (D right-hand sides), dx, G^T = Lc K^T,
    (I - K Hn) P through the n live columns of K Hn, and the lower half of
    the Joseph form (two n-long sums a entry)."""
    tri = n * (n + 1)                  # 2 x the entries of a triangle
    k = np.arange(n)
    return int(_chol_flops(n) * (2 if fallback else 1) + n * n + D * tri
               + 2 * int(((n - k) ** 2).sum()) + n + _chol_flops(n)
               + 2 * D * n * n + 2 * n * D + D * tri + 2 * n * D * D
               + (D * (D + 1) // 2) * (4 * n + 2))


def ekf_tail_bytes(n: int, D: int) -> tuple:
    """(read, written) bytes of K5 for one system: the lower triangle of C
    (all a factorization reads), b, the upper triangle of P (the kernel
    takes P's symmetry), sig2; dx, P_new whole and the fallback flag."""
    return (F32 * (n * (n + 1) // 2 + n + D * (D + 1) // 2 + 1),
            F32 * (D + D * D) + 1)


# kernel vs plain on the inputs that take the wider ridge, whose factor of
# C + 1e-5 tr(C) I has a condition number near 1e5: H100 runs read
# 2.3e-5 to 3.1e-5 of the largest entry (chip_smoke.py), under a limit of
# about 20x the f32 rounding such a factor amplifies.
EKF_TAIL_FALLBACK_TOL = 5e-4
# P_new's error scaled entry by entry by sqrt(P_new[i, i] P_new[j, j]) of
# the plain version, so that the small, well-observed blocks count as much
# as the largest: the error relative to the largest entry can miss a fault
# there (on the seeded stack a P_new without sig2 K K^T stays within 2e-5
# of the largest entry and is over 0.5 away scaled:
# tests/test_torch_ekf_tail.py).  With both routes in the chain's order of
# the Joseph form (csrc/ekf_tail.cu since it was repaired), an H100 run of
# chip_smoke.py read 6.6e-6 on the seeded stack, 1.3e-6 on the feature
# path's frame 100, 1.1e-5 on scripts/joseph_order.py's stack at n = 84
# and 9.1e-6 at n = 96, 6.2e-7 to 1.8e-6 on the wide windows' last
# updates (n = 96 to 384, and four at once at 192) and 1.3e-6 at B = 16.
# Five times the largest would be 5.4e-5; but the unfused chain's own f32
# rounding against f64 on the seeded stack, 1.7e-5, must stay under a
# fifth of the limit (tests/test_torch_ekf_tail.py), so the limit is
# 1e-4, nine times the largest reading.  Past n = 92 it grows as n / 92
# (:func:`ekf_tail_tol`): the unfused chain's own f32 rounding does (on
# scripts/joseph_order.py's stacks it parts from f64 by 1.2e-4 at
# n = 192 and 1e-3 at 384), and a random stack at n = 384 reads 1.7e-4
# between kernel and chain (tests/test_torch_cuda.py
# test_ekf_tail_wide_route).  The narrow kernel's earlier
# order (A P = P - G P[24:, :] after the product) read 4.9e-4 to 8.7e-4
# on ten seeded stacks (scripts/kernel_margins.py) and 5.9e-4 at n = 84
# emulated in f32, so it fails the limit
# (tests/test_torch_wide_windows.py, the chain order admitted, the
# earlier one not).  The seeded wider-ridge cases, whose factor is
# conditioned near 1e5, keep their own limit (they read 5.2e-5 to 5.4e-3
# over ten seeds).
EKF_TAIL_SCALED_TOL = 1e-4
EKF_TAIL_FALLBACK_SCALED_TOL = 5e-2


def scaled_cov_err(Pk: np.ndarray, Pp: np.ndarray) -> float:
    """max |Pk - Pp| / sqrt(Pp_ii Pp_jj) over the entries whose diagonals
    are positive (the rest, a dead clone's zero rows, are held by the
    absolute comparison)."""
    d = np.sqrt(np.clip(np.diagonal(Pp, axis1=-2, axis2=-1), 0.0, None))
    den = d[..., :, None] * d[..., None, :]
    live = den > 0
    if not live.any():
        return 0.0
    return float((np.abs(Pk - Pp)[live] / den[live]).max())


def joseph_p_new(C, b, P, sig2, chain_order: bool) -> torch.Tensor:
    """P_new of one system (C (n, n), b (n,), P (D, D), sig2 a scalar) in
    the dtype of C, with the Joseph form taken in the chain's order
    ((I - K Hn) P (I - K Hn)^T, I - K Hn formed first; S symmetrized: ops/
    ekf_tail.py ``cholesky_tail``, csrc/ekf_tail_wide.cu and the TPU
    kernel) or in the narrow kernel's (csrc/ekf_tail.cu step 6: A P = P -
    G P[24:, :], X = A P - (A P)[:, 24:] G^T, G = K Lc^T; S's lower
    triangle)."""
    n, D = C.shape[-1], P.shape[-1]
    Lc, _ = k5.info_cholesky(C)
    PHt = P[:, k5.NX:] @ Lc
    S = Lc.T @ PHt[k5.NX:] + sig2 * torch.eye(n, dtype=C.dtype)
    S = 0.5 * (S + S.T) if chain_order else (
        torch.tril(S) + torch.tril(S, -1).T)
    Ls = k5.nan_cholesky(S)
    W = torch.linalg.solve_triangular(Ls, PHt.T, upper=False)
    K = torch.linalg.solve_triangular(Ls.T, W, upper=True).T
    G = K @ Lc.T
    if chain_order:
        E = torch.eye(D, dtype=C.dtype)
        E[:, k5.NX:] -= G
        X = E @ P @ E.T + sig2 * (K @ K.T)
    else:
        AP = P - G @ P[k5.NX:]
        X = AP - AP[:, k5.NX:] @ G.T + sig2 * (K @ K.T)
    return 0.5 * (X + X.T)


def ekf_tail_tol(tol: float, n: int) -> float:
    """A K5 limit, ``tol``, stated for the narrow kernel (n <= NMAX = 92),
    at size n: the wide route's f32 sums are n long, and a factorization's
    rounding error grows with its order (n eps in the backward error), so
    past NMAX the limit grows as n / NMAX (4.2 tol at n = 384).  Both K5
    limits take it: on dx and P_new relative to their largest entry, and
    on P_new scaled by its diagonal."""
    return tol * max(1.0, n / k5.NMAX)


def ekf_tail_case(dev, C, b, P, sig2, tol: float, what: str,
                  scaled_tol: float = EKF_TAIL_SCALED_TOL) -> KernelCheck:
    """K5 on one system (numpy f32 arrays C (n, n), b (n,), P (D, D) and
    the scalar sig2) or on B systems (each with a leading axis B): kernel
    vs plain on the same inputs, system by system the fallback flags
    equal, NaN where the plain version is NaN, dx and P_new within
    ``tol`` of their largest entry and P_new within ``scaled_tol`` of its
    diagonal's scale (:func:`scaled_cov_err`), each :func:`ekf_tail_tol`
    of it past n = 92.  The library yardstick is the unfused chain
    (``cholesky_tail``), which the plain version runs for each system: for
    B systems, once over the leading axis (batched library calls)."""
    batched = np.ndim(C) == 3
    n, D = np.shape(C)[-1], np.shape(P)[-1]
    tol = ekf_tail_tol(tol, n)
    scaled_tol = ekf_tail_tol(scaled_tol, n)

    def t(x):
        x = np.asarray(x, np.float32)
        return torch.as_tensor(x if batched else x[None], device=dev)

    args = (t(C), t(b), t(P), t(sig2))
    flags = _np(k5.ekf_tail_plain(*(a.cpu() for a in args))[2]).astype(bool)
    info = {"fallback": bool(flags.any())}
    if batched:
        info.update(systems=len(flags), wider_ridge=int(flags.sum()))

    def compare(ko, po):
        (dk, Pk, fk), (dp, Pp, fp) = ([_np(x) for x in o] for o in (ko, po))
        if not np.array_equal(fk, fp):
            raise AssertionError(f"ekf_tail: fallback flags {fk} (kernel) vs "
                                 f"{fp} (plain)")
        for x, y, name in ((dk, dp, "dx"), (Pk, Pp, "P_new")):
            if not np.array_equal(np.isnan(x), np.isnan(y)):
                raise AssertionError(f"ekf_tail: {name} NaN where the plain "
                                     f"version is not, or the reverse")
        err = scaled = 0.0
        tiny = np.finfo(np.float32).tiny     # a system with dx = 0: absolute
        for i in range(len(fp)):
            if np.isnan(dp[i]).all():
                continue
            err = max(err, np.abs(dk[i] - dp[i]).max()
                      / max(np.abs(dp[i]).max(), tiny),
                      np.abs(Pk[i] - Pp[i]).max()
                      / max(np.abs(Pp[i]).max(), tiny))
            scaled = max(scaled, scaled_cov_err(Pk[i], Pp[i]))
        if not err <= tol:
            _fail("ekf_tail", "dx/P_new max abs relative to the largest entry",
                  err, tol)
        info["P_new scaled by its diagonal"] = f"{scaled:.3e}"
        if not scaled <= scaled_tol:
            _fail("ekf_tail", "P_new error scaled by sqrt(P_ii P_jj)", scaled,
                  scaled_tol)
        return float(err)

    def library(C, b, P, sig2):
        if batched:
            return k5.cholesky_tail(C, b, P, sig2)
        return k5.cholesky_tail(C[0], b[0], P[0], sig2[0])

    read, written = ekf_tail_bytes(n, D)
    return KernelCheck(
        "ekf_tail", "rvio_tpu_torch/csrc/" + (
            "ekf_tail.cu" if n <= k5.NMAX else "ekf_tail_wide.cu"),
        "rvio_tpu/ops/ekf_tail.py:256", k5.ekf_tail, k5.ekf_tail_plain, args,
        {}, f"{what}: fallback identical, NaN identical, dx and P_new max abs "
        f"{tol:.2g} of their largest entry, P_new {scaled_tol:.2g} scaled by "
        f"its diagonal" + (", system by system" if batched else ""), compare,
        float(sum(ekf_tail_flops(n, D, f) for f in flags)),
        read * len(flags), written * len(flags), library=library, info=info)


def ekf_tail_stack(rng, M: int, n_rows: int, masked_frac: float = 0.5,
                   dead_clones: int = 0, sig2: float = 2.3e-6):
    """The inputs of tests/test_ops.py::TestEkfTailKernel: C and b from a
    random row stack of which the last ``masked_frac`` is gate-masked to
    zero, a random SPD P, and ``dead_clones`` trailing clones with zero
    columns in H and zero rows and columns in P (the growth phase), f32."""
    CM, D = 6 * M, 24 + 6 * M
    H = rng.normal(size=(n_rows, CM)).astype(np.float32) * 0.5
    if dead_clones:
        H[:, CM - 6 * dead_clones:] = 0.0
    live = int(n_rows * (1 - masked_frac))
    H[live:] = 0.0
    r = (rng.normal(size=n_rows) * 0.01).astype(np.float32)
    r[live:] = 0.0
    A = rng.normal(size=(D, D)) * 0.02
    P = np.asarray(A @ A.T + np.eye(D) * 1e-4, np.float32)
    if dead_clones:
        P[D - 6 * dead_clones:, :] = 0.0
        P[:, D - 6 * dead_clones:] = 0.0
    return H.T @ H, H.T @ r, P, np.float32(sig2)


def ekf_tail_fallback_inputs(rng, n: int = 84, rows: int = 40):
    """Inputs on which K5 must take the wider ridge: C = A^T A of ``rows``
    < n rows with two collinear dominant columns (as three accepted
    features give), minus 1e-6 tr(C) along one direction of its null space,
    the rounding loss that makes a pivot of the 1e-8 ridge's factor
    negative, made large enough that every summation order fails there and
    that the n eps ridge (1e-5 tr(C) at n = 84) succeeds; the stack's b, a
    random SPD P and the operating point's sig2, all f32."""
    A = rng.normal(size=(rows, n))
    A[:, 1] = 1.5 * A[:, 0]
    A[:, :2] *= 30.0
    v = np.linalg.svd(A)[2][-1]              # a null direction of A
    C = A.T @ A
    C -= 1e-6 * np.trace(C) * np.outer(v, v)
    r = rng.normal(size=rows) * 0.01
    D = 24 + n
    G = rng.normal(size=(D, D)) * 0.02
    P = G @ G.T + np.eye(D) * 1e-4
    return (np.float32(C), np.float32(A.T @ r), np.float32(P),
            np.float32(2.3e-6))


def kernel_checks(device, seed: int = 0) -> List[KernelCheck]:
    """One check per kernel: the filter step's, in the order it runs them,
    then the image front-end's, then (drawing later from the same seeded
    stream, so the earlier checks keep their inputs) the equalizer's, K12,
    K7 and K5 (the flagship case of tests/test_ops.py::TestEkfTailKernel:
    M = 14, 3000 rows, half of them masked, at its tolerance)."""
    cfg = RVIOConfig()
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    return [_propagate_case(cfg, dev, rng), _lm_case(cfg, dev, rng),
            _jac_case(cfg, dev, rng), _quadform_case(cfg, dev, rng),
            _tile_case(cfg, dev, rng), _lk_case(cfg, dev, rng),
            _subpix_case(cfg, dev, rng), _shi_nms_case(cfg, dev, rng),
            _clahe_luts_case(cfg, dev, rng), _clahe_apply_case(cfg, dev, rng),
            _shi_case(cfg, dev, rng), _aligned_tile_case(cfg, dev, rng),
            ekf_tail_case(dev, *ekf_tail_stack(rng, cfg.window_size, 3000),
                          tol=2e-5, what="seeded stack")]


# segments of the batched filter's checks (bench.py's batched_fps batch)
BATCH = 16


def batch_checks(device, B: int = BATCH, seed: int = 0) -> List[KernelCheck]:
    """The filter kernels at the segment-batched filter's shapes, on seeded
    inputs: K1 for B streams (each its own count of valid samples), K2, K3
    and K4 on B·F feature rows, K5 for B systems (each a seeded stack of
    :func:`ekf_tail_stack`, at its tolerance)."""
    cfg = RVIOConfig()
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    K, M = cfg.tpu.imu_block, cfg.window_size
    F, L = cfg.tracker.max_update_features * B, cfg.tracker.max_tracking_length
    streams = []
    for _ in range(B):
        A = rng.normal(size=(24, 24)) * 0.01
        ax = rng.normal(size=3)
        g = np.array([0.05, -0.02, 0.998]) + rng.normal(size=3) * 0.01
        streams.append([
            rng.normal(size=(K, 3)) * 0.4,
            rng.normal(size=(K, 3)) * 2.0 + [0, 0, 9.8],
            np.where(np.arange(K) < rng.integers(1, K + 1), 0.005, 0.0),
            rodrigues_np(ax / np.linalg.norm(ax), 1.0), rng.normal(size=3),
            g / np.linalg.norm(g), rng.normal(size=3) * 0.01,
            rng.normal(size=3) * 0.05, A @ A.T + np.eye(24) * 1e-4])
    k1 = propagate_case(cfg, dev, [np.stack(x) for x in zip(*streams)],
                        what=f" (B = {B})")
    _, _, Rc, tc, _, z = _feature_geometry(cfg, rng, F, L)
    k2 = lm_case(dev, z, Rc, tc, rng.integers(2, L + 1, size=F),
                 cfg.camera.sigma_image, what=f" (B·F = {F})")
    k3 = jac_case(dev, jac_inputs(cfg, rng, F, L, M), what=f" (B·F = {F})")
    A = rng.normal(size=(F, 2 * L, 2 * L))
    S = A @ np.transpose(A, (0, 2, 1)) + 1e-2 * np.eye(2 * L)
    k4 = quadform_case(dev, S, rng.normal(size=(F, 2 * L)),
                       what=f" (B·F = {F})")
    stacks = [ekf_tail_stack(rng, M, 3000) for _ in range(B)]
    k5 = ekf_tail_case(dev, *(np.stack(x) for x in zip(*stacks)), tol=2e-5,
                       what=f"seeded stacks, B = {B}")
    return [k1, k2, k3, k4, k5]



# --- the image kernels with a segment axis (the batched tracker) -------------

# the kernels whose batched form flattens the segments into rows (K9)
_ROW_KERNELS = ("subpix_refine",)


def batch_case(singles: List[KernelCheck], what: str = "") -> KernelCheck:
    """One launch of the image kernel of ``singles`` (one check a segment,
    the same kernel and keyword arguments, inputs of one shape) on their
    inputs stacked along a leading segment axis (K9: concatenated as rows),
    against its plain version on the same stacked inputs, segment by
    segment with that segment's own comparison and tolerance.  K8 is also
    held bitwise against a single launch a segment (each segment keeps its
    own T).  The work is the segments' together: their operations and
    bytes add up.  ``info`` lists each segment's comparison counts."""
    first = singles[0]
    B = len(singles)
    rows = first.name in _ROW_KERNELS

    def join(xs):
        if not torch.is_tensor(xs[0]):
            return xs[0]
        return torch.cat(xs) if rows else torch.stack(xs)

    def part(out, b):
        if isinstance(out, tuple):
            return tuple(part(o, b) for o in out)
        if rows:
            n = out.shape[0] // B
            return out[b * n:(b + 1) * n]
        return out[b]

    args = tuple(join([c.args[i] for c in singles])
                 for i in range(len(first.args)))
    info = {}

    def compare(ko, po):
        errs = [c.compare(part(ko, b), part(po, b))
                for b, c in enumerate(singles)]
        for key in singles[0].info:
            info[key] = [c.info.get(key) for c in singles]
        if first.name == "lk_level":
            for b, c in enumerate(singles):
                one = first.kernel(*c.args, **c.kwargs)
                if not all(torch.equal(x, y) for x, y in zip(part(ko, b), one)):
                    raise AssertionError(f"lk_level{what}: segment {b} of the "
                                         f"batched launch differs from its "
                                         f"single launch")
            info["bitwise_vs_single_launches"] = True
        return max(errs)

    extra = B if first.name == "lk_level" else 0
    return KernelCheck(
        first.name, first.source, first.replaces, first.kernel, first.plain,
        args, first.kwargs,
        f"each of {B} segments: {first.tolerance}"
        + ("; bitwise with a single launch a segment" if extra else ""),
        compare, float(sum(c.flops for c in singles)),
        sum(c.bytes_read for c in singles),
        sum(c.bytes_written for c in singles), info=info,
        check_launches=1 + B * (first.check_launches - 1) + extra)


def image_batch_checks(device, B: int = 4, seed: int = 0
                       ) -> List[KernelCheck]:
    """The batched tracker's image kernels at B segments on seeded inputs
    (:func:`batch_case` of a seeded check a segment): K6, K8, K9 (B·N
    rows), K13, K10, K11."""
    cfg = RVIOConfig()
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    makers = (_tile_case, _lk_case, _subpix_case, _shi_nms_case,
              _clahe_luts_case, _clahe_apply_case)
    return [batch_case([make(cfg, dev, rng) for _ in range(B)],
                       what=f" (B = {B})") for make in makers]


# BASELINE.json's high-rate stress config, 4x the feature budget and a
# deeper pyramid, as the bench's knobs set it (rvio_tpu_torch/bench.py
# ``bench_config``)
STRESS_ENV = {"BENCH_FEATURES": "800", "BENCH_KLT_LEVELS": "4"}


def stress_checks(device, seed: int = 0) -> List[KernelCheck]:
    """K6 and K8 at the stress config's coarsest pyramid level (level 4 of
    480 x 752: a 30 x 47 image, smaller than a tile, so K6 takes its
    edge-clamped branch) and K9 near the corners of a full frame, each at
    N = 800 lanes on seeded inputs."""
    from rvio_tpu_torch.bench import bench_config
    from rvio_tpu_torch.frontend.image import bilinear_sample
    from rvio_tpu_torch.frontend.klt import TILE, TILE_H, tile_origins
    from rvio_tpu_torch.ops.tile_gather import gather_tiles_plain
    cfg = bench_config(STRESS_ENV)
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    N = cfg.tracker.num_features
    top = cfg.tracker.klt_levels
    scale = 2 ** top
    H, W = cfg.camera.height // scale, cfg.camera.width // scale
    base = _texture(rng, H + 40, W + 40)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                            torch.arange(W, dtype=torch.float64),
                            indexing="ij")
    img1 = base[20:20 + H, 20:20 + W].float()
    img2 = bilinear_sample(base, torch.stack([xx + 19.6, yy + 20.3],
                                             -1)).float()
    pts = rng.uniform((1.0, 1.0), (W - 2.0, H - 2.0), (N, 2))
    win = cfg.tracker.klt_window
    args, hw = lk_inputs(img1, img2, pts, win)
    kwargs = dict(win=win, max_iters=cfg.tracker.klt_max_iters,
                  eps=cfg.tracker.klt_eps, min_eig=cfg.tracker.klt_min_eig,
                  wander=float(TILE - win) / 2.0 - 1.0, last=False, hw=hw)
    level = f" (level {top}, {H}x{W}, N = {N})"
    checks = [tile_case(dev, img1, tile_origins(torch.as_tensor(
                  pts, dtype=torch.float32), H, W), what=level),
              lk_case(dev, args, kwargs, what=level)]
    # K9 near the checker corners of a rendered-like frame (its corner
    # positions drawn again from the same seed), a px or so off each
    Hf, Wf = cfg.camera.height, cfg.camera.width
    img = _checker_frame(np.random.default_rng(seed), Hf, Wf, N)
    at = np.random.default_rng(seed)
    xy = np.stack([at.integers(0, Wf, N), at.integers(0, Hf, N)], -1)
    p = torch.as_tensor(np.clip(xy + rng.uniform(-1.0, 1.0, (N, 2)),
                                (8.0, 8.0), (Wf - 9.0, Hf - 9.0)),
                        dtype=torch.float32)
    o = tile_origins(p, Hf, Wf)
    checks.append(subpix_case(
        dev, gather_tiles_plain(img, o, TILE_H, TILE), o, p,
        int(cfg.tracker.min_distance) // 2, cfg.tracker.subpix_iters,
        what=f" (a full frame's corners, N = {N})"))
    return checks
