"""K3: per-feature residual, Jacobians and Householder nullspace projection.

Replaces rvio_tpu/ops/jac_project.py (``jac_project_pallas``,
``_jac_project_kernel``); CUDA source ``csrc/jac_project.cu``.  The plain
version is filter/update._build_jacobians + _householder_project of the JAX
package (reference: Updater.cc:278-402) with the feature axis as a batch
dimension, plus the integration masks of msckf_update.

Unlike the TPU kernel, the outputs are final: rows in the oracle's
(2l + a) order and Hx in absolute clone columns (chain column jj lands in
clone c0 + jj), with the rank check (Ncols = 2 when ||Hf[:, rho]|| < 1e-4,
else 3) and the residual mask (rows >= Ncols and < 2 t_eff) applied.  The
TPU's block-row order, static row permutation and one-hot column shift do
not exist here.

Bound on the H100 at the operating point (F=100, L=15, M=14, f32): the
call reads 7 chains, z and 5 per-feature scalars (F*L*47*4 + F*20 B =
284 KB) and writes r, Hx and hfn (F*2L*(6M+1)*4 + F*4 B = 1.02 MB), 1.3 MB
in all, 0.39 us at 3.35 TB/s; its arithmetic (at most 4.1 MFLOP, every
feature at full length, dominated by the 3 reflections over the 30 x 88
system; ops/checks.jac_project_flops) is 0.06 us at 67 TFLOP/s.  It is
latency-bound: three dependent reflections a feature.  The kernel uses
that the reflectors depend on Hf (2L x 3) alone: one warp a feature
holds Hf and r with a measurement a lane and forms the reflectors by
warp sums, while 96 lanes each own an output column of Hx, which they
build in registers from the left factors, reflect and store at its
absolute clone column; one barrier a feature.  The row count is a
compile-time bound (32 rows for L <= 16, 128 for L <= 64).  A longer
window (L > 16 under the dispatch) runs the wide kernel: compact-WY
reflection (Q = I - V T V^T, T from the betas and V^T V) over a grid of
features x column tiles, each tile forming the reflectors again and four
lanes a pair of output columns, each entry formed in registers twice
(once for V^T c, once for the store) and stored once; a feature with
fewer than two measurements only stores zeros.  On the card (NVIDIA H100
80GB HBM3, 700 W; chip_smoke.py, F = 100 lanes of a recorded update): 11.2
us a launch at L = 65, where the design before it took 73.3, and 6.1,
5.7 and 6.7 us at L = 17, 20 and 33 against the 128-row instance's 12.5,
10.8 and 13.0 on the same inputs.  Any L >= 2 is taken; ``route`` asks
for one kernel (tests, chip_smoke.py's timings).

Depth guard: the kernel clamps |h_z| at ``KERNEL_EPS`` = 1e-6 (as the TPU
kernel does: f32 reflector norms square the perspective rows, and 1e-12
would overflow them).  The plain version takes the guard as ``eps``; the
wrapper passes it 1e-6 in f32 and the f64 oracle's 1e-12 in f64.
"""

from __future__ import annotations

import ctypes

import torch

from benchmark.reference.rvio_plain.core.so3 import skew
from benchmark.reference.rvio_plain.ops import _lib
from benchmark.reference.rvio_plain.ops.lm_triangulate import (EPS_DEPTH, chain_point, hproj,
                                               jang, project, unit_from_angles)

_LIB = "jac_project"
# rvio_jac_project_route: 17 arrays, F, L, M, eps, the route
_ARGS = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 3 + [ctypes.c_float]
         + [ctypes.c_int])
# "narrow": the compiled row bounds (L <= ROW_BOUND_MAX_L); "wide": the
# wide kernel (any L)
ROUTES = {"narrow": 0, "wide": 1}
ROW_BOUND_MAX_L = 64
# the longest window the dispatch gives the narrow kernel; past it the
# wide one (chip_smoke.py times both at L = 17, 20, 33)
NARROW_MAX_L = 16

KERNEL_EPS = 1e-6


def jac_project_plain(z, Rc_lin, tc_lin, Rrel_lin, trel_lin, Rc_res, tc_res,
                      phi, psi, rho, t_eff, c0, R_bc, t_bc, M: int,
                      eps: float = EPS_DEPTH):
    """Plain version; see :func:`jac_project` for the arguments."""
    F, L, _ = z.shape
    J = L - 1
    dev = z.device
    dtype = z.dtype
    epf = unit_from_angles(phi, psi)                           # (F, 3)
    Ja = jang(phi, psi)                                        # (F, 3, 2)
    R_cb = R_bc.T
    rho3 = rho[:, None, None]

    h_res = chain_point(Rc_res, epf, rho, tc_res)
    e = z - project(h_res, eps)                                # (F, L, 2)
    h = chain_point(Rc_lin, epf, rho, tc_lin)
    Hp = hproj(h, eps)                                         # (F, L, 2, 3)

    rmask = torch.arange(L, device=dev)[None, :] < t_eff[:, None]  # (F, L)
    r = torch.where(rmask[..., None], e, torch.zeros_like(e)).reshape(F, 2 * L)

    # Hf rows: [Hproj Rc Jang | Hproj tc]; first row pair has rho-col = 0.
    HJ = torch.einsum("flab,flbc,fcd->flad", Hp, Rc_lin, Ja)
    Ht = torch.einsum("flab,flb->fla", Hp, tc_lin)
    first = torch.arange(L, device=dev) == 0
    Ht = torch.where(first[None, :, None], torch.zeros_like(Ht), Ht)
    Hf = torch.cat([HJ, Ht[..., None]], dim=-1)                # (F, L, 2, 3)
    Hf = torch.where(rmask[..., None, None], Hf, torch.zeros_like(Hf))
    Hf = Hf.reshape(F, 2 * L, 3)

    # Hx blocks: measurement i (>= 1), chain column j in [0, i-1]
    # (reference: Updater.cc:341-362), with R_{-1} := I:
    #   dpx_j = skew(R_bc epf + rho t_bc + rho Rrel_j^T trel_j)
    #   subH_j = [dpx_j Rrel_j^T | -rho Rprev_j^T],  Rprev_j = Rrel_{j-1}
    #   block(i, j) = Hproj_i R_cb Rrel_i subH_j
    Rj = Rrel_lin[:, 1:]                                       # (F, J, 3, 3)
    tj = trel_lin[:, 1:]
    Rprev = Rrel_lin[:, :-1]
    pb = epf @ R_bc.T + rho[:, None] * t_bc                    # (F, 3)
    dpx = skew(pb[:, None] + rho3 * torch.einsum("fjki,fjk->fji", Rj, tj))
    subL = torch.einsum("fjab,fjcb->fjac", dpx, Rj)
    subR = -rho[:, None, None, None] * Rprev.transpose(-1, -2)
    subH = torch.cat([subL, subR], dim=-1)                     # (F, J, 3, 6)
    left = torch.einsum("flab,bc,flcd->flad", Hp[:, 1:], R_cb, Rj)  # (F, J, 2, 3)
    blocks = torch.einsum("fiad,fjdb->fijab", left, subH)      # (F, J, J, 2, 6)
    i_idx = torch.arange(1, L, device=dev)[:, None]
    j_idx = torch.arange(J, device=dev)[None, :]
    bmask = (j_idx < i_idx)[None] & (i_idx[None] < t_eff[:, None, None])
    blocks = torch.where(bmask[..., None, None], blocks, torch.zeros_like(blocks))
    Hx = blocks.permute(0, 1, 3, 2, 4).reshape(F, 2 * J, 6 * J)
    Hx = torch.cat([torch.zeros(F, 2, 6 * J, dtype=dtype, device=dev), Hx], dim=1)

    # three Householder reflections on [Hf | Hx | r] (Updater.cc:381-402)
    A = torch.cat([Hf, Hx, r[..., None]], dim=-1)              # (F, 2L, nc)
    hfn = torch.linalg.vector_norm(Hf[:, :, 2], dim=-1)
    rows = torch.arange(2 * L, device=dev)
    for k in range(3):
        x = torch.where(rows >= k, A[:, :, k], torch.zeros_like(A[:, :, k]))
        normx = torch.linalg.vector_norm(x, dim=-1)
        alpha = torch.where(x[:, k] >= 0, -normx, normx)
        v = torch.where(rows == k, x - alpha[:, None], x)
        vnorm2 = torch.sum(v * v, dim=-1)
        safe = vnorm2 > 1e-30
        beta = torch.where(safe, 2.0 / torch.where(safe, vnorm2,
                                                   torch.ones_like(vnorm2)),
                           torch.zeros_like(vnorm2))
        vA = torch.einsum("fr,frc->fc", v, A)
        A = A - beta[:, None, None] * (v[:, :, None] * vA[:, None, :])

    # integration masks and absolute clone columns
    ncols = torch.where(hfn < 1e-4, 2, 3)
    keep = (rows[None, :] >= ncols[:, None]) & (rows[None, :] < 2 * t_eff[:, None])
    r_p = torch.where(keep, A[:, :, -1], torch.zeros_like(A[:, :, -1]))
    jj = torch.arange(M, device=dev)[None, :] - c0[:, None]   # (F, M)
    col_ok = (jj >= 0) & (jj < J)
    Hr = A[:, :, 3:3 + 6 * J].reshape(F, 2 * L, J, 6)
    idx = jj.clamp(0, J - 1)[:, None, :, None].expand(F, 2 * L, M, 6)
    Hx_p = torch.gather(Hr, 2, idx)
    Hx_p = torch.where(keep[:, :, None, None] & col_ok[:, None, :, None],
                       Hx_p, torch.zeros_like(Hx_p)).reshape(F, 2 * L, 6 * M)
    return r_p, Hx_p, hfn


def depth_guard(dtype: torch.dtype) -> float:
    """The depth guard of a computation in ``dtype``: the kernel's in f32
    (on either device, so the CPU path differs from the card's only in
    summation order), the oracle's in f64."""
    return KERNEL_EPS if dtype == torch.float32 else EPS_DEPTH


def kernel_route(L: int) -> str:
    """The kernel the dispatch gives length L: "narrow" (the compiled row
    bounds) up to NARROW_MAX_L, "wide" past it."""
    return "narrow" if L <= NARROW_MAX_L else "wide"


def jac_project(z, Rc_lin, tc_lin, Rrel_lin, trel_lin, Rc_res, tc_res,
                phi, psi, rho, t_eff, c0, R_bc, t_bc, M: int, *,
                route: str = "auto"):
    """Projected residual and clone Jacobian of every update feature.

    z (F, L, 2); the linearization chains ``*_lin`` (camera Rc/tc and
    relative Rrel/trel, (F, L, 3, 3)/(F, L, 3)) and the current-estimate
    camera chain ``*_res`` used for the residual; phi/psi/rho (F,) from
    triangulation; t_eff (F,) measurements used; c0 (F,) first clone of
    the feature's chain; R_bc (3, 3) / t_bc (3,) the extrinsics; M the
    clone window.  The depth guard is :func:`depth_guard` of z's dtype.

    Returns (r (F, 2L), Hx (F, 2L, 6M), hfn (F,)) with the masks of the
    module docstring applied.  A CUDA tensor runs the kernel (f32 only;
    ``route`` "narrow" (L <= 64) or "wide" asks for one kernel, "auto"
    takes :func:`kernel_route` of L); a CPU tensor the plain version.
    """
    if not _lib.uses_kernel(z, "jac_project"):
        return jac_project_plain(z, Rc_lin, tc_lin, Rrel_lin, trel_lin,
                                 Rc_res, tc_res, phi, psi, rho, t_eff, c0,
                                 R_bc, t_bc, M, depth_guard(z.dtype))
    F, L, _ = z.shape
    dev = z.device
    f32 = torch.float32
    te = t_eff.to(torch.int64)
    c0i = c0.to(torch.int64)
    name = "jac_project"
    _lib.check(name, "z", z, (F, L, 2), f32, dev)
    for arg, t in (("Rc_lin", Rc_lin), ("Rrel_lin", Rrel_lin),
                   ("Rc_res", Rc_res)):
        _lib.check(name, arg, t, (F, L, 3, 3), f32, dev)
    for arg, t in (("tc_lin", tc_lin), ("trel_lin", trel_lin),
                   ("tc_res", tc_res)):
        _lib.check(name, arg, t, (F, L, 3), f32, dev)
    for arg, t in (("phi", phi), ("psi", psi), ("rho", rho)):
        _lib.check(name, arg, t, (F,), f32, dev)
    _lib.check(name, "t_eff", te, (F,), torch.int64, dev)
    _lib.check(name, "c0", c0i, (F,), torch.int64, dev)
    _lib.check(name, "R_bc", R_bc, (3, 3), f32, dev)
    _lib.check(name, "t_bc", t_bc, (3,), f32, dev)
    if L < 2:
        raise ValueError(f"{name}: the kernel takes L >= 2, got {L}")
    if route == "auto":
        route = kernel_route(L)
    if route not in ROUTES or (route == "narrow" and L > ROW_BOUND_MAX_L):
        raise ValueError(f"{name}: no route {route!r} at L = {L}")
    r = torch.empty(F, 2 * L, dtype=f32, device=dev)
    Hx = torch.empty(F, 2 * L, 6 * M, dtype=f32, device=dev)
    hfn = torch.empty(F, dtype=f32, device=dev)
    if F == 0:                  # nothing to launch
        return r, Hx, hfn
    fn = _lib.function(_LIB, "rvio_jac_project_route", _ARGS)
    _lib.call(_LIB, fn, *(_lib.ptr(t) for t in (
        z, Rc_lin, tc_lin, Rrel_lin, trel_lin, Rc_res, tc_res, phi, psi, rho,
        te, c0i, R_bc, t_bc, r, Hx, hfn)), F, L, M, KERNEL_EPS,
        ROUTES[route], device=dev)
    _lib.launched(jac_project)
    return r, Hx, hfn


jac_project.launches = 0
