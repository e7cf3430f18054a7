"""K1: whole-frame IMU propagation (K samples) in one launch.

Replaces rvio_tpu/ops/propagate_block.py (``propagate_block_pallas``,
``_propagate_kernel``); CUDA source ``csrc/propagate_block.cu``.  The plain
version is the sequential recursion of filter/propagation.
_propagate_sequential in the JAX package (reference: PreIntegrator.cc:
97-191), the fp-order oracle, with padded samples carrying dt = 0: after
the last sample with dt > 0 such a step is a bitwise identity on every
output (dR = I, f1..f4 = 0, Phi = I, Q = 0, and vk, gk already rotated);
as the first step it still sets vk = R0 vR and gk = normalize(R0 gR).

Inputs carry a leading stream axis B (B = 1 for one filter): w/a (B, K, 3),
dte (B, K), R0 (B, 3, 3), vR/gR/bg/ba (B, 3), P0 (B, 24, 24).  Returns
(Rk (B, 3, 3), pk (B, 3), vk (B, 3), P24 (B, 24, 24), Psi (B, 24, 24)).

Bound on the H100 at the operating point (B=1, K=16, f32): the call reads
2.8 KB and writes 4.7 KB (2.2 ns at 3.35 TB/s).  A sample with dt > 0
needs about 12.4 kFLOP: P <- Phi P Phi^T and Psi <- Phi Psi as products
with the 81 nonzeros of Phi (3 x 2 x 24 x 81 = 11.7 kFLOP), plus Q and the
3-vector state; a padded sample needs none (ops/checks.propagate_flops).
Ten samples, a 20 Hz frame at 200 Hz, are 0.12 MFLOP (1.9 ns at
67 TFLOP/s).  So it is bound by latency: the samples' dependent steps.
The design (csrc/propagate_block.cu) runs only up to the last sample with
dt != 0 (the trailing padding is a bitwise identity; the first step of a
frame is not, so at least one runs), computes the state recursion, which
does not depend on P, in one warp ahead of the covariance, and updates P
and Psi only in the nine rows (and columns) where Phi differs from the
identity, one block barrier a sample; one block of 224 threads per
stream.  It takes 1 <= K <= KMAX.  The TPU kernel's ones-matmul scalar
broadcasts and selection-matmul skew are not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from benchmark.reference.rvio_plain.core.so3 import delta_rot, skew, so3_integration_coeffs
from benchmark.reference.rvio_plain.ops import _lib

_LIB = "propagate_block"
_ARGS = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 2 + [ctypes.c_float] * 6
KMAX = 128     # samples a frame (the per-sample state is in shared memory)


def _sig(sigma_g, sigma_wg, sigma_a, sigma_wa):
    """The 12-dim IMU noise diagonal (PreIntegrator.cc:40-44), as floats."""
    return (float(sigma_g) ** 2, float(sigma_wg) ** 2,
            float(sigma_a) ** 2, float(sigma_wa) ** 2)


def propagate_block_plain(w, a, dte, R0, vR, gR, bg, ba, P0, *,
                          gravity: float, small_angle: float,
                          sigma_g: float, sigma_wg: float, sigma_a: float,
                          sigma_wa: float):
    """Plain version (see the module docstring for shapes)."""
    dtype, dev = P0.dtype, P0.device
    B, K = dte.shape
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(B, 3, 3)
    eye24 = torch.eye(24, dtype=dtype, device=dev).expand(B, 24, 24)
    sig = torch.cat([torch.full((3,), s, dtype=dtype, device=dev)
                     for s in _sig(sigma_g, sigma_wg, sigma_a, sigma_wa)])

    def mv(A, x):
        return (A @ x[..., None])[..., 0]

    Rk = R0
    dp = torch.zeros(B, 3, dtype=dtype, device=dev)
    dv = torch.zeros_like(dp)
    pk = torch.zeros_like(dp)
    vk, gk = vR, gR
    P = P0
    Psi = eye24
    Dt = torch.zeros(B, dtype=dtype, device=dev)
    for k in range(K):
        dt = dte[:, k]
        dt3 = dt[:, None, None]
        wk = w[:, k] - bg
        ak = a[:, k] - ba
        Dt = Dt + dt

        wx = skew(wk)
        wx2 = wx @ wx
        vx = skew(vk)
        Rk_T = Rk.transpose(-1, -2)

        # --- covariance (PreIntegrator.cc:122-142) ---
        F = torch.zeros(B, 24, 24, dtype=dtype, device=dev)
        F[:, 9:12, 9:12] = -wx
        F[:, 9:12, 18:21] = -eye3
        F[:, 12:15, 9:12] = -(Rk_T @ vx)
        F[:, 12:15, 15:18] = Rk_T
        F[:, 15:18, 6:9] = -gravity * Rk
        F[:, 15:18, 9:12] = -gravity * skew(gk)
        F[:, 15:18, 15:18] = -wx
        F[:, 15:18, 18:21] = -vx
        F[:, 15:18, 21:24] = -eye3
        Phi = eye24 + dt3 * F
        Psi = Phi @ Psi

        G = torch.zeros(B, 24, 12, dtype=dtype, device=dev)
        G[:, 9:12, 0:3] = -eye3
        G[:, 15:18, 0:3] = -vx
        G[:, 15:18, 6:9] = -eye3
        G[:, 18:21, 3:6] = eye3
        G[:, 21:24, 9:12] = eye3
        Q = (dt3 * (G * sig)) @ G.transpose(-1, -2)
        P = Phi @ P @ Phi.transpose(-1, -2) + Q

        # --- state (PreIntegrator.cc:144-178) ---
        dR = delta_rot(wk, dt, small_angle)
        Rk = dR @ Rk
        f1, f2, f3, f4 = (f[:, None, None] for f in so3_integration_coeffs(
            torch.linalg.vector_norm(wk, dim=-1), dt, small_angle))
        Rk_T = Rk.transpose(-1, -2)
        dp = dp + dv * dt[:, None] + mv(
            Rk_T @ ((0.5 * dt3 ** 2) * eye3 + f1 * wx + f2 * wx2), ak)
        dv = dv + mv(Rk_T @ (dt3 * eye3 + f3 * wx + f4 * wx2), ak)
        Dt1 = Dt[:, None]
        pk = vR * Dt1 - 0.5 * gravity * gR * Dt1 ** 2 + dp
        vk = mv(Rk, vR - gravity * gR * Dt1 + dv)
        gk = mv(Rk, gR)
        gk = gk / torch.linalg.vector_norm(gk, dim=-1, keepdim=True)
    return Rk, pk, vk, P, Psi


def propagate_block(w, a, dte, R0, vR, gR, bg, ba, P0, *,
                    gravity: float, small_angle: float, sigma_g: float,
                    sigma_wg: float, sigma_a: float, sigma_wa: float):
    """One frame's propagation for B streams (see the module docstring).

    A CUDA tensor runs the kernel (f32, 1 <= K <= KMAX); a CPU tensor the
    plain version."""
    kw = dict(gravity=gravity, small_angle=small_angle, sigma_g=sigma_g,
              sigma_wg=sigma_wg, sigma_a=sigma_a, sigma_wa=sigma_wa)
    if not _lib.uses_kernel(P0, "propagate_block"):
        return propagate_block_plain(w, a, dte, R0, vR, gR, bg, ba, P0, **kw)
    B, K = dte.shape
    dev = P0.device
    f32 = torch.float32
    name = "propagate_block"
    _lib.check(name, "w", w, (B, K, 3), f32, dev)
    _lib.check(name, "a", a, (B, K, 3), f32, dev)
    _lib.check(name, "dte", dte, (B, K), f32, dev)
    _lib.check(name, "R0", R0, (B, 3, 3), f32, dev)
    for arg, t in (("vR", vR), ("gR", gR), ("bg", bg), ("ba", ba)):
        _lib.check(name, arg, t, (B, 3), f32, dev)
    _lib.check(name, "P0", P0, (B, 24, 24), f32, dev)
    if not 1 <= K <= KMAX:
        raise ValueError(f"{name}: the CUDA kernel takes 1 <= K <= {KMAX} "
                         f"samples, got K = {K}")
    Rk = torch.empty(B, 3, 3, dtype=f32, device=dev)
    pk = torch.empty(B, 3, dtype=f32, device=dev)
    vk = torch.empty(B, 3, dtype=f32, device=dev)
    P = torch.empty(B, 24, 24, dtype=f32, device=dev)
    Psi = torch.empty(B, 24, 24, dtype=f32, device=dev)
    if B == 0:
        return Rk, pk, vk, P, Psi
    fn = _lib.function(_LIB, "rvio_propagate_block", _ARGS)
    _lib.call(_LIB, fn, *(_lib.ptr(t) for t in (
        w, a, dte, R0, vR, gR, bg, ba, P0, Rk, pk, vk, P, Psi)),
        B, K, float(gravity), float(small_angle),
        *_sig(sigma_g, sigma_wg, sigma_a, sigma_wa), device=dev)
    _lib.launched(propagate_block)
    return Rk, pk, vk, P, Psi


propagate_block.launches = 0
