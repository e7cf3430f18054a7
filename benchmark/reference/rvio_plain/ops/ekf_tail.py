"""K5: the MSCKF update's dense tail (compression + EKF core) in one launch.

Replaces rvio_tpu/ops/ekf_tail.py (``ekf_tail_pallas``,
``_ekf_tail_kernel``); CUDA source ``csrc/ekf_tail.cu``.  After the masked
row stack Hw, ro of the accepted features, with C = Hw^T Hw and
b = Hw^T ro formed outside (as the JAX package forms them outside its
kernel), the tail is: the lower Cholesky factor Lc of C plus a ridge,
rn = Lc^-1 b and Hn = [0 | Lc^T] (Updater.cc:460-536); S = Hn P Hn^T +
sig2 I, K = P Hn^T S^-1, dx = K rn and the Joseph-form
P_new = (I - K Hn) P (I - K Hn)^T + sig2 K K^T (Updater.cc:538-619).

Inputs carry a leading batch axis B (B = 1 for one filter, one system a
segment in the segment-batched filter): C (B, n, n),
b (B, n), P (B, D, D) with D = 24 + n, sig2 (B,).  Returns (dx (B, D),
P_new (B, D, D), fallback (B,) bool).  ``fallback`` says that the factor
took the wider ridge (see :func:`info_cholesky`).

The function is the port's unfused Cholesky chain, :func:`cholesky_tail`;
the plain version runs it once per batch entry.  The filter's Cholesky
branch calls :func:`ekf_tail` at every window, so the tensor's device
picks the kernel or the chain (``tpu.ekf_tail_fused`` selects nothing).
The JAX package launches its kernel only on a TPU in f32; elsewhere its
flag runs the same unfused chain, which is therefore the reference.

Bound on the H100 at the operating point (B = 1, n = 84, D = 108, f32): the
call moves about 85 KB and needs about 8 MFLOP (ops/checks.ekf_tail_flops),
0.03 us and 0.12 us at the card's peaks, far below the latency of its two
84-step factorizations and two 84-step triangular solves.  The kernel
(csrc/ekf_tail.cu) runs a cluster of 8 CTAs per system: its inputs arrive
by multicast bulk copies, both factorizations run blocked (8-column
panels) and redundantly in every CTA, and the columns of the gain, the
solves and the rows of the Joseph form are split over the CTAs, which
exchange S, K^T and E^T through distributed shared memory.  That holds
n <= NMAX = 92 (windows of up to 15 clones) in a CTA's shared memory; a
larger n takes the wide route (csrc/ekf_tail_wide.cu): eight launches in
stream order with their intermediates in a device workspace this wrapper
allocates a call.  The two factorizations (C's with b^T riding below it
as one more row, which gives rn) run in a cluster of 8 CTAs a system with
the working matrix in distributed shared memory and panels of 32
columns; the two triangular solves of the gain are grids of row blocks
over the card, dx = K rn with them; the products (P Hn^T, S, I - K Hn,
(I - K Hn) P, and the Joseph form with its symmetrized store) are grids
of 32 x 32 tiles over the card.  Both routes take the chain's order of
operations (S symmetrized before its factorization, I - K Hn formed
before it multiplies P, X = ((I - K Hn) P) (I - K Hn)^T + sig2 K K^T) and
give the plain version's function to rounding: their sums run in other
orders.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from benchmark.reference.rvio_plain.ops import _lib

_LIB = "ekf_tail"
_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
_WIDE_LIB = "ekf_tail_wide"
_WIDE_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
_wide_ws: dict = {}       # n -> floats of workspace a system

# The JAX package's ridge on the information matrix, relative to its trace
# (rvio_tpu/filter/update.py:738).
INFO_RIDGE = 1e-8
# error-state entries before the clone block
NX = 24
# the largest n whose intermediates fit in one CTA's shared memory on the
# H100 (227 KB; csrc/ekf_tail.cu smem_floats and NMAX): the narrow kernel's
# range; larger n run the wide route
NMAX = 92


def info_cholesky(C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower Cholesky factor of the information matrix C (..., n, n) plus a
    ridge, and whether the wider ridge was needed (a bool tensor of C's
    leading shape).

    The ridge is the JAX package's 1e-8 * max(trace C, 1), and the factor
    is the JAX function's wherever that factorization succeeds.  Only where
    it fails does the factor take n eps * max(trace C, 1): in f32 a C of
    low rank (three accepted features) can lose more than 1e-8 of its trace
    to rounding, so a pivot turns negative and the JAX function's update is
    NaN.  Both factorizations run and ``torch.where`` picks, so nothing is
    read back; in f64 (n eps about 2e-14) the second one never runs.  A
    factor that fails both ways is NaN, as in the JAX package."""
    n = C.shape[-1]
    eye = torch.eye(n, dtype=C.dtype, device=C.device)
    # torch.trace's sum for one matrix (the plain version's bits)
    trace = (torch.trace(C) if C.dim() == 2
             else torch.diagonal(C, dim1=-2, dim2=-1).sum(-1))
    scale = torch.clamp(trace, min=1.0)[..., None, None]
    L, info = torch.linalg.cholesky_ex(C + (INFO_RIDGE * scale) * eye)
    fallback = info != 0
    wide = n * torch.finfo(C.dtype).eps
    if wide > INFO_RIDGE:
        L2, info2 = torch.linalg.cholesky_ex(C + (wide * scale) * eye)
        L = torch.where(fallback[..., None, None], L2, L)
        info = torch.where(fallback, info2, info)
    L = torch.where((info == 0)[..., None, None], L,
                    torch.full_like(L, float("nan")))
    return L, fallback


def nan_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, all-NaN where the factorization fails (the
    JAX package's semantics; torch.linalg.cholesky would raise, and on CUDA
    read the status back to the host)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def cholesky_solve(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 X for a lower factor L (..., k, k) and X (..., k, m) by
    two triangular solves (cuBLAS trsm on the card), the two steps of
    LAPACK's potrs.  ``torch.cholesky_solve`` does not serve the filter:
    on a batched CUDA tensor it goes to MAGMA, which cannot be captured
    into a CUDA graph (the graphed frame aborts)."""
    Y = torch.linalg.solve_triangular(L, X, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)


def ekf_correction(P: torch.Tensor, Hn_cl: torch.Tensor, rn: torch.Tensor,
                   sig2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The EKF core for a compressed system (Updater.cc:538-619): the
    correction dx and the symmetrized Joseph-form covariance, given the
    clone-block rows Hn_cl (..., k, D - 24), rn (..., k) and the variance
    sig2 (a scalar or (...)), for any leading axes (one system, or one a
    segment)."""
    dtype, dev = P.dtype, P.device
    D = P.shape[-1]
    k = Hn_cl.shape[-2]
    sig2 = torch.as_tensor(sig2, dtype=dtype, device=dev)[..., None, None]
    Hn = torch.cat([torch.zeros(Hn_cl.shape[:-1] + (NX,), dtype=dtype,
                                device=dev), Hn_cl], dim=-1)   # (..., k, D)
    HnT = Hn.transpose(-1, -2)
    PHt = P @ HnT                                              # (..., D, k)
    S = Hn @ PHt + sig2 * torch.eye(k, dtype=dtype, device=dev)
    S = 0.5 * (S + S.transpose(-1, -2))
    K = cholesky_solve(nan_cholesky(S), PHt.transpose(-1, -2)
                       ).transpose(-1, -2)                     # (..., D, k)
    dx = (K @ rn[..., None])[..., 0]
    I_KH = torch.eye(D, dtype=dtype, device=dev) - K @ Hn
    P_new = (I_KH @ P @ I_KH.transpose(-1, -2)
             + sig2 * (K @ K.transpose(-1, -2)))
    return dx, 0.5 * (P_new + P_new.transpose(-1, -2))


def cholesky_tail(C: torch.Tensor, b: torch.Tensor, P: torch.Tensor, sig2
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unfused chain: information-form compression (C = Lc Lc^T,
    Hn = Lc^T, rn = Lc^-1 b) and the EKF core, for one system (C (n, n),
    b (n,), P (D, D), sig2 a scalar) or a batch of them (leading axes on
    every input).  Returns (dx (..., D), P_new (..., D, D), fallback, a
    bool of the leading shape).  Every call in it can be captured into a
    CUDA graph (scripts/capture_probe.py); it is what the plain version
    and the CPU path run, and the library yardstick of K5 on the card."""
    Lc, fallback = info_cholesky(C)
    rn = torch.linalg.solve_triangular(Lc, b[..., None], upper=False)[..., 0]
    dx, P_new = ekf_correction(P, Lc.transpose(-1, -2), rn, sig2)
    return dx, P_new, fallback


def ekf_tail_plain(C, b, P, sig2):
    """Plain version: :func:`cholesky_tail` for each batch entry."""
    outs = [cholesky_tail(C[i], b[i], P[i], sig2[i]) for i in range(C.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def ekf_tail(C: torch.Tensor, b: torch.Tensor, P: torch.Tensor,
             sig2: torch.Tensor):
    """(dx, P_new, fallback) for B systems (see the module docstring).

    A CUDA tensor runs the kernel (f32 only, any n >= 1: the narrow kernel
    up to NMAX, the wide route above it, with its workspace allocated here
    on the current stream, so a CUDA graph captures it from its pool); a
    CPU tensor the plain version."""
    if not _lib.uses_kernel(C, "ekf_tail"):
        return ekf_tail_plain(C, b, P, sig2)
    B, n = C.shape[0], C.shape[-1]
    if n < 1:
        raise ValueError(f"ekf_tail: n = {n} (6 x the window's clones); the "
                         f"kernel takes n >= 1")
    D = NX + n
    dev = C.device
    f32 = torch.float32
    name = "ekf_tail"
    _lib.check(name, "C", C, (B, n, n), f32, dev)
    _lib.check(name, "b", b, (B, n), f32, dev)
    _lib.check(name, "P", P, (B, D, D), f32, dev)
    _lib.check(name, "sig2", sig2, (B,), f32, dev)
    dx = torch.empty(B, D, dtype=f32, device=dev)
    P_new = torch.empty(B, D, D, dtype=f32, device=dev)
    fallback = torch.empty(B, dtype=torch.bool, device=dev)
    outs = (C, b, P, sig2, dx, P_new, fallback)
    if n <= NMAX:
        fn = _lib.function(_LIB, "rvio_ekf_tail", _ARGS)
        _lib.call(_LIB, fn, *map(_lib.ptr, outs), B, n, device=dev)
    else:
        ws = torch.empty(B * wide_workspace_floats(n), dtype=f32, device=dev)
        fn = _lib.function(_WIDE_LIB, "rvio_ekf_tail_wide", _WIDE_ARGS)
        _lib.call(_WIDE_LIB, fn, *map(_lib.ptr, outs + (ws,)), B, n,
                  device=dev)
    _lib.launched(ekf_tail)
    return dx, P_new, fallback


ekf_tail.launches = 0


def wide_workspace_floats(n: int) -> int:
    """Floats of device workspace a system needs in the wide route (which
    ``ekf_tail`` takes past NMAX; the route takes any n >= 1), from
    csrc/ekf_tail_wide.cu's ``Layout`` (Lc with rn^T
    below it, S and Ls, each padded to a multiple of 32; P Hn^T, K and
    I - K Hn's live columns; (I - K Hn) P; the panel where the
    factorization spills, past n = 512, the solves' rows where they spill,
    past about n = 2600, and two flags: about 5 MB at n = 384).  Launches
    nothing."""
    if n not in _wide_ws:
        fn = _lib.function(_WIDE_LIB, "rvio_ekf_tail_wide_workspace",
                           [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int])
        out = ctypes.c_longlong(0)
        err = fn(ctypes.byref(out), n, None)
        if err:
            raise ValueError(f"ekf_tail: no wide route for n = {n}")
        _wide_ws[n] = out.value
    return _wide_ws[n]


def max_active_clusters(B: int, n: int, device) -> int:
    """How many of K5's clusters (one a system) the CUDA ``device`` holds
    at once at size ``n`` (``cudaOccupancyMaxActiveClusters``, of the
    narrow kernel or the wide route): B systems above it run in more than
    one wave.  Launches nothing."""
    lib, sym = ((_LIB, "rvio_ekf_tail_max_clusters") if n <= NMAX else
                (_WIDE_LIB, "rvio_ekf_tail_wide_max_clusters"))
    fn = _lib.function(lib, sym,
                       [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 2)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        _lib.call(lib, fn, ctypes.byref(out), B, n,
                  device=torch.device(device))
    return out.value
