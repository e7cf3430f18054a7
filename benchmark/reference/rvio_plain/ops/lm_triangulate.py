"""K2: batched inverse-depth LM triangulation of the update features.

Replaces rvio_tpu/ops/lm_triangulate.py (``lm_triangulate_pallas``,
``_lm_kernel``); CUDA source ``csrc/lm_triangulate.cu``.  The plain version
is filter/update._lm_triangulate of the JAX package with the feature axis
as a batch dimension (reference: Updater.cc:144-263): fixed 10 iterations,
masked up/down lambda schedule, closed-form adjugate 3x3 solve.

Bound on the H100 at the operating point (F=100, L=15, 10 iterations,
f32): the call reads z, Rc, tc and track_len once (F*L*14*4 + F*4 B =
84 KB, 0.025 us at 3.35 TB/s) and does at most 2.3 MFLOP (every feature
at full length for all 10 iterations; 0.034 us at 67 TFLOP/s; ops/checks.py
counts the iterations its inputs need): both far below a kernel launch, so
it is bound by latency, the serial chain of 10 dependent iterations, each a
sum over the measurements.  The design (csrc/lm_triangulate.cu) gives each
feature a warp: a lane holds a measurement in registers, the ten sums of an
iteration go through a shuffle butterfly that leaves every lane with the
same bits, and every lane then solves the same 3x3 system; four features a
block, so the batch spreads over many SMs.  The sums run in a tree, not in
measurement order, so the kernel agrees with the plain version to rounding
(ops/checks.py).  The TPU kernel's 128-lane packing is not carried over,
and the angles are seeded in the kernel (CUDA has atan2f).
"""

from __future__ import annotations

import ctypes

import torch

from benchmark.reference.rvio_plain.ops import _lib

_LIB = "lm_triangulate"
_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float]

EPS_DEPTH = 1e-12          # guard for divisions by h_z
ANGLE_BOUND = 0.5 * 3.14   # reference's validity bound on phi/psi (Updater.cc:154)


def unit_from_angles(phi, psi):
    """epfinv = [cos(phi)sin(psi), sin(phi), cos(phi)cos(psi)] (Updater.cc:165)."""
    return torch.stack([torch.cos(phi) * torch.sin(psi), torch.sin(phi),
                        torch.cos(phi) * torch.cos(psi)], dim=-1)


def jang(phi, psi):
    """d epfinv / d [phi, psi] (reference: Updater.cc:168-171)."""
    return torch.stack([
        torch.stack([-torch.sin(phi) * torch.sin(psi),
                     torch.cos(phi) * torch.cos(psi)], -1),
        torch.stack([torch.cos(phi), torch.zeros_like(phi)], -1),
        torch.stack([-torch.sin(phi) * torch.cos(psi),
                     -torch.cos(phi) * torch.sin(psi)], -1),
    ], dim=-2)


def safe_z(h, eps: float = EPS_DEPTH):
    """Clamp |h_z| away from zero so projections never divide by 0."""
    z = h[..., 2]
    clamped = torch.where(z < 0, torch.full_like(z, -eps),
                          torch.full_like(z, eps))
    return torch.where(torch.abs(z) < eps, clamped, z)


def hproj(h, eps: float = EPS_DEPTH):
    """2x3 perspective Jacobian [[1/z,0,-x/z^2],[0,1/z,-y/z^2]] (Updater.cc:191)."""
    zi = 1.0 / safe_z(h, eps)
    zero = torch.zeros_like(zi)
    row0 = torch.stack([zi, zero, -h[..., 0] * zi * zi], dim=-1)
    row1 = torch.stack([zero, zi, -h[..., 1] * zi * zi], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def project(h, eps: float = EPS_DEPTH):
    return h[..., :2] / safe_z(h, eps)[..., None]


def chain_point(R, e, rho, t):
    """h = R e + rho t per chain entry, summed left to right (the order of
    the kernels): R (F, L, 3, 3), e (F, 3), rho (F,), t (F, L, 3)."""
    e = e[:, None, None, :]
    return (R[..., 0] * e[..., 0] + R[..., 1] * e[..., 1]
            + R[..., 2] * e[..., 2] + rho[:, None, None] * t)


def _solve3(A, b):
    """Closed-form 3x3 solve (adjugate), batched over leading axes."""
    def a(i, j):
        return A[..., i, j]

    c00 = a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1)
    c01 = a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2)
    c02 = a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0)
    det = a(0, 0) * c00 + a(0, 1) * c01 + a(0, 2) * c02
    dets = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    x0 = (c00 * b[..., 0]
          + (a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2)) * b[..., 1]
          + (a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1)) * b[..., 2]) / dets
    x1 = (c01 * b[..., 0]
          + (a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0)) * b[..., 1]
          + (a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2)) * b[..., 2]) / dets
    x2 = (c02 * b[..., 0]
          + (a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1)) * b[..., 1]
          + (a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)) * b[..., 2]) / dets
    return torch.stack([x0, x1, x2], dim=-1)


def lm_triangulate_plain(z, Rc, tc, track_len, *, sigma_im: float,
                         iters: int = 10):
    """Plain version.  z (F, L, 2); Rc (F, L, 3, 3) / tc (F, L, 3) the
    camera-frame chain with entry 0 identity; track_len (F,).  Returns
    (phi, psi, rho, ok), each (F,)."""
    return _lm(z, Rc, tc, track_len, sigma_im, iters)[:4]


def lm_iterations(z, Rc, tc, track_len, *, sigma_im: float, iters: int = 10):
    """Iterations each feature runs before it converges (``iters`` where it
    never does): what these inputs need of the loop, (F,) int64."""
    return _lm(z, Rc, tc, track_len, sigma_im, iters)[4]


def _lm(z, Rc, tc, track_len, sigma_im, iters):
    F, L, _ = z.shape
    z0 = z[:, 0]
    phi = torch.atan2(z0[:, 1], torch.sqrt(z0[:, 0] ** 2 + 1.0))
    psi = torch.atan2(z0[:, 0], torch.ones_like(z0[:, 0]))
    ok0 = (torch.abs(phi) <= ANGLE_BOUND) & (torch.abs(psi) <= ANGLE_BOUND)

    rinv = 1.0 / sigma_im ** 2
    mmask = torch.arange(L, device=z.device)[None, :] < track_len[:, None]
    first = torch.arange(L, device=z.device) == 0

    def cost_and_normal(phi, psi, rho):
        epf = unit_from_angles(phi, psi)                       # (F, 3)
        Ja = jang(phi, psi)                                    # (F, 3, 2)
        h = chain_point(Rc, epf, rho, tc)
        e = z - project(h)                                     # (F, L, 2)
        Hp = hproj(h)                                          # (F, L, 2, 3)
        HJ = torch.einsum("flab,flbc,fcd->flad", Hp, Rc, Ja)   # (F, L, 2, 2)
        Ht = torch.einsum("flab,flb->fla", Hp, tc)             # d/d rho
        # First measurement: d/d rho is exactly zero (Updater.cc:195).
        Ht = torch.where(first[None, :, None], torch.zeros_like(Ht), Ht)
        H = torch.cat([HJ, Ht[..., None]], dim=-1)             # (F, L, 2, 3)
        e_m = torch.where(mmask[..., None], e, torch.zeros_like(e))
        H_m = torch.where(mmask[..., None, None], H, torch.zeros_like(H))
        cost = rinv * torch.sum(e_m * e_m, dim=(1, 2))
        HTH = rinv * torch.einsum("flab,flac->fbc", H_m, H_m)
        HTe = rinv * torch.einsum("flab,fla->fb", H_m, e_m)
        return cost, HTH, HTe

    rho = torch.zeros_like(phi)
    lam = torch.full_like(phi, 0.01)
    last = torch.full_like(phi, float("inf"))
    done = torch.zeros_like(ok0)
    n_iter = torch.zeros(F, dtype=torch.int64, device=z.device)
    for _ in range(iters):
        n_iter = n_iter + (~done).long()
        cost, HTH, HTe = cost_and_normal(phi, psi, rho)
        down = cost <= last
        A = HTH + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(HTH, dim1=-2, dim2=-1))
        dp = _solve3(A, HTe)
        dp = torch.where(torch.isfinite(dp), dp, torch.zeros_like(dp))
        take = down & ~done
        phi = torch.where(take, phi + dp[:, 0], phi)
        psi = torch.where(take, psi + dp[:, 1], psi)
        rho = torch.where(take, rho + dp[:, 2], rho)
        conv = (torch.abs(last - cost) < 1e-6) & (dp[:, 2] < 1e-6)
        lam = torch.where(done, lam, torch.where(down, lam * 0.1, lam * 10.0))
        last = torch.where(done, last, cost)
        done = done | (take & conv)

    ok = (ok0 & (torch.abs(phi) <= ANGLE_BOUND) & (torch.abs(psi) <= ANGLE_BOUND)
          & torch.isfinite(rho) & (rho >= 0)
          & torch.isfinite(phi) & torch.isfinite(psi))
    return phi, psi, rho, ok, n_iter


def lm_triangulate(z, Rc, tc, track_len, *, sigma_im: float, iters: int = 10):
    """Batched LM refinement (see :func:`lm_triangulate_plain`).

    A CUDA tensor runs the kernel (f32 only); a CPU tensor the plain
    version."""
    if not _lib.uses_kernel(z, "lm_triangulate"):
        return lm_triangulate_plain(z, Rc, tc, track_len, sigma_im=sigma_im,
                                    iters=iters)
    F, L, _ = z.shape
    dev = z.device
    f32 = torch.float32
    tl = track_len.to(torch.int32)
    _lib.check("lm_triangulate", "z", z, (F, L, 2), f32, dev)
    _lib.check("lm_triangulate", "Rc", Rc, (F, L, 3, 3), f32, dev)
    _lib.check("lm_triangulate", "tc", tc, (F, L, 3), f32, dev)
    _lib.check("lm_triangulate", "track_len", tl, (F,), torch.int32, dev)
    phi = torch.empty(F, dtype=f32, device=dev)
    psi = torch.empty(F, dtype=f32, device=dev)
    rho = torch.empty(F, dtype=f32, device=dev)
    ok = torch.empty(F, dtype=torch.bool, device=dev)
    fn = _lib.function(_LIB, "rvio_lm_triangulate", _ARGS)
    _lib.call(_LIB, fn, _lib.ptr(z), _lib.ptr(Rc), _lib.ptr(tc), _lib.ptr(tl),
              _lib.ptr(phi), _lib.ptr(psi), _lib.ptr(rho), _lib.ptr(ok),
              F, L, iters, 1.0 / sigma_im ** 2, device=dev)
    _lib.launched(lm_triangulate)
    return phi, psi, rho, ok


lm_triangulate.launches = 0
