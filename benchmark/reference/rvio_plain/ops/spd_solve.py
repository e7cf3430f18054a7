"""K4: batched SPD quadratic form D = r^T S^-1 r (the chi2 gate's distance).

Replaces rvio_tpu/ops/spd_solve.py (``batched_quadform_pallas``,
``_quadform_kernel``); CUDA source ``csrc/spd_solve.cu``.

Bound on the H100 at the operating point (F=100, m=2L=30, f32): the call
reads the lower triangle of S and r once and writes D (198 KB, 0.059 us at
3.35 TB/s) and does about F*(m^3/3 + m^2) = 1 MFLOP (0.015 us at
67 TFLOP/s): both are far below a kernel launch, so it is bound by the
latency of the m dependent Cholesky steps.  The design gives each feature
one warp with S in registers (lane i holds row i of the lower triangle,
and row i + 32 for m > 32): a step is one rsqrtf, a few shuffles and the
column's broadcast from a per-warp buffer, with no division and no block
barrier; four features a block.  That takes m < 64; a longer window
(m >= 64) runs the wide instance, a block of 512 threads a feature and a
blocked Cholesky in panels of 32 columns with r as one more row below S:
warp 0 factors each diagonal block in registers by the same step and
hands its columns, eight at a time, to twelve warps that solve the panel
below it a row a thread and update the trailing triangle in 4 x 4 tiles;
two block barriers a panel.  S sits in shared memory as a square with an
odd stride up to m = 224 on the H100, then as the packed triangle, and
past m = 308 in a workspace this wrapper allocates on the caller's
stream.  Any m >= 1 is taken.  On the card (NVIDIA H100 80GB HBM3, 700 W;
chip_smoke.py, F = 100): 13.0 us a launch at m = 66 and 24.2 at m = 130,
where the one-barrier-a-pivot design before it took 43.4 and 158.5.  The
TPU kernel's 128-lane packing and transposes are not carried over.

NaN semantics (the gate relies on them): an indefinite S gives a NaN D
for that feature alone, so ``D < threshold`` rejects it (a pivot of
exactly zero gives NaN in the plain version and +inf or NaN in the
kernel, rejected alike).
"""

from __future__ import annotations

import ctypes

import torch

from benchmark.reference.rvio_plain.ops import _lib

_LIB = "spd_solve"
# rvio_spd_quadform_route: S, r, D, the workspace (or null), F, m, route
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
ROUTES = {"narrow": 0, "wide": 1}
NARROW_M = 64     # the warp-a-feature instances: two rows of S a lane
# the first order the dispatch gives the wide instance: it is the faster at
# m = 64 and the warp instance at every order below (chip_smoke.py's seam
# lines)
WIDE_FROM_M = 64
_workspace: dict = {}     # (device index, m) -> floats a feature


def batched_quadform_plain(S: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain version: Cholesky + solve, NaN where the factorization fails
    (the NaN-on-failure semantics of the JAX cho_factor)."""
    L, info = torch.linalg.cholesky_ex(S)
    sol = torch.cholesky_solve(r[..., None], L)[..., 0]
    D = torch.sum(r * sol, dim=-1)
    return torch.where(info == 0, D, torch.full_like(D, float("nan")))


def instance(m: int) -> str:
    """The instance the dispatch gives order m: "narrow" (a warp a
    feature) below WIDE_FROM_M, "wide" from it."""
    return "wide" if m >= WIDE_FROM_M else "narrow"


def batched_quadform(S: torch.Tensor, r: torch.Tensor, *,
                     route: str = "auto") -> torch.Tensor:
    """D[f] = r[f]^T S[f]^-1 r[f] for S (F, m, m), r (F, m) -> (F,).

    A CUDA tensor runs the kernel (f32, any m >= 1: "auto" takes
    :func:`instance` of m; ``route`` "narrow" or "wide" asks for one,
    "narrow" only up to NARROW_M); a CPU tensor the plain version."""
    if not _lib.uses_kernel(S, "batched_quadform"):
        return batched_quadform_plain(S, r)
    F, m = S.shape[0], S.shape[-1]
    dev = S.device
    _lib.check("batched_quadform", "S", S, (F, m, m), torch.float32, dev)
    _lib.check("batched_quadform", "r", r, (F, m), torch.float32, dev)
    if m < 1:
        raise ValueError(f"batched_quadform: the CUDA kernel takes m >= 1, "
                         f"got m = {m}")
    if route == "auto":
        route = instance(m)
    if route not in ROUTES or (route == "narrow" and m > NARROW_M):
        raise ValueError(f"batched_quadform: no route {route!r} at m = {m}")
    D = torch.empty(F, dtype=torch.float32, device=dev)
    if F == 0:
        return D
    need = workspace_floats(m, dev)
    ws = (torch.empty(F * need, dtype=torch.float32, device=dev) if need
          else None)
    fn = _lib.function(_LIB, "rvio_spd_quadform_route", _ARGS)
    _lib.call(_LIB, fn, _lib.ptr(S), _lib.ptr(r), _lib.ptr(D),
              ctypes.c_void_p(ws.data_ptr() if ws is not None else None),
              F, m, ROUTES[route], device=dev)
    _lib.launched(batched_quadform)
    return D


batched_quadform.launches = 0


def workspace_floats(m: int, device) -> int:
    """Floats of device workspace the kernel needs a feature at order m on
    the CUDA ``device``: 0 where the wide instance keeps S, the panel and r
    in a block's shared memory (m up to 308 on the H100).  Launches
    nothing."""
    dev = torch.device(device)
    key = (dev.index, m)
    if key not in _workspace:
        fn = _lib.function(_LIB, "rvio_spd_quadform_workspace",
                           [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int])
        out = ctypes.c_longlong(0)
        with torch.cuda.device(dev):
            _lib.call(_LIB, fn, ctypes.byref(out), m, device=dev)
        _workspace[key] = out.value
    return _workspace[key]
