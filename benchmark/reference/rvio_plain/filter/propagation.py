"""IMU propagation: closed-form state integration + covariance recursion.

Port of rvio_tpu/filter/propagation.py over a fixed-size padded IMU block
per frame (reference: src/rvio/PreIntegrator.cc:51-194):

- closed-form delta rotation (Rodrigues with small-angle branch),
- closed-form dp/dv integrals with coefficients f1..f4,
- error-state transition F (24x24), Phi = I + dt F, accumulated Psi,
- noise Q = dt * G * Sigma_imu * G^T (12-dim IMU noise),
- P_core <- Phi P_core Phi^T + Q per sample,
- clone cross-covariance multiplied by the accumulated Psi once per frame,
- final symmetrization.

Three evaluations of the one recursion, dispatched as the JAX package
dispatches them (rvio_tpu/filter/propagation.py:99-114): a CUDA f32
tensor runs kernel K1 (ops/propagate_block.py, as the JAX package runs
its Pallas kernel on its accelerator); otherwise ``parallel=True`` runs the
parallel-prefix form (:func:`propagate_parallel`: every per-sample term
batched, the rotation and covariance chains as log-depth prefix scans,
another fp order of the same math); otherwise K1's plain version, the
sequential fp-order oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference.rvio_plain.core.prefix import prefix_scan
from benchmark.reference.rvio_plain.core.quaternion import quat_to_rot, rot_to_quat
from benchmark.reference.rvio_plain.core.so3 import delta_rot, skew, so3_integration_coeffs
from benchmark.reference.rvio_plain.device import resolve_device
from benchmark.reference.rvio_plain.ops.propagate_block import _sig, propagate_block
from benchmark.reference.rvio_plain.state.filter_state import (FilterState, add_segment_axis,
                                               drop_segment_axis)


@dataclass
class ImuBlock:
    """A frame's IMU samples, padded to a static length K.

    Mirrors the per-frame IMU list the reference drains from its
    InputBuffer (InputBuffer.cc:53-81): each sample has angular velocity,
    linear acceleration, and the time interval *ending* at its timestamp.
    """

    w: torch.Tensor      # (K, 3) angular velocity [rad/s]
    a: torch.Tensor      # (K, 3) linear acceleration [m/s^2]
    dt: torch.Tensor     # (K,)   per-sample integration interval [s]
    valid: torch.Tensor  # (K,)   bool mask (padding = False)
    # (each field with the state's leading segment axis B, where it has one)


def pad_imu(w: np.ndarray, a: np.ndarray, dt: np.ndarray, block_size: int):
    """Host-side padding of one frame's IMU arrays to the block size:
    (w (K, 3), a (K, 3), dt (K,), valid (K,)) as numpy arrays."""
    k = w.shape[0]
    if k > block_size:
        raise ValueError(f"frame has {k} IMU samples > block size {block_size}")
    pad = block_size - k
    return (np.pad(np.asarray(w, np.float64), ((0, pad), (0, 0))),
            np.pad(np.asarray(a, np.float64), ((0, pad), (0, 0))),
            np.pad(np.asarray(dt, np.float64), (0, pad)),
            np.arange(block_size) < k)


def make_imu_block(w: np.ndarray, a: np.ndarray, dt: np.ndarray,
                   block_size: int, dtype=torch.float32,
                   device=None) -> ImuBlock:
    """Pad host-side per-frame IMU arrays to the static block size, on
    ``device`` (``None``: the CUDA device)."""
    device = resolve_device(device)
    w, a, dt, valid = pad_imu(w, a, dt, block_size)

    def dev(x):
        return torch.as_tensor(x, device=device).to(dtype)

    return ImuBlock(w=dev(w), a=dev(a), dt=dev(dt),
                    valid=torch.as_tensor(valid, device=device))


def propagate_parallel(w, a, dte, R0, vR, gR, bg, ba, P0, *,
                       gravity: float, small_angle: float, sigma_g: float,
                       sigma_wg: float, sigma_a: float, sigma_wa: float):
    """One frame's propagation as a parallel prefix: port of
    rvio_tpu/filter/propagation.py ``_propagate_parallel``, for B streams,
    with the inputs and outputs of ops/propagate_block.propagate_block
    ((Rk, pk, vk, P24, Psi)).

    1. every per-sample increment built batched (dR, f1..f4, the dp/dv
       integrands, F, Phi, Q: no serial dependency);
    2. the rotation chain Rk_i = dR_i ... dR_1 R0 and the covariance chain
       (P -> Phi P Phi^T + Q, composing as (A2, Q2)∘(A1, Q1) =
       (A2 A1, A2 Q1 A2^T + Q2)) as prefix scans (core/prefix.py);
    3. dv, dp as cumulative sums of rotated increments, and the pre-sample
       (vk, gk) that F needs in closed form from the prefixes.

    Padding is masked by dt = 0 alone: dR = I, f1..f4 = 0, Phi = I, Q = 0,
    an exact identity step whatever w and a hold.  The same math as the
    sequential recursion in another fp order (about 1e-13 apart in f64)."""
    dtype, dev = P0.dtype, P0.device
    B, K = dte.shape
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye24 = torch.eye(24, dtype=dtype, device=dev)

    def col(x):
        return x[..., None, None]

    w = w - bg[:, None]
    a = a - ba[:, None]
    wx = skew(w)                                          # (B, K, 3, 3)
    wx2 = wx @ wx
    dRs = delta_rot(w, dte, small_angle)
    f1, f2, f3, f4 = so3_integration_coeffs(
        torch.linalg.vector_norm(w, dim=-1), dte, small_angle)

    # rotation prefix: pref_i = dR_i ... dR_1 (combine = later @ earlier)
    (pref,) = prefix_scan((dRs,), lambda e, l: (l[0] @ e[0],), dim=1)
    Rk = pref @ R0[:, None]                               # post-sample
    prev_R = torch.cat([R0[:, None], Rk[:, :-1]], dim=1)

    Dt = torch.cumsum(dte, dim=1)                         # post-sample
    prev_Dt = Dt - dte

    # dv/dp prefix sums (PreIntegrator.cc:168-173 with the updated Rk)
    RkT = Rk.transpose(-1, -2)
    Mv = col(dte) * eye3 + col(f3) * wx + col(f4) * wx2
    ev = (RkT @ (Mv @ a[..., None]))[..., 0]              # dv increments
    dv = torch.cumsum(ev, dim=1)
    prev_dv = dv - ev
    Mp = col(0.5 * dte ** 2) * eye3 + col(f1) * wx + col(f2) * wx2
    ep = prev_dv * dte[..., None] + (RkT @ (Mp @ a[..., None]))[..., 0]
    dp = torch.cumsum(ep, dim=1)

    # pre-sample vk/gk for F (sample 0 uses the frame-entry state,
    # PreIntegrator.cc:63-66)
    vk_form = (prev_R @ (vR[:, None] - gravity * gR[:, None]
                         * prev_Dt[..., None] + prev_dv)[..., None])[..., 0]
    gk_form = (prev_R @ gR[:, None, :, None])[..., 0]
    gk_form = gk_form / torch.linalg.vector_norm(gk_form, dim=-1,
                                                 keepdim=True)
    first = (torch.arange(K, device=dev) == 0)[None, :, None]
    prev_vk = torch.where(first, vR[:, None], vk_form)
    prev_gk = torch.where(first, gR[:, None], gk_form)

    # batched F, Phi, Q (PreIntegrator.cc:122-142)
    vx = skew(prev_vk)
    prev_RT = prev_R.transpose(-1, -2)
    F = torch.zeros(B, K, 24, 24, dtype=dtype, device=dev)
    F[..., 9:12, 9:12] = -wx
    F[..., 9:12, 18:21] = -eye3
    F[..., 12:15, 9:12] = -(prev_RT @ vx)
    F[..., 12:15, 15:18] = prev_RT
    F[..., 15:18, 6:9] = -gravity * prev_R
    F[..., 15:18, 9:12] = -gravity * skew(prev_gk)
    F[..., 15:18, 15:18] = -wx
    F[..., 15:18, 18:21] = -vx
    F[..., 15:18, 21:24] = -eye3
    Phi = eye24 + col(dte) * F

    sig = torch.cat([torch.full((3,), s, dtype=dtype, device=dev)
                     for s in _sig(sigma_g, sigma_wg, sigma_a, sigma_wa)])
    G = torch.zeros(B, K, 24, 12, dtype=dtype, device=dev)
    G[..., 9:12, 0:3] = -eye3
    G[..., 15:18, 0:3] = -vx
    G[..., 15:18, 6:9] = -eye3
    G[..., 18:21, 3:6] = eye3
    G[..., 21:24, 9:12] = eye3
    Q = (col(dte) * (G * sig)) @ G.transpose(-1, -2)

    def combine(e, l):
        (Ae, Qe), (Al, Ql) = e, l
        return Al @ Ae, Al @ Qe @ Al.transpose(-1, -2) + Ql

    Psis, Qacc = prefix_scan((Phi, Q), combine, dim=1)
    Psi = Psis[:, -1]
    P24 = Psi @ P0 @ Psi.transpose(-1, -2) + Qacc[:, -1]

    # finals (PreIntegrator.cc:171-178 at the last sample)
    Dt_f = Dt[:, -1, None]
    pk = vR * Dt_f - 0.5 * gravity * gR * Dt_f ** 2 + dp[:, -1]
    vk = (Rk[:, -1] @ (vR - gravity * gR * Dt_f + dv[:, -1])[..., None]
          )[..., 0]
    return Rk[:, -1], pk, vk, P24, Psi


def propagate(state: FilterState, imu: ImuBlock, *,
              gravity: float, small_angle: float,
              sigma_g: float, sigma_wg: float, sigma_a: float,
              sigma_wa: float, parallel: bool = False) -> FilterState:
    """Propagate the state/covariance through one frame's IMU block.

    Faithful to reference PreIntegrator::propagate (PreIntegrator.cc:51-194):
    gR and vR are frozen at frame entry; F uses the *pre-sample* running
    (Rk, vk, gk); the state integrals then advance them.  Padding is masked
    by zeroing dt (an exact identity step); a frame with no valid sample
    keeps the previous relative pose and velocity.

    A state with a segment axis B takes an ImuBlock with the same leading
    axis ((B, K, 3), ...): K1 runs the B streams in one launch.  One
    filter's state runs as a batch of one.

    A CUDA f32 state runs K1; any other takes the parallel-prefix form
    (:func:`propagate_parallel`) with ``parallel`` and the sequential
    recursion (K1's plain version) without it, as the JAX function's
    ``parallel`` picks (its default is True; the port's callers pass
    ``tpu.parallel_propagation``).
    """
    if not state.batched:
        return drop_segment_axis(propagate(
            add_segment_axis(state), add_segment_axis(imu), gravity=gravity,
            small_angle=small_angle, sigma_g=sigma_g, sigma_wg=sigma_wg,
            sigma_a=sigma_a, sigma_wa=sigma_wa, parallel=parallel))
    dtype = state.dtype
    on_k1 = state.device.type == "cuda" and dtype == torch.float32
    terms = propagate_parallel if parallel and not on_k1 else propagate_block
    dte = torch.where(imu.valid, imu.dt, torch.zeros_like(imu.dt)).to(dtype)
    Rk, pk, vk, P24, Psi = terms(
        imu.w.to(dtype).contiguous(), imu.a.to(dtype).contiguous(),
        dte.contiguous(), quat_to_rot(state.q_R), state.v_R.contiguous(),
        state.g.contiguous(), state.bg.contiguous(), state.ba.contiguous(),
        state.P[:, :24, :24].contiguous(),
        gravity=gravity, small_angle=small_angle, sigma_g=sigma_g,
        sigma_wg=sigma_wg, sigma_a=sigma_a, sigma_wa=sigma_wa)

    # per segment: a frame with no valid sample keeps its pose
    has_valid = torch.any(imu.valid, dim=-1)[:, None]
    qk = torch.where(has_valid, rot_to_quat(Rk), state.q_R)
    pk = torch.where(has_valid, pk, state.p_R)
    vk = torch.where(has_valid, vk, state.v_R)

    # Clone cross-covariance advances by the accumulated Psi once per frame
    # (PreIntegrator.cc:186-191); invalid clone cols are zero and stay zero.
    P = state.P
    cross = Psi @ P[:, :24, 24:]
    P = torch.cat([torch.cat([P24, cross], dim=-1),
                   torch.cat([cross.transpose(-1, -2), P[:, 24:, 24:]],
                             dim=-1)], dim=-2)
    P = 0.5 * (P + P.transpose(-1, -2))

    return FilterState(
        q_G=state.q_G, p_G=state.p_G, g=state.g,
        q_R=qk, p_R=pk, v_R=vk,
        bg=state.bg, ba=state.ba, clones=state.clones, P=P,
        n_clones=state.n_clones, frame_idx=state.frame_idx,
        clones_fej=state.clones_fej, sigma2_scale=state.sigma2_scale,
    )
