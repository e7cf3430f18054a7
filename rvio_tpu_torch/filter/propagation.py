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

The per-sample recursion is the K1 kernel (ops/propagate_block.py) on a
CUDA tensor and its plain version, the JAX package's sequential fp-order
oracle, on a CPU tensor.  The JAX package's parallel-prefix form (a TPU
latency workaround computing the same math) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rvio_tpu_torch.core.quaternion import quat_to_rot, rot_to_quat
from rvio_tpu_torch.device import resolve_device
from rvio_tpu_torch.ops.propagate_block import propagate_block
from rvio_tpu_torch.state.filter_state import (FilterState, add_segment_axis,
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


def propagate(state: FilterState, imu: ImuBlock, *,
              gravity: float, small_angle: float,
              sigma_g: float, sigma_wg: float, sigma_a: float,
              sigma_wa: float) -> FilterState:
    """Propagate the state/covariance through one frame's IMU block.

    Faithful to reference PreIntegrator::propagate (PreIntegrator.cc:51-194):
    gR and vR are frozen at frame entry; F uses the *pre-sample* running
    (Rk, vk, gk); the state integrals then advance them.  Padding is masked
    by zeroing dt (an exact identity step); a frame with no valid sample
    keeps the previous relative pose and velocity.

    A state with a segment axis B takes an ImuBlock with the same leading
    axis ((B, K, 3), ...): K1 runs the B streams in one launch.  One
    filter's state runs as a batch of one.
    """
    if not state.batched:
        return drop_segment_axis(propagate(
            add_segment_axis(state), add_segment_axis(imu), gravity=gravity,
            small_angle=small_angle, sigma_g=sigma_g, sigma_wg=sigma_wg,
            sigma_a=sigma_a, sigma_wa=sigma_wa))
    dtype = state.dtype
    dte = torch.where(imu.valid, imu.dt, torch.zeros_like(imu.dt)).to(dtype)
    Rk, pk, vk, P24, Psi = propagate_block(
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
