"""The per-frame filter step and the whole-sequence frame loop.

Port of rvio_tpu/runtime/step.py.  Chains propagation -> MSCKF update ->
clone augmentation -> robocentric composition, the order of
System::MonoVIO (reference: src/rvio/System.cc:173-437, steps at :263,
:268, :280, :325).  The step is front-end agnostic: its UpdateBatch comes
from the simulator, a replay, or a tracker.

PyTorch runs eagerly, so the step is a plain function and the sequence
"scan" is a Python loop over frames; no step reads a tensor back to the
host, so on a CUDA device the loop only enqueues work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.filter.propagation import ImuBlock, propagate
from rvio_tpu_torch.filter.update import UpdateBatch, msckf_update
from rvio_tpu_torch.state import FilterState, augment_window, compose_state


@dataclass
class FrameBundle:
    """One frame's inputs to the back-end: IMU block + update features
    (or, for :func:`make_sequence_scan`, T frames stacked on a leading
    axis of every tensor)."""

    imu: ImuBlock
    batch: UpdateBatch

    def frame(self, t: int) -> "FrameBundle":
        """Frame t of a stacked bundle."""
        i, b = self.imu, self.batch
        return FrameBundle(
            imu=ImuBlock(w=i.w[t], a=i.a[t], dt=i.dt[t], valid=i.valid[t]),
            batch=UpdateBatch(meas=b.meas[t], track_len=b.track_len[t],
                              is_type2=b.is_type2[t], valid=b.valid[t]))


def make_filter_step(cfg: RVIOConfig, device, dtype=torch.float32
                     ) -> Callable[[FilterState, FrameBundle],
                                   Tuple[FilterState, Dict[str, torch.Tensor]]]:
    """The per-frame step for a fixed configuration, device and dtype.

    Returns ``step(state, bundle) -> (state, outputs)`` where outputs hold
    the per-frame global pose (q_kG, p_Gk), velocity, and update
    diagnostics (System.cc:369-434), all tensors on the device.
    """
    imu_kw = dict(gravity=cfg.imu.gravity, small_angle=cfg.imu.small_angle,
                  sigma_g=cfg.imu.sigma_g, sigma_wg=cfg.imu.sigma_wg,
                  sigma_a=cfg.imu.sigma_a, sigma_wa=cfg.imu.sigma_wa)
    # extrinsics moved to the device once, not per frame
    upd_kw = dict(R_bc=torch.as_tensor(cfg.camera.R_bc, device=device).to(dtype),
                  t_bc=torch.as_tensor(cfg.camera.t_bc, device=device).to(dtype),
                  sigma_im=cfg.camera.sigma_image,
                  min_clone_states=cfg.min_clone_states,
                  compression=cfg.tpu.compression,
                  fej=cfg.tpu.fej,
                  adaptive_noise=cfg.tpu.adaptive_noise,
                  adaptive_rampup=cfg.tpu.adaptive_rampup_frames,
                  parallel_chains=cfg.tpu.parallel_propagation)

    def step(state: FilterState, bundle: FrameBundle
             ) -> Tuple[FilterState, Dict[str, torch.Tensor]]:
        st = propagate(state, bundle.imu, **imu_kw)
        st, diag = msckf_update(st, bundle.batch, **upd_kw)
        st = augment_window(st)
        st, (q_kG, p_Gk, vk) = compose_state(st)
        outputs = {
            "q_kG": q_kG, "p_Gk": p_Gk, "v_k": vk,
            "n_good": diag["n_good"], "did_update": diag["did_update"],
            "landmarks": diag["landmarks"], "landmark_ok": diag["passed"],
            "rho": diag["rho"], "n_usable": diag["n_usable"],
            "tl_good_sum": diag["tl_good_sum"],
            "ridge_fallback": diag["ridge_fallback"],
        }
        return st, outputs

    return step


def make_sequence_scan(cfg: RVIOConfig, device, dtype=torch.float32):
    """The whole-sequence loop: ``run(state, bundles) -> (final_state,
    outputs)`` with bundles stacked on a leading time axis T and every
    output stacked the same way (T, ...), left on the device."""
    step = make_filter_step(cfg, device, dtype)

    def run(state: FilterState, bundles: FrameBundle):
        T = bundles.imu.w.shape[0]
        rows = []
        for t in range(T):
            state, out = step(state, bundles.frame(t))
            rows.append(out)
        outs = {k: torch.stack([r[k] for r in rows]) for k in rows[0]} \
            if rows else {}
        return state, outs

    return run
