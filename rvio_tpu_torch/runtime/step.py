"""The per-frame filter step and the whole-sequence frame loop.

Port of rvio_tpu/runtime/step.py.  Chains propagation -> MSCKF update ->
clone augmentation -> robocentric composition, the order of
System::MonoVIO (reference: src/rvio/System.cc:173-437, steps at :263,
:268, :280, :325).  The step is front-end agnostic: its UpdateBatch comes
from the simulator, a replay, or a tracker.

PyTorch runs eagerly, so the step is a plain function: the reference of
the graphed loop, and the step the per-frame callers use.  The sequence
scan runs it as the JAX package's ``lax.scan`` does, one frame after
another on the device with nothing read back, as replays of captured CUDA
graphs on a CUDA device (runtime/graph.py) and eagerly on the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.device import resolve_device
from rvio_tpu_torch.filter.propagation import ImuBlock, propagate
from rvio_tpu_torch.filter.update import UpdateBatch, msckf_update
from rvio_tpu_torch.runtime.graph import FrameScan, tree_leaves, tree_map
from rvio_tpu_torch.state import FilterState, augment_window, compose_state

# Frames in one graph of the sequence scan: on the feature path at
# RVIOConfig() on an H100, 1 and 8 tie within the spread of runs and 32 is
# slower (chip_smoke.py's graph-vs-eager phase; PERF.md section 6); 1
# captures fastest and needs no tail graph.
UNROLL = 1


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
    output of :func:`make_filter_step` stacked the same way (T, ...), left
    on the device (copies, which later runs leave alone).

    As the JAX package packs them (rvio_tpu/runtime/step.py:118-158), a
    frame's inputs are one flat row of the working dtype and its outputs
    another (ints and bools are small integers, exact in f32): the frame
    reads its row at a device-side cursor and writes its outputs there, so
    a frame takes one gather and one store.  On a CUDA device the frames
    are replays of graphs of ``UNROLL`` frames (runtime/graph.py)."""
    return _sequence_scan(cfg, device, dtype, UNROLL)


def _sequence_scan(cfg: RVIOConfig, device, dtype, unroll: int):
    """:func:`make_sequence_scan` with ``unroll`` frames in a graph; the
    returned ``run`` holds its :class:`FrameScan` as ``run.frame_scan``."""
    device = resolve_device(device)
    step = make_filter_step(cfg, device, dtype)
    layout = {}      # "in", "out": (shape, dtype) of each packed leaf

    def body(state, frame):
        bundle = _unflatten(frame["row"], layout["in"])
        st, out = step(state, bundle)
        layout["out"] = [(k, tuple(v.shape), v.dtype)
                         for k, v in out.items()]
        return st, {"row": torch.cat([v.reshape(-1).to(dtype)
                                      for v in out.values()])}

    scan = FrameScan(body, device, unroll)

    def run(state: FilterState, bundles: FrameBundle):
        T = bundles.imu.w.shape[0]
        if T == 0:
            return state, {}
        leaves = tree_leaves(bundles)
        layout["in"] = tuple((tuple(x.shape[1:]), x.dtype) for x in leaves)
        rows = torch.cat([x.reshape(T, -1).to(dtype) for x in leaves], dim=1)
        scan.load(state)
        out = scan.run({"row": rows}, static=layout["in"])
        return (tree_map(torch.clone, scan.carry),
                _split(out["row"], layout["out"]))

    run.frame_scan = scan
    return run


def _unflatten(row: torch.Tensor, spec) -> FrameBundle:
    """The bundle of one packed row; ``spec`` holds each leaf's shape and
    dtype in :func:`tree_leaves` order of a FrameBundle."""
    xs, o = [], 0
    for shape, dt in spec:
        n = math.prod(shape)
        xs.append(row[o:o + n].reshape(shape).to(dt))
        o += n
    w, a, dts, valid, meas, track_len, is_type2, ok = xs
    return FrameBundle(imu=ImuBlock(w=w, a=a, dt=dts, valid=valid),
                       batch=UpdateBatch(meas=meas, track_len=track_len,
                                         is_type2=is_type2, valid=ok))


def _split(rows: torch.Tensor, spec) -> Dict[str, torch.Tensor]:
    """The (T, ...) outputs of the (T, width) packed output rows."""
    out, o = {}, 0
    for k, shape, dt in spec:
        n = math.prod(shape)
        out[k] = rows[:, o:o + n].reshape((rows.shape[0],) + shape).to(
            dt, copy=True)
        o += n
    return out
