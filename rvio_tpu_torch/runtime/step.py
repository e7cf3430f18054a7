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

There is one filter body, for B filters in lockstep (a leading segment
axis on every state field and bundle leaf; no ``torch.vmap``: the
kernels are ctypes calls).  The segment scan runs it over B segments;
the single-sequence step and scan run it at B = 1, adding and removing
the axis at their edges.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Callable, Dict, Tuple

import torch

from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.device import resolve_device
from rvio_tpu_torch.filter.propagation import ImuBlock, propagate
from rvio_tpu_torch.filter.update import UpdateBatch, msckf_update
from rvio_tpu_torch.runtime.graph import FrameScan, tree_leaves, tree_map
from rvio_tpu_torch.state import FilterState, augment_window, compose_state
from rvio_tpu_torch.state.filter_state import (add_segment_axis,
                                               drop_segment_axis)
from rvio_tpu_torch.utils import profiling
from rvio_tpu_torch.utils.profiling import span

# Frames in one graph of the sequence scan: on the feature path at
# RVIOConfig() on an H100, 1 and 8 tie within the spread of runs and 32 is
# slower (chip_smoke.py's graph-vs-eager phase; PERF.md section 6); 1
# captures fastest and needs no tail graph.
UNROLL = 1


@dataclass
class FrameBundle:
    """One frame's inputs to the back-end: IMU block + update features
    (or, for :func:`make_sequence_scan`, T frames stacked on a leading
    axis of every tensor, and for :func:`make_batched_sequence_scan` B
    segments of T frames, (B, T, ...))."""

    imu: ImuBlock
    batch: UpdateBatch

    def frame(self, t: int) -> "FrameBundle":
        """Frame t of a stacked bundle."""
        i, b = self.imu, self.batch
        return FrameBundle(
            imu=ImuBlock(w=i.w[t], a=i.a[t], dt=i.dt[t], valid=i.valid[t]),
            batch=UpdateBatch(meas=b.meas[t], track_len=b.track_len[t],
                              is_type2=b.is_type2[t], valid=b.valid[t]))


def _segment_body(cfg: RVIOConfig, device, dtype, parallel_chains: bool,
                  feat_reduce=None
                  ) -> Callable[[FilterState, FrameBundle],
                                Tuple[FilterState, Dict[str, torch.Tensor]]]:
    """The filter's one body: ``body(states, bundles) -> (states,
    outputs)`` for a state and a bundle with a leading segment axis B,
    every output (B, ...).  Every filter kernel launches once for the B
    segments.  ``parallel_chains`` picks the form of the window chain
    (filter/update.window_pose_chain) and of propagation off the card
    (filter/propagation.propagate); ``feat_reduce`` joins the update's
    halves when the bundles hold one shard of the feature lanes
    (filter/update.msckf_update)."""
    imu_kw = dict(gravity=cfg.imu.gravity, small_angle=cfg.imu.small_angle,
                  sigma_g=cfg.imu.sigma_g, sigma_wg=cfg.imu.sigma_wg,
                  sigma_a=cfg.imu.sigma_a, sigma_wa=cfg.imu.sigma_wa,
                  parallel=parallel_chains)
    # extrinsics moved to the device once, not per frame
    upd_kw = dict(R_bc=torch.as_tensor(cfg.camera.R_bc, device=device).to(dtype),
                  t_bc=torch.as_tensor(cfg.camera.t_bc, device=device).to(dtype),
                  sigma_im=cfg.camera.sigma_image,
                  min_clone_states=cfg.min_clone_states,
                  compression=cfg.tpu.compression,
                  fej=cfg.tpu.fej,
                  adaptive_noise=cfg.tpu.adaptive_noise,
                  adaptive_rampup=cfg.tpu.adaptive_rampup_frames,
                  parallel_chains=parallel_chains, feat_reduce=feat_reduce)

    def body(states: FilterState, bundles: FrameBundle
             ) -> Tuple[FilterState, Dict[str, torch.Tensor]]:
        st = propagate(states, bundles.imu, **imu_kw)
        st, diag = msckf_update(st, bundles.batch, **upd_kw)
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

    return body


def make_filter_step(cfg: RVIOConfig, device, dtype=torch.float32
                     ) -> Callable[[FilterState, FrameBundle],
                                   Tuple[FilterState, Dict[str, torch.Tensor]]]:
    """The per-frame step for a fixed configuration, device and dtype.

    Returns ``step(state, bundle) -> (state, outputs)`` where outputs hold
    the per-frame global pose (q_kG, p_Gk), velocity, and update
    diagnostics (System.cc:369-434), all tensors on the device.  It is the
    filter's body at B = 1: the segment axis is added and removed at the
    step's edges (views)."""
    body = _segment_body(cfg, device, dtype, cfg.tpu.parallel_propagation)

    def step(state: FilterState, bundle: FrameBundle
             ) -> Tuple[FilterState, Dict[str, torch.Tensor]]:
        st, out = body(add_segment_axis(state), _bundle_axis(bundle))
        return drop_segment_axis(st), {k: v[0] for k, v in out.items()}

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
    are replays of graphs of ``UNROLL`` frames (runtime/graph.py).  It is
    the segment scan (:func:`make_batched_sequence_scan`) at B = 1."""
    return _sequence_scan(cfg, device, dtype, UNROLL)


def make_batched_sequence_scan(cfg: RVIOConfig, device=None,
                               dtype=torch.float32):
    """B independent filters in lockstep (rvio_tpu/runtime/step.py:163):
    ``run(states, bundles) -> (final_states, outputs)`` with a leading
    segment axis B on every field of ``states`` (:func:`stack_states`)
    and (B, T, ...) bundle leaves; the outputs are
    :func:`make_sequence_scan`'s keys at (B, T, ...).

    A frame of the B segments is one row of the input table (each
    segment's packed row in turn) and one replay of a captured graph on a
    CUDA device: every filter kernel launches once a frame for the whole
    batch.  As the JAX function does, the window chain and propagation
    off the card run in their sequential forms whatever
    ``tpu.parallel_propagation`` says.
    ``device`` ``None`` means the CUDA device; ``run.frame_scan`` is the
    :class:`FrameScan`."""
    device = resolve_device(device)
    return _segment_scan(_segment_body(cfg, device, dtype, False), device,
                         dtype, UNROLL)


def _sequence_scan(cfg: RVIOConfig, device, dtype, unroll: int):
    """:func:`make_sequence_scan` with ``unroll`` frames in a graph; the
    returned ``run`` holds its :class:`FrameScan` as ``run.frame_scan``."""
    device = resolve_device(device)
    scan = _segment_scan(_segment_body(cfg, device, dtype,
                                       cfg.tpu.parallel_propagation),
                         device, dtype, unroll)

    def run(state: FilterState, bundles: FrameBundle):
        states, out = scan(add_segment_axis(state), _bundle_axis(bundles))
        return drop_segment_axis(states), {k: v[0] for k, v in out.items()}

    run.frame_scan = scan.frame_scan
    return run


def _segment_scan(body, device: torch.device, dtype, unroll: int,
                  masked: bool = False, frame_scan=None):
    """The frame loop of B segments over the segment ``body``
    (:func:`_segment_body`): ``run(states, bundles[, ok])``.  With
    ``masked``, ``ok`` (B, T) bool says which frames of which segments
    count: a frame that does not leaves that segment's state as it was
    (its outputs are still written), and the outputs gain ``ok``.
    ``frame_scan`` is the FrameScan class (default: runtime/graph.py's
    ``FrameScan``; its ``EagerFrameScan`` for a body with a collective no
    graph may capture).  Spans (utils/profiling.py):
    ``sequence_scan.pack`` (the input rows) and ``sequence_scan.split``
    (the outputs and the carry copied out); the count
    ``sequence_scan.poses`` adds B·T a call, and the call ends with the
    mark ``sequence_scan.call``."""
    layout = {}      # "B"; "in", "out": (shape, dtype) of each packed leaf

    def frame_body(states, frame):
        B = layout["B"]
        xs = _unpack(frame["row"].reshape(B, -1), layout["in"])
        bundle = _bundle(xs[:8])
        st, out = body(states, bundle)
        if masked:
            ok = xs[8]
            st = FilterState(**{f.name: _where_segment(
                ok, getattr(st, f.name), getattr(states, f.name))
                for f in fields(FilterState)})
            out = {**out, "ok": ok}
        layout["out"] = [(k, tuple(v.shape[1:]), v.dtype)
                         for k, v in out.items()]
        return st, {"row": torch.cat([v.reshape(B, -1).to(dtype)
                                      for v in out.values()], dim=1
                                     ).reshape(-1)}

    scan = (frame_scan or FrameScan)(frame_body, device, unroll)

    def run(states: FilterState, bundles: FrameBundle, ok=None):
        B, T = bundles.imu.w.shape[:2]
        if (ok is not None) != masked:
            raise TypeError("ok is the masked scan's argument, and it needs it")
        if T == 0:
            return states, {}
        with span("sequence_scan.pack"):
            leaves = tree_leaves(bundles) + ([ok] if masked else [])
            layout["B"] = B
            layout["in"] = tuple((tuple(x.shape[2:]), x.dtype)
                                 for x in leaves)
            rows = torch.cat([x.transpose(0, 1).reshape(T, B, -1).to(dtype)
                              for x in leaves], dim=2).reshape(T, -1)
        scan.load(states)
        out = scan.run({"row": rows}, static=(B, layout["in"]))
        with span("sequence_scan.split"):
            got = (tree_map(torch.clone, scan.carry),
                   _split(out["row"].reshape(T, B, -1), layout["out"]))
        profiling.add("sequence_scan.poses", B * T)
        profiling.mark("sequence_scan.call")
        return got

    run.frame_scan = scan
    return run


def _where_segment(ok: torch.Tensor, new: torch.Tensor, old: torch.Tensor
                   ) -> torch.Tensor:
    """``new`` in the segments where ``ok`` (B,), ``old`` elsewhere."""
    return torch.where(ok.reshape(ok.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _bundle_axis(bundle: FrameBundle) -> FrameBundle:
    """A bundle of one filter as a batch of one (views)."""
    return FrameBundle(imu=add_segment_axis(bundle.imu),
                       batch=add_segment_axis(bundle.batch))


def _bundle(xs) -> FrameBundle:
    w, a, dts, valid, meas, track_len, is_type2, ok = xs
    return FrameBundle(imu=ImuBlock(w=w, a=a, dt=dts, valid=valid),
                       batch=UpdateBatch(meas=meas, track_len=track_len,
                                         is_type2=is_type2, valid=ok))


def _unpack(rows: torch.Tensor, spec):
    """The leaves of (B, width) packed rows, each (B, ...); ``spec``
    holds each leaf's shape and dtype in :func:`tree_leaves` order of a
    FrameBundle (then the mask, where there is one)."""
    xs, o = [], 0
    for shape, dt in spec:
        n = math.prod(shape)
        xs.append(rows[:, o:o + n].reshape((rows.shape[0],) + shape).to(dt))
        o += n
    return xs


def _split(rows: torch.Tensor, spec) -> Dict[str, torch.Tensor]:
    """The (B, T, ...) outputs of the (T, B, width) packed output rows
    (copies, contiguous)."""
    out, o = {}, 0
    T, B = rows.shape[:2]
    for k, shape, dt in spec:
        n = math.prod(shape)
        out[k] = rows[:, :, o:o + n].reshape((T, B) + shape).transpose(
            0, 1).to(dt, memory_format=torch.contiguous_format, copy=True)
        o += n
    return out
