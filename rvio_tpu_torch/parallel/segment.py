"""Segment-parallel filtering: a batch of independent filters, sharded.

Port of rvio_tpu/parallel/segment.py.  One filter instance per sequence
segment, every state field and bundle leaf with a leading segment axis;
the filter's one body runs them in lockstep, each kernel once a frame for
the batch (runtime/step.py).  Over a (seg, feat) mesh
(parallel/mesh.py), a rank holds the segments of its ``seg`` coordinate
(:func:`shard_states`, :func:`shard_bundles`) and, with feat > 1, the
F/feat update lanes of its ``feat`` coordinate.  The JAX package annotates
shardings and lets XLA insert the reductions; here they are written out:

- seg: no communication while filtering; :func:`gather_segments` rebuilds
  the global (S, ...) arrays on every rank at the end;
- feat: each rank runs the update's shard-local half (the window chains,
  K2, K3, K4, the χ² gate, its lanes' sums) and one ``all_reduce`` over
  the ``feat`` group a frame joins the sums (C = Σ Hw_iᵀHw_i and b with
  Cholesky compression, the shards' R factors with QR); every feat rank
  then applies the same replicated tail (K5, the retraction, the gates)
  and keeps the full state of its segments, bitwise equal across the
  feat ranks (filter/update.py ``msckf_update``).

With feat = 1 a rank's scan is ``make_batched_sequence_scan`` (a frame a
graph replay on the card).  With feat > 1 the frames run eagerly
(runtime/graph.py ``EagerFrameScan``): a gloo collective cannot be
captured in a CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch

from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.parallel.mesh import (all_gather_slots, feat_reducer,
                                          mesh_axes, mesh_device, needs_eager,
                                          segment_slice)
from rvio_tpu_torch.runtime.graph import EagerFrameScan, tree_leaves, tree_map
from rvio_tpu_torch.runtime.step import (UNROLL, FrameBundle, _segment_body,
                                         _segment_scan,
                                         make_batched_sequence_scan)
from rvio_tpu_torch.state.filter_state import (FilterState, map_fields,
                                               stack_states)

__all__ = ["gather_segments", "make_parallel_sequence", "make_parallel_step",
           "replicate_scalars", "shard_bundles", "shard_states",
           "stack_states"]

# the outputs of the sharded step and sequence (the JAX functions' keys)
OUTPUT_KEYS = ("q_kG", "p_Gk", "v_k", "n_good")


def _step_body(cfg: RVIOConfig, device, dtype=torch.float32,
               feat_reduce=None):
    """The segment body of rvio_tpu/parallel/segment.py ``_step_body``:
    ``body(states, bundles) -> (states, outputs)`` over a leading segment
    axis, with that function's arguments (the window chain in its
    sequential form)."""
    return _segment_body(cfg, device, dtype, parallel_chains=False,
                         feat_reduce=feat_reduce)


def _outputs(out: dict) -> dict:
    return {k: out[k] for k in OUTPUT_KEYS}


def make_parallel_step(cfg: RVIOConfig, mesh, dtype=torch.float32):
    """One-frame step for this rank's segments: ``pstep(states, bundles)
    -> (states, outputs)``, every leaf with the rank's leading segment
    axis (:func:`shard_states`, :func:`shard_bundles` with
    ``time_axis=False``: the update batch holds the rank's F/feat lanes);
    outputs q_kG, p_Gk, v_k, n_good.  Eager on the rank's device, with one
    ``all_reduce`` over ``feat`` where feat > 1."""
    body = _step_body(cfg, mesh_device(mesh), dtype, feat_reducer(mesh))

    def pstep(states: FilterState, bundles: FrameBundle):
        st, out = body(states, bundles)
        return st, _outputs(out)

    return pstep


def make_parallel_sequence(cfg: RVIOConfig, mesh, dtype=torch.float32):
    """Whole-sequence scan for this rank's segments (offline throughput):
    ``prun(states, bundles_T) -> (states, outputs_T)`` with bundle leaves
    (S/seg, T, ...) (:func:`shard_bundles`), each segment scanning its own
    T frames; outputs q_kG, p_Gk, v_k, n_good at (S/seg, T, ...)
    (:func:`gather_segments` gathers them).  With feat = 1 it is
    ``make_batched_sequence_scan`` (a frame a graph replay on the card);
    with feat > 1 the frames run eagerly, one ``all_reduce`` over ``feat``
    each.  ``prun.frame_scan`` is the FrameScan."""
    device = mesh_device(mesh)
    if needs_eager(mesh):
        run = _segment_scan(_step_body(cfg, device, dtype,
                                       feat_reducer(mesh)),
                            device, dtype, UNROLL, frame_scan=EagerFrameScan)
    else:
        run = make_batched_sequence_scan(cfg, device, dtype)

    def prun(states: FilterState, bundles: FrameBundle):
        st, out = run(states, bundles)
        return st, _outputs(out)

    prun.frame_scan = run.frame_scan
    return prun


def shard_states(states: FilterState, mesh) -> FilterState:
    """This rank's slice of a host-built segment batch of states (its
    ``seg`` coordinate's segments), on its device."""
    lo, hi = segment_slice(mesh, int(states.P.shape[0]))
    dev = mesh_device(mesh)
    return map_fields(lambda x: x[lo:hi].to(dev), states)


def shard_bundles(bundles: FrameBundle, mesh,
                  time_axis: bool = True) -> FrameBundle:
    """This rank's slice of (S, T, ...) bundles (``time_axis``; else
    (S, ...)): its segments on axis 0 and, in the update batch, its
    ``feat`` coordinate's F/feat lanes of the feature axis, on its device;
    a ValueError where seg does not divide S or feat F."""
    lo, hi = segment_slice(mesh, int(bundles.imu.w.shape[0]))
    _, n_feat, _, f = mesh_axes(mesh)
    axis = 2 if time_axis else 1
    F = int(bundles.batch.valid.shape[axis])
    if F % n_feat:
        raise ValueError(f"{F} feature lanes do not divide over feat={n_feat}")
    per = F // n_feat
    dev = mesh_device(mesh)

    def lanes(x):
        return x[lo:hi].narrow(axis, f * per, per).to(dev)

    return FrameBundle(imu=map_fields(lambda x: x[lo:hi].to(dev), bundles.imu),
                       batch=map_fields(lanes, bundles.batch))


def replicate_scalars(tree, mesh):
    """Shared constants on every rank's device: each tensor, array or
    number of a nest (see runtime/graph.py ``tree_map``) as a tensor
    there."""
    dev = mesh_device(mesh)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(put(v) for v in x)
        if isinstance(x, (torch.Tensor, np.ndarray, int, float, bool)):
            return torch.as_tensor(x).to(dev)
        return tree_map(lambda t: t.to(dev), x)

    return put(tree)


def gather_segments(tree, mesh):
    """The global (S, ...) leaves of a nest whose leaves hold this rank's
    (S/seg, ...) segments (outputs, or final states), on every rank: one
    ``all_reduce`` over the ``seg`` group of zero-padded slots, the leaves
    packed as float64 (exact for the working dtypes, counts and flags).
    The nest itself at seg = 1."""
    n_seg = mesh_axes(mesh)[0]
    leaves = tree_leaves(tree)
    if n_seg == 1:
        return tree
    S = int(leaves[0].shape[0])
    flat = torch.cat([x.reshape(S, -1).to(torch.float64) for x in leaves],
                     dim=1)
    full = all_gather_slots(flat, mesh, "seg").reshape(n_seg * S, -1)
    pieces, o = [], 0
    for x in leaves:
        w = x[:1].numel()
        pieces.append(full[:, o:o + w].reshape((n_seg * S,) + x.shape[1:])
                      .to(x.dtype))
        o += w
    it = iter(pieces)
    return tree_map(lambda _: next(it), tree)
