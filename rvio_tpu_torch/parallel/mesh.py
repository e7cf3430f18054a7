"""The (seg, feat) device mesh over ``torch.distributed`` ranks.

Port of rvio_tpu/parallel/mesh.py.  The two axes keep their meaning:

- ``seg``: data parallelism over independent sequence segments, one
  filter instance per segment; no communication while filtering, the
  outputs are gathered at the end (:func:`all_gather_slots`,
  parallel/segment.py ``gather_segments``);
- ``feat``: model parallelism of the per-feature update work
  (triangulation, Jacobians, gating) and of the tracker's KLT lanes, joined
  by one ``all_reduce`` a frame over the ``feat`` group: the Schur-style
  sum of the H^T H contributions (:func:`feat_reducer`) and the KLT's
  gather (:func:`klt_splitter`).

The JAX package runs one process a host, places shardings and lets XLA
insert the collectives.  Here a rank is one process with one device (one
GPU, or the CPU), the mesh is a ``torch.distributed`` ``DeviceMesh`` with
``mesh_dim_names=("seg", "feat")`` (rank r at seg coordinate r // feat,
feat coordinate r % feat), and every collective is written by hand, with
``all_reduce`` and ``broadcast`` only (the two collectives gloo takes on
CUDA tensors): a gather is an ``all_reduce`` of zero-padded slots.  The
process group comes first (parallel/launch.py ``initialize_distributed``:
NCCL on the card, gloo on the CPU, the backend the caller names).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from rvio_tpu_torch.frontend.klt import klt_track

AXES = ("seg", "feat")


def mesh_shape(n: int, seg: Optional[int] = None,
               feat: Optional[int] = None) -> Tuple[int, int]:
    """The (seg, feat) factorization of n devices, with make_mesh's
    defaults (all on ``seg``); a ValueError where seg * feat != n."""
    if seg is None and feat is None:
        seg, feat = n, 1
    elif seg is None:
        seg = n // feat
    elif feat is None:
        feat = n // seg
    if seg * feat != n:
        raise ValueError(f"mesh {seg}x{feat} != {n} devices")
    return seg, feat


def make_mesh(n_devices: Optional[int] = None, seg: Optional[int] = None,
              feat: Optional[int] = None, device_type: Optional[str] = None):
    """Build a (seg, feat) ``DeviceMesh`` over the ranks of the process
    group.

    ``n_devices`` is the world size (default: the process group's); the
    factorization is checked first, so a bad one raises ValueError before
    any process group is touched.  Defaults: all ranks on ``seg``
    (segment parallelism needs no communication, so it wins whenever
    segments are plentiful).  ``device_type`` is "cuda" unless the caller
    asks for "cpu"; each rank's device is its current CUDA device
    (:func:`mesh_device`)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    seg, feat = mesh_shape(n, seg, feat)
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device_type='cpu' "
                           "for a mesh of CPU ranks")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.launch.initialize_distributed (or "
                           "torch.distributed.init_process_group) first")
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a world of {world} "
                         f"ranks: n_devices is the world size")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (seg, feat), mesh_dim_names=AXES)


def mesh_axes(mesh) -> Tuple[int, int, int, int]:
    """(seg size, feat size, this rank's seg coordinate, its feat
    coordinate)."""
    return (mesh.size(0), mesh.size(1), mesh.get_local_rank("seg"),
            mesh.get_local_rank("feat"))


def mesh_device(mesh) -> torch.device:
    """This rank's device: its current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def segment_slice(mesh, num_segments: int) -> Tuple[int, int]:
    """The [lo, hi) segments of this rank's ``seg`` coordinate: S / seg
    contiguous segments each (the sharded steps' slice); a ValueError where
    seg does not divide S."""
    n_seg, _, c, _ = mesh_axes(mesh)
    if num_segments % n_seg:
        raise ValueError(f"{num_segments} segments do not divide over "
                         f"seg={n_seg}")
    per = num_segments // n_seg
    return c * per, (c + 1) * per


def all_gather_slots(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` along mesh axis ``axis``, in
    coordinate order, by one ``all_reduce`` of a zero buffer holding ``x``
    in this rank's slot (x + 0 is x exactly, so the slots arrive bitwise;
    a negative zero arrives as zero).  Bools travel as uint8.  No
    collective on an axis of size 1."""
    size = mesh.size(AXES.index(axis))
    if size == 1:
        return x[None]
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    buf = wire.new_zeros((size,) + tuple(x.shape))
    buf[mesh.get_local_rank(axis)] = wire
    dist.all_reduce(buf, group=mesh.get_group(axis))
    return buf.to(torch.bool) if x.dtype == torch.bool else buf


def needs_eager(mesh) -> bool:
    """Whether a frame over ``mesh`` holds a collective (feat > 1: the
    update's sums, the KLT's gather).  The frame scans run such frames
    eagerly (runtime/graph.py ``EagerFrameScan``): a gloo collective
    cannot be captured in a CUDA graph.  False without a mesh."""
    return mesh is not None and mesh.size(AXES.index("feat")) > 1


def feat_reducer(mesh):
    """The update's ``feat_reduce`` over the mesh's ``feat`` group (None
    where no frame needs it, :func:`needs_eager`): the shard's sums and
    row blocks packed into one buffer of the working dtype (counts are
    small integers, exact), the blocks in this rank's zero-padded slot,
    one ``all_reduce``; every rank gets the same merged partials
    (filter/update.py ``merge_partials``), each contiguous (the kernels
    take contiguous operands)."""
    if not needs_eager(mesh):
        return None
    _, n_feat, _, idx = mesh_axes(mesh)
    group = mesh.get_group("feat")

    def reduce(parts):
        dtype = parts.sig2_eff.dtype
        B = parts.sig2_eff.shape[0]
        sk, tk = sorted(parts.sums), sorted(parts.stacks)
        sums = [parts.sums[k].to(dtype).reshape(B, -1) for k in sk]
        blocks = [parts.stacks[k].reshape(B, -1) for k in tk]
        slots = sums[0].new_zeros((n_feat, B, sum(x.shape[1] for x in blocks)))
        if blocks:
            slots[idx] = torch.cat(blocks, dim=1)
        head = torch.cat(sums, dim=1)
        buf = torch.cat([head.reshape(-1), slots.reshape(-1)])
        dist.all_reduce(buf, group=group)
        head = buf[:head.numel()].reshape(head.shape)
        slots = buf[head.numel():].reshape(slots.shape)
        out_sums, o = {}, 0
        for k, x in zip(sk, sums):
            w = x.shape[1]
            out_sums[k] = head[:, o:o + w].reshape(
                parts.sums[k].shape).to(parts.sums[k].dtype).contiguous()
            o += w
        out_stacks, o = {}, 0
        for k, x in zip(tk, blocks):
            w = x.shape[1]
            shape = parts.stacks[k].shape          # (B, rows, ...)
            out_stacks[k] = slots[:, :, o:o + w].reshape(
                (n_feat,) + shape).movedim(0, 1).reshape(
                (B, n_feat * shape[1]) + shape[2:]).contiguous()
            o += w
        return dataclasses.replace(parts, sums=out_sums, stacks=out_stacks,
                                   shards=n_feat)

    return reduce


def klt_splitter(mesh, N: int):
    """The tracker's ``klt`` over the mesh's ``feat`` axis (None where no
    frame needs it, :func:`needs_eager`): ``klt_track`` on this rank's N/feat
    slots (so K8's finish applies its own lanes' T, as each JAX shard's
    loop stops at its own), the new positions, status and errors gathered
    to all N by one ``all_reduce`` of zero-padded slots.  A ValueError
    where feat does not divide N."""
    if not needs_eager(mesh):
        return None
    _, n_shards, _, idx = mesh_axes(mesh)
    if N % n_shards:
        raise ValueError(f"num_features {N} must divide feat={n_shards}")
    n = N // n_shards
    lanes = slice(idx * n, (idx + 1) * n)

    def klt(prev_pyr, next_pyr, pos, active, **kw):
        p, status, err = klt_track(prev_pyr, next_pyr, pos[:, lanes],
                                   active[:, lanes], **kw)
        mine = torch.cat([p, status[..., None].to(p.dtype), err[..., None]],
                         dim=-1)                              # (B, n, 4)
        every = all_gather_slots(mine, mesh, "feat").movedim(0, 1).reshape(
            p.shape[0], N, 4)
        return every[..., :2], every[..., 2] != 0, every[..., 3]

    return klt
