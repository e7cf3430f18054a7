"""Multi-process launch helpers.

Port of rvio_tpu/parallel/launch.py to ``torch.distributed``.  A JAX
process is one host with all its devices; a PyTorch process is one GPU
(or one CPU rank): a run on four cards is four processes, started by
``torchrun --nproc-per-node 4`` (which sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT) or by hand
(scripts/torch_multiprocess_check.py), each of which calls
:func:`initialize_distributed` and then builds the same
``parallel.mesh.make_mesh``.  The backend is the one the caller names
(NCCL on the card, gloo on the CPU; gloo also takes CUDA tensors for
``all_reduce`` and ``broadcast``) and is never switched on failure.

Typical entry point (one process per GPU):

    from rvio_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                         segment_slice)
    initialize_distributed()                      # torchrun's environment
    mesh = make_mesh(feat=2)                      # seg = world / 2
    lo, hi = segment_slice(mesh, num_segments)    # this rank's segments

:func:`host_segment_slice` slices by rank over the whole world, as the
JAX function slices by host; the sharded steps take the slice of a
rank's ``seg`` coordinate (``parallel.mesh.segment_slice``), which ranks
that differ only in ``feat`` share.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join this process to the process group (a no-op for one process,
    or when the group exists already).

    ``coordinator_address`` is ``host:port`` (TCP) or an init-method URL
    (``file:///path`` for a file store, ``tcp://host:port``); without it
    the torchrun environment (``env://``) supplies it, and also the world
    size and rank where ``num_processes`` and ``process_id`` are absent.
    ``backend`` defaults to "nccl"; with it the process takes the GPU of
    LOCAL_RANK (or of its rank modulo the GPUs).  A failed initialization
    raises."""
    if num_processes == 1 or dist.is_initialized():
        return
    backend = backend or "nccl"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = num_processes if num_processes is not None else int(
        os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)


def host_segment_slice(num_segments: int) -> Tuple[int, int]:
    """Contiguous [lo, hi) segment range owned by this rank (all of them
    without a process group)."""
    if not dist.is_initialized():
        return 0, num_segments
    n = dist.get_world_size()
    i = dist.get_rank()
    per = -(-num_segments // n)
    lo = min(i * per, num_segments)
    hi = min(lo + per, num_segments)
    return lo, hi
