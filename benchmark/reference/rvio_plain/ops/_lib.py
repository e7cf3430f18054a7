"""The kernel switch of the frozen copy: every operation takes its plain
PyTorch version, on any device.  Nothing here builds or loads a kernel."""

from __future__ import annotations

import torch


def uses_kernel(t: torch.Tensor, name: str) -> bool:
    """Always False: the reference runs no hand-written kernel."""
    return False


def _no_kernel(*args, **kwargs):
    raise RuntimeError("the reference runs no hand-written kernel")


function = call = ptr = check = launched = _no_kernel
