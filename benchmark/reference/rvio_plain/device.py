"""Where the port's tensors live: the CUDA device unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; a CUDA device without CUDA raises
    (there is no silent fall back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("rvio_tpu_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' for the CPU path")
    return dev
