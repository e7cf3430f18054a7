"""K6: batched tile gather, N (th, tw) tiles at integer origins.

Replaces rvio_tpu/ops/tile_gather.py (``gather_tiles_narrow_pallas``,
``_gather_narrow_kernel``); CUDA source ``csrc/tile_gather.cu``.  It
computes the function of the JAX package's oracle
``frontend.klt._gather_tiles``: each origin is clamped so the tile fits
the image, and rows and columns beyond the last edge-clamp.  The TPU's
128-aligned 256-wide DMA band and lane roll were there only because TPU
vector slices need aligned static offsets; they are not carried over.

Bound on the H100 at the tracker's operating point (N = 200 tiles of
40 x 32 f32 from a 480 x 752 level): the function reads the image pixels
its clamped tiles cover, once (their union: about 0.99 MB for the 200
grid-spaced tiles of ``ops/checks.py``, not the whole 1.44 MB image), and
writes the tiles once (200 * 40 * 32 * 4 B = 1.0 MB), about 2.0 MB or
0.60 us at 3.35 TB/s, with no arithmetic: bound by bytes.  The design
answers that: one thread per output pixel, neighbouring threads on
neighbouring columns of one tile row, so reads and writes coalesce; each
block reads its own tile's origin.
"""

from __future__ import annotations

import ctypes

import torch

from rvio_tpu_torch.ops import _lib

_LIB = "tile_gather"
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5


def gather_tiles_plain(img: torch.Tensor, origin: torch.Tensor, th: int,
                       tw: int) -> torch.Tensor:
    """Plain version: ``_gather_tiles`` (advanced indexing)."""
    H, W = img.shape
    oy = torch.clamp(origin[:, 1], 0, max(H - th, 0))
    ox = torch.clamp(origin[:, 0], 0, max(W - tw, 0))
    rows = oy[:, None] + torch.arange(th, device=img.device)[None, :]
    cols = ox[:, None] + torch.arange(tw, device=img.device)[None, :]
    rows = torch.clamp(rows, max=H - 1).long()
    cols = torch.clamp(cols, max=W - 1).long()
    return img[rows[:, :, None], cols[:, None, :]]


def gather_tiles(img: torch.Tensor, origin: torch.Tensor, th: int,
                 tw: int) -> torch.Tensor:
    """(H, W) image + (N, 2) int (x, y) origins -> (N, th, tw) tiles.

    A CUDA tensor runs the kernel (f32 image, int32 origins); a CPU tensor
    the plain version."""
    if not _lib.uses_kernel(img, "gather_tiles"):
        return gather_tiles_plain(img, origin, th, tw)
    H, W = img.shape
    N = origin.shape[0]
    dev = img.device
    _lib.check("gather_tiles", "img", img, (H, W), torch.float32, dev)
    _lib.check("gather_tiles", "origin", origin, (N, 2), torch.int32, dev)
    out = torch.empty((N, th, tw), dtype=torch.float32, device=dev)
    fn = _lib.function(_LIB, "rvio_gather_tiles", _ARGS)
    _lib.call(_LIB, fn, _lib.ptr(img), _lib.ptr(origin), _lib.ptr(out),
              H, W, N, th, tw, device=dev)
    gather_tiles.launches += 1
    return out


gather_tiles.launches = 0
