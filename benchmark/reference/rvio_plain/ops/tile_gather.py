"""K6, K7: batched tile gathers, N (th, tw) tiles at integer origins.

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
0.60 us at 3.35 TB/s, with no arithmetic: bound by bytes, and in practice
by the latency of a launch and two dependent round trips (the origin,
then the pixels).  The tracker's one shape, 40 x 32, is specialised at
compile time: a block a tile, a lane a column (32 = a warp), each of 8
warps copies 5 rows with every load started before its first store, the
stores whole aligned 128-byte rows; a tile that cannot fit the image
(H < 40 or W < 32) takes edge-clamped addresses inside the same kernel.
Other shapes take a generic kernel, one thread a pixel.  No TMA tensor
map: the pyramid levels are new allocations every frame, so one would be
encoded on the host at every call.  A batched tracker's B images (the
segments) are one launch, a grid row an image: each tile reads its own
segment's image, and an (H, W) call is the same kernel at B = 1.

K7 (``gather_tiles_aligned``) replaces ``gather_tiles_pallas``
(``_gather_kernel``) and computes that kernel's own function, which no
caller of the JAX package's tracker reaches (its tests and ops/__init__.py
do): each origin is clamped as above, then x is aligned down to a
multiple of 128 and y to a multiple of 8 (the TPU's (8, 128) tiling), and
the tile is copied.  Its plain version is that alignment followed by K6's.
Bound by bytes: at 200 tiles of 40 x 256 f32 from one 480 x 752 frame it
writes 8.2 MB and reads the pixels its tiles cover (at most the 1.44 MB
frame), about 2.9 us at 3.35 TB/s.  Aligned origins let a thread move four
pixels with one 16-byte load and store where the tile lies inside the
image and W % 4 == 0.
"""

from __future__ import annotations

import ctypes

import torch

from benchmark.reference.rvio_plain.ops import _lib

_LIB = "tile_gather"
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5     # one image
_BATCH_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
_MAX_IMAGES = 65535     # K6's grid rows
_ALIGNED_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6


def gather_tiles_plain(img: torch.Tensor, origin: torch.Tensor, th: int,
                       tw: int) -> torch.Tensor:
    """Plain version: ``_gather_tiles`` (advanced indexing), for an (H, W)
    image and (N, 2) origins or B images (B, H, W) and (B, N, 2)."""
    if img.dim() == 2:
        return gather_tiles_plain(img[None], origin[None], th, tw)[0]
    H, W = img.shape[-2:]
    oy = torch.clamp(origin[..., 1], 0, max(H - th, 0))
    ox = torch.clamp(origin[..., 0], 0, max(W - tw, 0))
    rows = torch.clamp(oy[..., None] + torch.arange(th, device=img.device),
                       max=H - 1).long()
    cols = torch.clamp(ox[..., None] + torch.arange(tw, device=img.device),
                       max=W - 1).long()
    seg = torch.arange(img.shape[0], device=img.device)[:, None, None, None]
    return img[seg, rows[..., :, None], cols[..., None, :]]


def gather_tiles(img: torch.Tensor, origin: torch.Tensor, th: int,
                 tw: int) -> torch.Tensor:
    """(H, W) image + (N, 2) int (x, y) origins -> (N, th, tw) tiles, or B
    images (B, H, W) + (B, N, 2) origins -> (B, N, th, tw), tile (b, n)
    from image b.

    A CUDA tensor runs the kernel (f32 image, int32 origins; one launch
    for the B images, B <= 65535); a CPU tensor the plain version."""
    if not _lib.uses_kernel(img, "gather_tiles"):
        return gather_tiles_plain(img, origin, th, tw)
    batched = img.dim() == 3
    B = img.shape[0] if batched else 1
    H, W = img.shape[-2:]
    N = origin.shape[-2] if origin.dim() >= 2 else -1
    dev = img.device
    lead = (B,) if batched else ()
    _lib.check("gather_tiles", "img", img, lead + (H, W), torch.float32, dev)
    _lib.check("gather_tiles", "origin", origin, lead + (N, 2), torch.int32,
               dev)
    if B > _MAX_IMAGES:
        raise ValueError(f"gather_tiles: {B} images exceed {_MAX_IMAGES}")
    out = torch.empty(lead + (N, th, tw), dtype=torch.float32, device=dev)
    fn = _lib.function(_LIB, "rvio_gather_tiles_batch", _BATCH_ARGS)
    _lib.call(_LIB, fn, _lib.ptr(img), _lib.ptr(origin), _lib.ptr(out),
              H, W, B, N, th, tw, device=dev)
    _lib.launched(gather_tiles)
    return out


gather_tiles.launches = 0


def aligned_origins(origin: torch.Tensor, H: int, W: int, th: int,
                    tw: int) -> torch.Tensor:
    """K7's origins: clamped so the tile fits, then x aligned down to 128
    and y to 8 (origins are >= 0 after the clamp, so // floors)."""
    ox = torch.clamp(origin[:, 0], 0, max(W - tw, 0)) // 128 * 128
    oy = torch.clamp(origin[:, 1], 0, max(H - th, 0)) // 8 * 8
    return torch.stack([ox, oy], dim=1)


def gather_tiles_aligned_plain(img: torch.Tensor, origin: torch.Tensor,
                               th: int = 40, tw: int = 256) -> torch.Tensor:
    """Plain version of K7: the alignment, then K6's plain gather."""
    H, W = img.shape
    return gather_tiles_plain(img, aligned_origins(origin, H, W, th, tw),
                              th, tw)


def gather_tiles_aligned(img: torch.Tensor, origin: torch.Tensor,
                         th: int = 40, tw: int = 256) -> torch.Tensor:
    """(H, W) image + (N, 2) int (x, y) origins -> (N, th, tw) tiles at the
    origins aligned down to (128, 8) after clamping.

    A CUDA tensor runs the kernel (f32 image, int32 origins); a CPU tensor
    the plain version."""
    if not _lib.uses_kernel(img, "gather_tiles_aligned"):
        return gather_tiles_aligned_plain(img, origin, th, tw)
    H, W = img.shape
    N = origin.shape[0]
    dev = img.device
    _lib.check("gather_tiles_aligned", "img", img, (H, W), torch.float32, dev)
    _lib.check("gather_tiles_aligned", "origin", origin, (N, 2), torch.int32,
               dev)
    out = torch.empty((N, th, tw), dtype=torch.float32, device=dev)
    vec = int(W % 4 == 0 and tw % 4 == 0 and W >= tw and H >= th
              and img.data_ptr() % 16 == 0)
    fn = _lib.function(_LIB, "rvio_gather_tiles_aligned", _ALIGNED_ARGS)
    _lib.call(_LIB, fn, _lib.ptr(img), _lib.ptr(origin), _lib.ptr(out),
              H, W, N, th, tw, vec, device=dev)
    _lib.launched(gather_tiles_aligned)
    return out


gather_tiles_aligned.launches = 0
