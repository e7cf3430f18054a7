"""K10, K11: CLAHE, per-tile clipped-histogram LUTs and their bilinear read.

Replaces rvio_tpu/ops/clahe.py (``_hist_call``/``_hist_kernel``, K10, and
``_apply_call``/``_apply_kernel``, K11); CUDA source ``csrc/clahe.cu``.
Both compute the function of the oracle's XLA path,
rvio_tpu/frontend/image.py:clahe (cv::createCLAHE(3.0, Size(5, 5))
semantics, reference: Tracker.cc:198-202), not the Pallas variant, which
rounds the row-blended LUT to bf16 a second time:

- reflect-pad the (H, W) image to (g th, g tw), th = ceil(H/g),
  tw = ceil(W/g), and cut it into g x g tiles;
- bin each pixel by clamp(trunc(x), 0, 255) and count an exact histogram
  per tile;
- clip at max(clip_limit * area / 256, 1), spread the excess uniformly,
  take the CDF, scale by 255 / area and round each LUT entry to bf16 once;
- blend the LUT entries of the pixel's bin over the 2 x 2 surrounding
  tiles (clamped tile indices, weights from ty = (y - (th-1)/2) / th).

The oracle selects bins and tiles with one-hot matmuls, a TPU workaround;
the plain versions here index, which gives the same values (the one-hot
dot picks the bf16 LUT entry exactly).

Bounds on the H100 at the tracker's operating point (one 480 x 752 f32
frame, g = 5: 25 tiles of 96 x 151, area 14 496): K10 reads the image
once (1.44 MB) and writes the 25 x 256 LUTs (25.6 kB), about 0.44 us at
3.35 TB/s (the check's launch also writes the histograms, as much
again).  K11 reads the image and the LUTs and writes the output, 2.9 MB,
about 0.87 us.  A few operations a pixel each, so both are bound by
bytes, and both are latency-bound in fact.  K10 runs a thread block
cluster of 8 CTAs a tile (200 CTAs at g = 5), each counting a band of
the tile's rows with a lane a column into a histogram a warp; the bands
go to the cluster's first CTA over distributed shared memory, which
clips, sums, scans and rounds: one launch where the TPU version ran a
host epilogue.  K11 cuts the image into the cells between four tile
centres, where every pixel reads the same four LUTs: a block takes a chunk
of one cell (64 columns by 32 rows), stages only those four LUTs (4 kB,
interleaved by bin, copied asynchronously under its pixel loads), and a
thread blends a quad of columns on four rows, a pixel's four entries by
one shared load (240 blocks at 752 x 480, g = 5: one wave, and no limit
on g).  Where the two would differ from these plain versions:

- the CDF: in f32 the clipped bins are multiples of 1/2048 and partial
  sums above 8192 round, so the order of the sum matters.  The plain
  version's ``torch.cumsum`` on the CPU sums in bin order in double and
  rounds each entry to f32.  Where the f32 clip limit lies on a grid
  2^-k with area 2^k < 2^24 and the clipped bins fit f32 on the same
  grid (:func:`cdf_any_order`; true at the clip limit the tracker uses at
  every image size the repo runs), every partial sum of the clipped bins
  is exact in double, so K10's parallel scan gives those sums bitwise;
  elsewhere K10 sums in bin order.  Its LUTs are bitwise those of the
  plain version on the CPU (``torch.cumsum`` on the card sums in another
  order), off the grid wherever the plain version's f32 sum of the excess
  is exact (K10 rounds the exact sum once);
- K11 follows the oracle's arithmetic: a row blend whose second product
  is fused into the sum (the oracle's CPU contraction does the same, so
  the f64 plain version is bitwise the oracle), then a column blend
  without fusion.  Every other product, sum and division rounds on its
  own (IEEE division), so K11 is bitwise with the plain version on the
  CPU (on the card PyTorch divides by a scalar through its reciprocal).

Every entry also takes B images of one size, (B, H, W) with (B, g^2, 256)
LUTs (a batched tracker's segments): one launch of each kernel for the B
images, K10 a cluster per (image, tile) and K11 a set of blocks per
(image, cell); each image's result is its one-image call's.
:func:`cdf_any_order` depends only on (limit, area), so one answer holds
for the B images.
"""

from __future__ import annotations

import ctypes
import functools
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.rvio_plain.ops import _lib

_LIB = "clahe"
# both one-image entries: three pointers, H, W, grid, two floats (then the
# stream); the batched entries (``_batch``) take B before H
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
_LUT_ARGS = _ARGS + [ctypes.c_int]     # K10 also takes cdf_any_order
_BATCH_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
_LUT_BATCH_ARGS = _BATCH_ARGS + [ctypes.c_int]
_MAX_IMAGES = 65535
KERNEL_BINS = 256
# K10's cluster: the CTAs of a tile, each counting a band of its rows, and
# the threads of each (csrc/clahe.cu CL, LUT_THREADS)
CTAS_PER_TILE = 8
LUT_THREADS = 256


def tile_shape(H: int, W: int, grid: int):
    """(th, tw): the tile size, the image's ceil-divided by the grid (OpenCV
    extends the border)."""
    return -(-H // grid), -(-W // grid)


def clip_limit_count(clip_limit: float, area: int, n_bins: int = 256) -> float:
    """The clip limit in counts, as the plain version computes it:
    max(clip_limit * area / n_bins, 1)."""
    return max(clip_limit * area / n_bins, 1.0)


@functools.lru_cache(maxsize=64)
def cdf_any_order(limit: float, area: int) -> bool:
    """True when K10 may sum the CDF in any order: the f32 ``limit`` lies
    on a grid 2^-k with area * 2^k < 2^24 and (limit + area / 256) *
    2^(k+8) < 2^24.  Then every h - c (h <= area, c = min(h, limit)) and
    the excess e are exact in f32, e / 256 and every clipped bin c + e / 256
    are multiples of 2^-(k+8) and exact in f32, and every partial sum of
    the bins (at most about area) is exact in double, whatever the order;
    so the CDF is the scan of c plus (b + 1) e / 256, bitwise."""
    lim = Fraction(float(np.float32(limit)))
    den = lim.denominator                                    # 2^k
    return (area * den < 2 ** 24
            and (lim * 256 + area) * den < 2 ** 24)


def _bins(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """clamp(trunc(x), 0, n_bins-1), computed as the truncation of the
    clamped value (the same for every finite x)."""
    return torch.clamp(x, 0, n_bins - 1).long()


def clahe_hist_plain(img: torch.Tensor, grid: int = 5,
                     n_bins: int = 256) -> torch.Tensor:
    """(grid^2, n_bins) int64 per-tile histograms of the reflect-padded
    image, tiles in row-major order; (B, grid^2, n_bins) for B images."""
    H, W = img.shape[-2:]
    lead = tuple(img.shape[:-2])
    B = img[..., 0, 0].numel()
    th, tw = tile_shape(H, W, grid)
    Hp, Wp = th * grid, tw * grid
    x = F.pad(img.reshape(B, 1, H, W), (0, Wp - W, 0, Hp - H),
              mode="reflect")[:, 0]
    rows = torch.arange(Hp, device=img.device) // th
    cols = torch.arange(Wp, device=img.device) // tw
    tile = rows[:, None] * grid + cols[None, :]
    seg = torch.arange(B, device=img.device)[:, None, None]
    key = (seg * grid * grid + tile) * n_bins + _bins(x, n_bins)
    return torch.bincount(key.reshape(-1), minlength=B * grid * grid * n_bins
                          ).reshape(lead + (grid * grid, n_bins))


def clahe_luts_plain(img: torch.Tensor, clip_limit: float = 3.0,
                     grid: int = 5, n_bins: int = 256) -> torch.Tensor:
    """(grid^2, n_bins) LUTs in the image's dtype (bf16 values);
    (B, grid^2, n_bins) for B images."""
    H, W = img.shape[-2:]
    th, tw = tile_shape(H, W, grid)
    counts = clahe_hist_plain(img, grid, n_bins)
    hist = counts.to(img.dtype)
    area = th * tw
    limit = max(clip_limit * area / n_bins, 1.0)
    clipped = torch.clamp(hist, max=limit)
    excess = (hist - clipped).sum(dim=-1, keepdim=True)
    clipped = clipped + excess / n_bins
    cdf = torch.cumsum(clipped, dim=-1)
    return (cdf * ((n_bins - 1.0) / area)).to(torch.bfloat16).to(img.dtype)


def blend_axis(n: int, size: int, grid: int, dtype, device):
    """The two tiles along one axis of ``n`` pixels (tiles of ``size``) and
    their weights, (t0, t1, w0, w1) each (n,): t = (i - (size-1)/2) / size,
    t0 = clamp(floor(t), 0, grid-1), t1 = min(t0 + 1, grid-1); where the
    clamped pair coincides, the second weight joins the first."""
    t = (torch.arange(n, dtype=dtype, device=device) - (size - 1) / 2.0) / size
    t0 = torch.clamp(torch.floor(t), 0, grid - 1)
    frac = torch.clamp(t - t0, 0.0, 1.0)
    t0 = t0.long()
    t1 = torch.clamp(t0 + 1, max=grid - 1)
    same = t0 == t1
    w0 = torch.where(same, (1 - frac) + frac, 1 - frac)
    return t0, t1, w0, torch.where(same, 0.0, frac)


def clahe_apply_plain(img: torch.Tensor, luts: torch.Tensor,
                      grid: int = 5) -> torch.Tensor:
    """(H, W): each pixel's LUT entry blended bilinearly over the 2 x 2
    surrounding tiles; (B, H, W) for B images and their (B, g^2, n_bins)
    LUTs."""
    if img.dim() == 2:
        return clahe_apply_plain(img[None], luts[None], grid)[0]
    H, W = img.shape[-2:]
    th, tw = tile_shape(H, W, grid)
    n_bins = luts.shape[-1]
    dt, dev = img.dtype, img.device
    ty0, ty1, wy0, wy1 = (x[:, None] for x in
                          blend_axis(H, th, grid, dt, dev))
    tx0, tx1, wx0, wx1 = blend_axis(W, tw, grid, dt, dev)
    b = _bins(img, n_bins)
    lut = luts.to(dt)
    seg = torch.arange(img.shape[0], device=dev)[:, None, None]

    def entry(t):
        return lut[seg, t, b]

    def rows(tj):
        """The row blend in tile column tj: wy0 v0 + wy1 v1 with the second
        product fused (torch.addcmul: one rounding), as the oracle's
        contraction rounds it."""
        return torch.addcmul(wy0 * entry(ty0 * grid + tj), wy1,
                             entry(ty1 * grid + tj))

    return rows(tx0) * wx0 + rows(tx1) * wx1


def _check_image(name: str, img: torch.Tensor, grid: int, n_bins: int):
    """Raise unless ``img`` is one (H, W) image or B of them (B, H, W)
    that the kernels take; returns (B, H, W) (B = 1 for one image)."""
    if img.dim() not in (2, 3):
        raise ValueError(f"{name}: img has shape {tuple(img.shape)}, "
                         f"expected (H, W) or (B, H, W)")
    H, W = img.shape[-2:]
    B = img.shape[0] if img.dim() == 3 else 1
    _lib.check(name, "img", img, tuple(img.shape), torch.float32, img.device)
    if B > _MAX_IMAGES:
        raise ValueError(f"{name}: {B} images exceed {_MAX_IMAGES}")
    if n_bins != KERNEL_BINS:
        raise ValueError(f"{name}: the CUDA kernel takes {KERNEL_BINS} bins, "
                         f"got {n_bins}")
    th, tw = tile_shape(H, W, grid)
    if th * grid - H >= H or tw * grid - W >= W:
        raise ValueError(f"{name}: image {H}x{W} too small for a {grid}x"
                         f"{grid} grid")
    return B, H, W


def _launch_luts(img: torch.Tensor, clip_limit: float, grid: int,
                 hist) -> torch.Tensor:
    """Launch K10 on a checked CUDA f32 image (or B of them); ``hist``:
    None, or an int32 (grid^2, 256) tensor ((B, grid^2, 256)) that receives
    the counted histograms."""
    H, W = img.shape[-2:]
    B = img.shape[0] if img.dim() == 3 else 1
    th, tw = tile_shape(H, W, grid)
    area = th * tw
    luts = torch.empty(tuple(img.shape[:-2]) + (grid * grid, KERNEL_BINS),
                       dtype=torch.float32, device=img.device)
    limit = clip_limit_count(clip_limit, area)
    fn = _lib.function(_LIB, "rvio_clahe_luts_batch", _LUT_BATCH_ARGS)
    _lib.call(_LIB, fn, _lib.ptr(img), _lib.ptr(luts),
              ctypes.c_void_p(None) if hist is None else _lib.ptr(hist), B,
              H, W, grid, limit, (KERNEL_BINS - 1.0) / area,
              int(cdf_any_order(limit, area)), device=img.device)
    _lib.launched(clahe_luts)
    return luts


def clahe_luts(img: torch.Tensor, clip_limit: float = 3.0, grid: int = 5,
               n_bins: int = 256) -> torch.Tensor:
    """(H, W) image -> (grid^2, 256) LUTs; B images (B, H, W) -> (B,
    grid^2, 256).

    A CUDA tensor runs the kernel (f32 image, 256 bins; one launch for the
    B images); a CPU tensor the plain version."""
    if not _lib.uses_kernel(img, "clahe_luts"):
        return clahe_luts_plain(img, clip_limit, grid, n_bins)
    _check_image("clahe_luts", img, grid, n_bins)
    return _launch_luts(img, clip_limit, grid, None)


def _luts_and_hist(img: torch.Tensor, clip_limit: float = 3.0,
                   grid: int = 5):
    """K10's LUTs and the int32 histograms it counted, for the kernel check
    (the tracker asks for LUTs only).  A CPU tensor: the plain versions."""
    if not _lib.uses_kernel(img, "clahe_luts"):
        return (clahe_luts_plain(img, clip_limit, grid),
                clahe_hist_plain(img, grid).int())
    _check_image("clahe_luts", img, grid, KERNEL_BINS)
    hist = torch.empty(tuple(img.shape[:-2]) + (grid * grid, KERNEL_BINS),
                       dtype=torch.int32, device=img.device)
    return _launch_luts(img, clip_limit, grid, hist), hist


def clahe_apply(img: torch.Tensor, luts: torch.Tensor,
                grid: int = 5) -> torch.Tensor:
    """(H, W) image + (grid^2, 256) LUTs -> (H, W) equalized image; B
    images (B, H, W) + (B, grid^2, 256) LUTs -> (B, H, W).

    A CUDA tensor runs the kernel (f32; one launch for the B images); a
    CPU tensor the plain version."""
    if not _lib.uses_kernel(img, "clahe_apply"):
        return clahe_apply_plain(img, luts, grid)
    B, H, W = _check_image("clahe_apply", img, grid, luts.shape[-1])
    dev = img.device
    lead = tuple(img.shape[:-2])
    _lib.check("clahe_apply", "luts", luts,
               lead + (grid * grid, KERNEL_BINS), torch.float32, dev)
    th, tw = tile_shape(H, W, grid)
    out = torch.empty(lead + (H, W), dtype=torch.float32, device=dev)
    fn = _lib.function(_LIB, "rvio_clahe_apply_batch", _BATCH_ARGS)
    _lib.call(_LIB, fn, _lib.ptr(img), _lib.ptr(luts), _lib.ptr(out), B, H,
              W, grid, (th - 1) / 2.0, (tw - 1) / 2.0, device=dev)
    _lib.launched(clahe_apply)
    return out


clahe_luts.launches = 0
clahe_apply.launches = 0
