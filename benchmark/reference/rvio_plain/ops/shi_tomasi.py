"""K12, K13: the Shi-Tomasi min-eigenvalue response, alone or fused with
the 3x3 NMS test.

K13 replaces rvio_tpu/ops/shi_tomasi.py (``shi_tomasi_nms_pallas``,
``_shi_nms_kernel``); CUDA source ``csrc/shi_tomasi_nms.cu``.  It computes
the function of the JAX package's oracle ``nms_masked_response``
(rvio_tpu/frontend/detector.py:61-84 through :29-58) on the whole map: the
Sobel/8 gradients, the 3x3 box sums of their products, the min eigenvalue,
a zeroed 2-px border, and the 8-neighbour >= test against a -inf pad, with
-inf at non-maxima.  The TPU kernel agrees with that only on
[4, H-4) x [4, W-4) (its lane rolls wrap at the edges); this one agrees
everywhere.

Bound on the H100 at the tracker's operating point (one 480 x 752 f32
level 0 per call): the function reads the image once and writes the map
once, 2 * 1.44 MB = 2.9 MB, about 0.86 us at 3.35 TB/s; its roughly 60
operations a pixel (22 MFLOP, 0.32 us at 67 TFLOP/s) weigh less, so it is
bound by bytes.  The design keeps every intermediate out of device memory
and off any barrier: a warp owns a strip of 6 output rows by 26 columns,
each lane one image column with its 12 rows in registers, the horizontal
neighbours by warp shuffles.  Each operation rounds as the plain version's
does (no fused multiply-adds), so the two agree bitwise on the same card.

K12 replaces ``shi_tomasi_pallas`` (``_shi_kernel``) and computes the
oracle ``shi_tomasi_response`` (rvio_tpu/frontend/detector.py:29-58), in
the same source and by the same strip kernel without its NMS stage: a warp
owns 4 output rows by 28 columns (a 2-px halo each side instead of 3),
each lane with its 8 image rows in registers, and stores the response
where it forms it.  It reads and writes as much as K13 (0.86 us) and is
bound by bytes too.  The TPU kernel's lane rolls wrap at the edges and the
JAX wrapper strips them; here there is nothing to strip.

K13 also takes B images of one size (B, H, W), a batched tracker's
segments: one launch, a grid row an image, each strip inside its own
image.  K12 has no tracker caller and keeps its one-image entry (B = 1 of
the same template).
"""

from __future__ import annotations

import ctypes

import torch

from benchmark.reference.rvio_plain.ops import _lib

_LIB = "shi_tomasi_nms"
_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2          # one image
_BATCH_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3    # B images
_MAX_IMAGES = 65535


def shi_tomasi_response(img: torch.Tensor, block: int = 3) -> torch.Tensor:
    """Plain version of K12: the min-eigenvalue corner response
    (cv::cornerMinEigenVal semantics), a 2-px border zeroed; any leading
    axes (B images)."""
    # imported here: the frontend package imports this module
    from benchmark.reference.rvio_plain.frontend.image import box_filter, sobel_gradients
    ix, iy = sobel_gradients(img)
    sxx = box_filter(ix * ix, block)
    sxy = box_filter(ix * iy, block)
    syy = box_filter(iy * iy, block)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))
    resp = (tr - disc) * 0.5
    H, W = img.shape[-2:]
    row = torch.arange(H, device=img.device)[:, None]
    col = torch.arange(W, device=img.device)[None, :]
    inner = (row >= 2) & (row < H - 2) & (col >= 2) & (col < W - 2)
    return torch.where(inner, resp, torch.zeros((), dtype=resp.dtype,
                                                device=resp.device))


def local_max_mask(m: torch.Tensor) -> torch.Tensor:
    """True where ``m`` is >= each of its 8 neighbours (-inf beyond), over
    the last two axes."""
    H, W = m.shape[-2:]
    mpad = torch.nn.functional.pad(m, (1, 1, 1, 1), value=float("-inf"))
    local_max = torch.ones_like(m, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            local_max &= m >= mpad[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
    return local_max


def shi_tomasi_nms_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain version: the response, then the 3x3 local-max mask."""
    m = shi_tomasi_response(img)
    return torch.where(local_max_mask(m), m,
                       torch.full((), float("-inf"), dtype=m.dtype,
                                  device=m.device))


def shi_tomasi_nms(img: torch.Tensor) -> torch.Tensor:
    """(H, W) image -> (H, W) NMS-masked response (-inf at non-maxima);
    B images (B, H, W) -> (B, H, W).

    A CUDA tensor runs the kernel (f32 only; one launch for the B images);
    a CPU tensor the plain version."""
    if not _lib.uses_kernel(img, "shi_tomasi_nms"):
        return shi_tomasi_nms_plain(img)
    if img.dim() not in (2, 3):
        raise ValueError(f"shi_tomasi_nms: img has shape {tuple(img.shape)},"
                         f" expected (H, W) or (B, H, W)")
    H, W = img.shape[-2:]
    B = img.shape[0] if img.dim() == 3 else 1
    dev = img.device
    _lib.check("shi_tomasi_nms", "img", img, tuple(img.shape), torch.float32,
               dev)
    if H < 5 or W < 5:
        raise ValueError(f"shi_tomasi_nms: image {H}x{W} under 5x5")
    if B > _MAX_IMAGES:
        raise ValueError(f"shi_tomasi_nms: {B} images exceed {_MAX_IMAGES}")
    out = torch.empty(tuple(img.shape), dtype=torch.float32, device=dev)
    fn = _lib.function(_LIB, "rvio_shi_tomasi_nms_batch", _BATCH_ARGS)
    _lib.call(_LIB, fn, _lib.ptr(img), _lib.ptr(out), B, H, W, device=dev)
    _lib.launched(shi_tomasi_nms)
    return out


shi_tomasi_nms.launches = 0


def shi_tomasi(img: torch.Tensor, block: int = 3) -> torch.Tensor:
    """(H, W) image -> (H, W) min-eigenvalue response, 2-px border zeroed.

    A CUDA tensor runs the kernel (f32, 3 x 3 block only); a CPU tensor the
    plain version."""
    if not _lib.uses_kernel(img, "shi_tomasi"):
        return shi_tomasi_response(img, block)
    H, W = img.shape
    dev = img.device
    _lib.check("shi_tomasi", "img", img, (H, W), torch.float32, dev)
    if block != 3:
        raise ValueError(f"shi_tomasi: the CUDA kernel sums 3 x 3 blocks, "
                         f"got {block}")
    if H < 5 or W < 5:
        raise ValueError(f"shi_tomasi: image {H}x{W} under 5x5")
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    fn = _lib.function(_LIB, "rvio_shi_tomasi", _ARGS)
    _lib.call(_LIB, fn, _lib.ptr(img), _lib.ptr(out), H, W, device=dev)
    _lib.launched(shi_tomasi)
    return out


shi_tomasi.launches = 0
