"""Image preprocessing: CLAHE, Gaussian pyramid, gradients, box sums, sampling.

Port of rvio_tpu/frontend/image.py (the reference's OpenCV preprocessing,
reference: src/rvio/Tracker.cc:183-202, and cv::calcOpticalFlowPyrLK's
internal pyramid).  Every filter is a short chain of shifted slices of a
reflect-padded image, added in the JAX package's order, so the f64 results
match it to rounding.  ``clahe`` (the equalizer) runs kernels K10 and K11
(``ops.clahe``).  The padding, the filters, ``pyr_down``, ``build_pyramid``
and ``clahe`` take (..., H, W): B images of a batched tracker at once,
each as alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.rvio_plain.ops.clahe import clahe_apply, clahe_luts


def reflect_pad(img: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    """Reflect padding without edge repeat (numpy/OpenCV BORDER_REFLECT_101)
    of the last two axes."""
    H, W = img.shape[-2:]
    lead = tuple(img.shape[:-2])
    out = F.pad(img.reshape((-1, 1, H, W)), (rx, rx, ry, ry), mode="reflect")
    return out.reshape(lead + tuple(out.shape[-2:]))


def _sep_filter(img: torch.Tensor, ky, kx) -> torch.Tensor:
    """Separable filter as shift-adds (reflect border), zero taps skipped."""
    ry, rx = len(ky) // 2, len(kx) // 2
    H, W = img.shape[-2:]
    x = reflect_pad(img, ry, rx)
    rows = None
    for i, c in enumerate(ky):
        if c == 0:
            continue
        t = x[..., i:i + H, :] * c
        rows = t if rows is None else rows + t
    out = None
    for j, c in enumerate(kx):
        if c == 0:
            continue
        t = rows[..., j:j + W] * c
        out = t if out is None else out + t
    return out


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown: 5x5 Gaussian blur + decimate by 2 (ceil sizing), the
    blur evaluated only on the even output grid."""
    k5 = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)
    H, W = img.shape[-2:]
    Ho, Wo = -(-H // 2), -(-W // 2)
    x = reflect_pad(img, 2, 2)
    rows = None
    for i, c in enumerate(k5):
        t = x[..., i:i + 2 * Ho - 1:2, :] * c
        rows = t if rows is None else rows + t
    out = None
    for j, c in enumerate(k5):
        t = rows[..., j:j + 2 * Wo - 1:2] * c
        out = t if out is None else out + t
    return out


def build_pyramid(img: torch.Tensor, levels: int):
    """List of images, level 0 = input, each subsequent halved."""
    pyr = [img]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def scharr_gradients(img: torch.Tensor):
    """(Ix, Iy) with the LK derivative filter (separable Scharr /32)."""
    sm = [3 / 32, 10 / 32, 3 / 32]
    dv = [-1.0, 0.0, 1.0]
    return _sep_filter(img, sm, dv), _sep_filter(img, dv, sm)


def sobel_gradients(img: torch.Tensor):
    """(Ix, Iy) with the Sobel /8 filter (cornerMinEigenVal's default)."""
    sm = [1 / 8, 2 / 8, 1 / 8]
    dv = [-1.0, 0.0, 1.0]
    return _sep_filter(img, sm, dv), _sep_filter(img, dv, sm)


def box_filter(img: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Unnormalized box sum (cv::boxFilter normalize=false semantics)."""
    k = [1.0] * size
    return _sep_filter(img, k, k)


def clahe(img: torch.Tensor, clip_limit: float = 3.0, grid: int = 5,
          n_bins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization
    (cv::createCLAHE(3.0, Size(5, 5)) semantics, reference:
    Tracker.cc:198-202): per-tile clipped-histogram LUTs (K10), then each
    pixel's LUT entry blended over the four surrounding tiles (K11).  Input
    in [0, 255]; output in the same range."""
    luts = clahe_luts(img, clip_limit, grid, n_bins)
    return clahe_apply(img, luts, grid)


def bilinear_sample(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation at fractional (x, y) points (..., 2);
    out-of-bounds points clamp to the border."""
    H, W = img.shape
    x = torch.clamp(pts[..., 0], 0.0, W - 1.000001)
    y = torch.clamp(pts[..., 1], 0.0, H - 1.000001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = (x - x0).to(img.dtype)
    fy = (y - y0).to(img.dtype)
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))
