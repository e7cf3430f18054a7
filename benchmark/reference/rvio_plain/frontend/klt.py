"""Batched pyramidal Lucas-Kanade optical flow on gathered tiles.

Port of ``klt_track`` in rvio_tpu/frontend/klt.py (cv::calcOpticalFlowPyrLK,
reference: src/rvio/Tracker.cc:237-244 — 15x15 window, 30 iterations, eps
1e-2, minEig 1e-3).  Per pyramid level each feature gathers a 40 x 32
template tile of the previous image and a search tile of the next one at
integer origins (K6, ``ops.tile_gather``), and one call of K8
(``ops.klt_iterate.lk_level``) runs the whole level on those tiles.

The JAX package's ``klt_track_fused`` and ``gather_edge_padded_tiles`` are
the TPU-only forms of the same function (whole-window clamping on
edge-padded tiles) and are not carried: K8 computes this oracle's function
with its borders.  ``klt_track_gather`` (a test-only cross-check) is not
ported yet.

``klt_track`` also takes B segments at once (pyramids of (B, H, W) levels,
points (B, N, 2), masks (B, N)): one K6 launch a gather and one K8 launch a
level for the batch, each segment with its own finish (its own T).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from benchmark.reference.rvio_plain.ops.klt_iterate import (  # noqa: F401  (re-exported)
    _sample_patches, _tile_scharr, _window_indices, lk_level)
from benchmark.reference.rvio_plain.ops.tile_gather import gather_tiles

TILE = 32       # search/template tile width
TILE_H = 40     # tile height: 32 + 8 slack for the 8-aligned row origin


def _align_origins(origin: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Clamp (..., 2) int xy origins in-bounds and 8-align the row
    origin."""
    oy = torch.clamp(origin[..., 1], 0, max(H - TILE_H, 0))
    oy = torch.div(oy, 8, rounding_mode="floor") * 8
    ox = torch.clamp(origin[..., 0], 0, max(W - TILE, 0))
    return torch.stack([ox, oy], dim=-1)


def tile_origins(p: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Aligned int32 origins of the tiles around pixel positions
    (..., 2)."""
    o = torch.stack([torch.round(p[..., 0]).int() - TILE // 2,
                     torch.round(p[..., 1]).int() - TILE_H // 2], dim=-1)
    return _align_origins(o, H, W)


def klt_track(prev_pyr: List[torch.Tensor], next_pyr: List[torch.Tensor],
              pts: torch.Tensor, active: torch.Tensor, *, win: int = 15,
              max_iters: int = 30, eps: float = 1e-2, min_eig: float = 1e-3
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Track points from prev to next image through the pyramid.

    pts: (N, 2) pixel coords in the full-resolution previous image;
    active: (N,) bool — inactive lanes are skipped (status False).
    Returns (new_pts (N, 2), status (N,), err (N,)); with a leading segment
    axis B on the levels, points and masks, (B, N, ...).
    """
    levels = len(prev_pyr) - 1
    dtype = pts.dtype
    r = win // 2
    wander = float(TILE - win) / 2.0 - 1.0

    guess = pts / (2.0 ** levels)
    status = active
    err = torch.zeros(pts.shape[:-1], dtype=dtype, device=pts.device)
    for lvl in range(levels, -1, -1):
        H, W = prev_pyr[lvl].shape[-2:]
        p_lvl = pts / (2.0 ** lvl)
        o0 = tile_origins(p_lvl, H, W)
        t_tiles = gather_tiles(prev_pyr[lvl], o0, TILE_H, TILE)
        loc0 = p_lvl - o0.to(dtype)
        # full window demanded in bounds only at level 0 (coarser levels
        # clamp-sample the border like OpenCV's padded pyramids)
        rb = r + 1 if lvl == 0 else 1
        inb = ((p_lvl[..., 0] > rb) & (p_lvl[..., 0] < W - rb - 1)
               & (p_lvl[..., 1] > rb) & (p_lvl[..., 1] < H - rb - 1))
        o1 = tile_origins(guess, H, W)
        n_tiles = gather_tiles(next_pyr[lvl], o1, TILE_H, TILE)
        guess, status, e = lk_level(
            t_tiles, n_tiles, loc0, guess, o1, status & inb, win=win,
            max_iters=max_iters, eps=eps, min_eig=min_eig, wander=wander,
            last=lvl == 0, hw=(H, W))
        if lvl > 0:
            guess = guess * 2.0
        else:
            err = e
    return guess, status, err
