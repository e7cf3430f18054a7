"""Shi-Tomasi corner detection with grid-based selection + subpixel refine.

Port of rvio_tpu/frontend/detector.py (FeatureDetector, reference:
src/rvio/FeatureDetector.cc, and the cv::goodFeaturesToTrack +
cv::cornerSubPix pair it wraps):

- the min-eigenvalue response (K12) and its NMS-masked form (K13), both
  in ``ops.shi_tomasi``;
- per-cell argmax over a minDist grid plus suppression by stronger
  neighbours, with the JAX package's tie-breaks (earliest row, then
  earliest column inside a cell; the lower flat index between equal
  peaks; a stable sort by score);
- batched cornerSubPix on 40 x 32 tiles (K6 then K9);
- FindNewer admission by chess-grid block occupancy and distances.

Each function also takes a leading segment axis B (a batched tracker's
images, points and masks): every threshold, ranking and count is then per
segment, as the JAX package's vmapped tracker computes them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.rvio_plain.frontend.klt import TILE, TILE_H, tile_origins
from benchmark.reference.rvio_plain.ops.klt_iterate import subpix_refine
from benchmark.reference.rvio_plain.ops.shi_tomasi import shi_tomasi, shi_tomasi_nms
from benchmark.reference.rvio_plain.ops.tile_gather import gather_tiles

_NINF = float("-inf")


def shi_tomasi_response(img: torch.Tensor, block: int = 3) -> torch.Tensor:
    """Min-eigenvalue corner response (cv::cornerMinEigenVal semantics), a
    2-px border zeroed: K12 on the card (f32, ``block`` 3), the plain
    version on the CPU.  The tracker reaches the response only through
    :func:`nms_masked_response`."""
    return shi_tomasi(img, block)


def nms_masked_response(img: torch.Tensor) -> torch.Tensor:
    """3x3-local-max-masked Shi-Tomasi response (-inf at non-maxima)."""
    return shi_tomasi_nms(img)


def grid_top_corners(resp: torch.Tensor, cell: int, max_corners: int,
                     quality_level: float, border: int = 4
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spaced corner selection: per-cell argmax + stronger-neighbour NMS.

    Keeps each (cell x cell) tile's peak if it clears the quality threshold
    and beats every peak within ``cell`` px in the 8 neighbouring tiles
    (ties to the lower flat index).  Returns (pts (K, 2) xy, valid (K,))
    sorted by response, strongest first, K = min(max_corners, cells).
    ``resp`` is :func:`nms_masked_response`'s map (-inf at non-maxima),
    the JAX function's ``pre_nms=True`` form, the only one the tracker
    runs.
    """
    if resp.dim() == 2:
        pts, valid = grid_top_corners(resp[None], cell, max_corners,
                                      quality_level, border)
        return pts[0], valid[0]
    B, H, W = resp.shape
    dev = resp.device
    ninf = torch.full((), _NINF, dtype=resp.dtype, device=dev)
    m = resp
    # each image's own maximum
    thr = quality_level * torch.amax(m, dim=(1, 2), keepdim=True)
    cand = torch.where(m > thr, m, ninf)
    row = torch.arange(H, device=dev)[:, None]
    col = torch.arange(W, device=dev)[None, :]
    inb = ((row >= border) & (row < H - border)
           & (col >= border) & (col < W - border))
    cand = torch.where(inb, cand, ninf)

    gh, gw = H // cell, W // cell
    crop = cand[:, :gh * cell, :gw * cell]
    # separable per-cell argmax: first maximum along the cell's columns of
    # each row, then the first row holding the cell maximum (the row-major
    # flat argmax)
    c3 = crop.reshape(B, gh * cell, gw, cell)
    colmax = torch.amax(c3, dim=3)
    argcol = torch.argmax(c3, dim=3)
    r3 = colmax.reshape(B, gh, cell, gw)
    best_val = torch.amax(r3, dim=2).reshape(B, -1)
    argrow = torch.argmax(r3, dim=2)                       # (B, gh, gw)
    acr = torch.gather(argcol.reshape(B, gh, cell, gw), 2,
                       argrow[:, :, None, :])[:, :, 0, :]
    by = (argrow + torch.arange(gh, device=dev)[:, None] * cell).reshape(B, -1)
    bx = (acr + torch.arange(gw, device=dev)[None, :] * cell).reshape(B, -1)
    pts = torch.stack([bx, by], dim=-1).to(resp.dtype)

    # suppression by stronger peaks within `cell` px in neighbouring tiles
    keep = best_val > _NINF
    val_grid = best_val.reshape(B, gh, gw)
    y_grid = by.reshape(B, gh, gw)
    x_grid = bx.reshape(B, gh, gw)
    vpad = F.pad(val_grid, (1, 1, 1, 1), value=_NINF)
    ypad = F.pad(y_grid, (1, 1, 1, 1))
    xpad = F.pad(x_grid, (1, 1, 1, 1))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nv = vpad[:, 1 + dy:1 + dy + gh, 1 + dx:1 + dx + gw]
            ny = ypad[:, 1 + dy:1 + dy + gh, 1 + dx:1 + dx + gw]
            nx = xpad[:, 1 + dy:1 + dy + gh, 1 + dx:1 + dx + gw]
            d2 = ((y_grid - ny) ** 2 + (x_grid - nx) ** 2).to(resp.dtype)
            stronger = (nv > val_grid) | ((nv == val_grid)
                                          & ((ny * W + nx) < (y_grid * W + x_grid)))
            conflict = (d2 < cell * cell) & stronger & (nv > _NINF)
            keep &= ~conflict.reshape(B, -1)

    score = torch.where(keep, best_val, ninf)
    order = torch.argsort(-score, dim=1, stable=True)
    sel = order[:, :min(max_corners, pts.shape[1])]
    return (torch.gather(pts, 1, sel[:, :, None].expand(-1, -1, 2)),
            torch.gather(score, 1, sel) > _NINF)


def corner_subpix(img: torch.Tensor, pts: torch.Tensor, win: int = 7,
                  iters: int = 10) -> torch.Tensor:
    """Batched cv::cornerSubPix (gradient-product centroid iteration) on
    40 x 32 tiles gathered once at the corners' aligned origins.

    win: half-window (the reference uses floor(minDist/2) = 7, a 15x15
    window, FeatureDetector.cc:68).  B images (B, H, W) and corners
    (B, K, 2): each corner's tile from its own image (one K6 launch), then
    the B·K corners as rows of one K9 launch."""
    H, W = img.shape[-2:]
    o = tile_origins(pts, H, W)
    tiles = gather_tiles(img, o, TILE_H, TILE)
    if img.dim() == 2:
        return subpix_refine(tiles, o, pts, win=win, iters=iters)
    B, K = pts.shape[:2]
    return subpix_refine(tiles.reshape(B * K, TILE_H, TILE),
                         o.reshape(B * K, 2), pts.reshape(B * K, 2), win=win,
                         iters=iters).reshape(B, K, 2)


def find_newer(cand_pts: torch.Tensor, cand_valid: torch.Tensor,
               ref_pts: torch.Tensor, ref_valid: torch.Tensor, *,
               img_w: int, img_h: int, block_w: int, block_h: int,
               min_dist: float, max_feats: int) -> torch.Tensor:
    """Admission mask for new corners (reference FindNewer semantics,
    FeatureDetector.cc:97-150): a candidate is admitted iff its chess-grid
    block stays under 75 % of the per-block budget, it is >= min_dist from
    every tracked corner in that block, and >= min_dist from the block
    borders.  With a leading segment axis on every argument, each
    segment's candidates meet its own tracked corners and blocks."""
    if cand_pts.dim() == 2:
        return find_newer(cand_pts[None], cand_valid[None], ref_pts[None],
                          ref_valid[None], img_w=img_w, img_h=img_h,
                          block_w=block_w, block_h=block_h,
                          min_dist=min_dist, max_feats=max_feats)[0]
    gw = img_w // block_w
    gh = img_h // block_h
    offx = 0.5 * (img_w - gw * block_w)
    offy = 0.5 * (img_h - gh * block_h)
    max_per_block = max_feats / (gw * gh)
    n_blocks = gw * gh

    def block_of(pts):
        bx = torch.floor((pts[..., 0] - offx) / block_w).long()
        by = torch.floor((pts[..., 1] - offy) / block_h).long()
        inside = ((pts[..., 0] > offx) & (pts[..., 1] > offy)
                  & (pts[..., 0] < img_w - offx)
                  & (pts[..., 1] < img_h - offy)
                  & (bx >= 0) & (bx < gw) & (by >= 0) & (by < gh))
        return by * gw + bx, inside

    blocks = torch.arange(n_blocks, device=cand_pts.device)

    def one_hot(idx, on):
        oh = torch.clamp(idx, 0, n_blocks - 1)[..., None] == blocks
        return oh.float() * on[..., None].float()

    cb, c_in = block_of(cand_pts)
    rb, r_in = block_of(ref_pts)
    rb = torch.where(ref_valid & r_in, rb, torch.full_like(rb, -1))
    occ = torch.sum(one_hot(rb, rb >= 0), dim=1)          # tracked per block

    d2 = torch.sum((cand_pts[:, :, None, :] - ref_pts[:, None, :, :]) ** 2,
                   dim=-1)
    same_block = (cb[:, :, None] == rb[:, None, :]) & (rb >= 0)[:, None, :]
    too_close = torch.any(same_block & (d2 <= min_dist ** 2), dim=2)

    bxf = torch.floor((cand_pts[..., 0] - offx) / block_w)
    byf = torch.floor((cand_pts[..., 1] - offy) / block_h)
    xl = bxf * block_w + offx
    yt = byf * block_h + offy
    near_border = ((torch.abs(cand_pts[..., 0] - xl) < min_dist)
                   | (torch.abs(cand_pts[..., 0] - (xl + block_w)) < min_dist)
                   | (torch.abs(cand_pts[..., 1] - yt) < min_dist)
                   | (torch.abs(cand_pts[..., 1] - (yt + block_h)) < min_dist))

    # rank candidates per block; admit while the block stays under 75 % of
    # its budget (occupancy + prior admits in the block < cap)
    cand_ok = cand_valid & c_in & ~too_close & ~near_border
    cb_safe = torch.clamp(cb, 0, n_blocks - 1)
    onehot = one_hot(cb, cand_ok)
    rank = torch.cumsum(onehot, dim=1) - onehot
    my_rank = torch.gather(rank, 2, cb_safe[..., None])[..., 0]
    under_cap = (torch.gather(occ, 1, cb_safe) + my_rank) < 0.75 * max_per_block
    return cand_ok & under_cap
