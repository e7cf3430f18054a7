"""What the card's K8 and K6 designs rely on, held on the CPU.

- K8 forms the template's Scharr gradients only over the support box of
  its clipped window taps: ``template_support`` (the box plus the one-pixel
  halo the gradients read) against a brute-force scan of every tap's
  pixels and their Scharr neighbourhoods, and the plain version's outputs
  bitwise unchanged when every template pixel outside that box is NaN
  (templates near each tile edge, f32 and f64).
- K6's 40 x 32 path specialises the tracker's tile at every pyramid level:
  the plain gather against the JAX oracle ``frontend.klt._gather_tiles``
  at each level of ``RVIOConfig()``, on images smaller than the tile and
  at origins past every side, bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvio_tpu.frontend.klt import _gather_tiles as jax_gather_tiles
from rvio_tpu_torch.frontend.klt import TILE, TILE_H
from rvio_tpu_torch.ops.klt_iterate import (lk_level_plain, lk_level_trips,
                                            template_support)
from rvio_tpu_torch.ops.tile_gather import gather_tiles, gather_tiles_plain

torch.set_num_threads(1)


def _reflect(k, n):
    return -k if k < 0 else (2 * n - 2 - k if k >= n else k)


def _brute_support(lx, ly, win, TH, TW):
    """Bounding box of every pixel the plain version reads to sample the
    template and its gradients at ``(lx, ly)``: each tap's clipped 2 x 2
    support, and for gradients each support pixel's 3 x 3 Scharr
    neighbourhood with the reflect pad."""
    r = win // 2
    fy, fx = int(np.floor(ly)), int(np.floor(lx))
    ys, xs = set(), set()
    for a in range(win):
        i = min(max(fy - r + a, 0), TH - 2)
        for b in range(win):
            j = min(max(fx - r + b, 0), TW - 2)
            for y in (i, i + 1):
                for x in (j, j + 1):
                    for dy in (-1, 0, 1):
                        ys.add(_reflect(y + dy, TH))
                    for dx in (-1, 0, 1):
                        xs.add(_reflect(x + dx, TW))
    return min(ys), max(ys), min(xs), max(xs)


@pytest.mark.parametrize("win", [5, 7, 15])
def test_template_support_matches_brute_force(win):
    rng = np.random.default_rng(win)
    # inside the tile, near each edge, on it, and past it
    loc = np.concatenate([
        np.stack([rng.uniform(0, TILE - 1, 40),
                  rng.uniform(0, TILE_H - 1, 40)], -1),
        np.stack([rng.uniform(-3, 3, 20), rng.uniform(-3, TILE_H + 2, 20)],
                 -1),
        np.stack([rng.uniform(TILE - 4, TILE + 2, 20),
                  rng.uniform(TILE_H - 4, TILE_H + 2, 20)], -1),
        [[0.0, 0.0], [TILE - 1.0, TILE_H - 1.0], [7.0, 7.0], [15.5, 19.5]]])
    got = [x.numpy() for x in template_support(
        torch.as_tensor(loc, dtype=torch.float32), win, TILE_H, TILE)]
    for n, (lx, ly) in enumerate(loc):
        y0, y1, x0, x1 = _brute_support(lx, ly, win, TILE_H, TILE)
        assert (got[0][n], got[1][n], got[2][n], got[3][n]) == \
            (y0, y1, x0, x1), (lx, ly)


def _texture(rng, N, H, W):
    x = torch.as_tensor(rng.uniform(0, 255, (N, 1, H + 4, W + 4)))
    for _ in range(2):
        x = torch.nn.functional.avg_pool2d(x, 3, stride=1, padding=1,
                                           count_include_pad=False)
    return x[:, 0, 2:-2, 2:-2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("edge", ["top", "bottom", "left", "right"])
@pytest.mark.parametrize("win", [5, 15])
def test_plain_ignores_pixels_outside_support(win, edge, dtype):
    """NaN in every template pixel outside ``template_support``: the plain
    version's guess, status, error and trip counts are bitwise the same."""
    rng = np.random.default_rng([win, len(edge)])
    N = 16
    t_tiles = _texture(rng, N, TILE_H, TILE).to(dtype)
    shift = torch.as_tensor(rng.uniform(-1.5, 1.5, (N, 2)), dtype=dtype)
    near = rng.uniform(0, 2, N)
    ly = {"top": near, "bottom": TILE_H - 1 - near}.get(
        edge, rng.uniform(4, TILE_H - 5, N))
    lx = {"left": near, "right": TILE - 1 - near}.get(
        edge, rng.uniform(4, TILE - 5, N))
    loc0 = torch.as_tensor(np.stack([lx, ly], -1), dtype=dtype)
    # the search tile: the template moved by a whole pixel, plus noise
    n_tiles = torch.roll(t_tiles, (1, -1), dims=(1, 2)) + torch.as_tensor(
        rng.normal(0, 2, (N, TILE_H, TILE)), dtype=dtype)
    o1 = torch.as_tensor(rng.integers(0, 100, (N, 2)), dtype=torch.int32)
    g_init = o1.to(dtype) + loc0 + shift
    status = torch.ones(N, dtype=torch.bool)
    kw = dict(win=win, max_iters=30, eps=1e-2, min_eig=1e-3,
              wander=float(TILE - win) / 2.0 - 1.0, last=True, hw=(200, 200))
    y0, y1, x0, x1 = template_support(loc0, win, TILE_H, TILE)
    rows, cols = torch.arange(TILE_H), torch.arange(TILE)
    inside = (((rows >= y0[:, None]) & (rows <= y1[:, None]))[:, :, None]
              & ((cols >= x0[:, None]) & (cols <= x1[:, None]))[:, None, :])
    assert bool((~inside).any(dim=(1, 2)).all())
    poisoned = torch.where(inside, t_tiles, torch.full_like(t_tiles, np.nan))
    want = lk_level_trips(t_tiles, n_tiles, loc0, g_init, o1, status, **kw)
    got = lk_level_trips(poisoned, n_tiles, loc0, g_init, o1, status, **kw)
    assert bool(want[1].any())
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    for x, y in zip(lk_level_plain(poisoned, n_tiles, loc0, g_init, o1,
                                   status, **kw), want[:3]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("hw", [(480, 752), (240, 376), (120, 188), (60, 94),
                                (30, 40), (24, 20)])
def test_k6_plain_matches_jax_at_every_level(hw):
    """K6's plain version (and its wrapper on a CPU tensor) against the
    JAX oracle at every pyramid level, on images smaller than the tile,
    with origins past every side: bitwise."""
    H, W = hw
    rng = np.random.default_rng(H)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    o = np.stack([rng.integers(-60, W + 60, 300),
                  rng.integers(-60, H + 60, 300)], -1).astype(np.int32)
    want = np.asarray(jax_gather_tiles(jnp.asarray(img), jnp.asarray(o),
                                       TILE_H, TILE))
    for fn in (gather_tiles_plain, gather_tiles):
        got = fn(torch.as_tensor(img), torch.as_tensor(o), TILE_H, TILE)
        np.testing.assert_array_equal(got.numpy(), want)
