"""CPU tests of the facts the H100 designs of K11 and K12 rely on.

K11 (csrc/clahe.cu, ``clahe_apply_kernel``) cuts the image into the cells
between four tile centres and gives a block a chunk of one cell: APPLY_QX
quads of columns (aligned to 4, a quad on a cell's edge taken by both
cells' blocks, each storing its own columns) by APPLY_RY * APPLY_R rows,
with the cell's four LUTs staged; K12 (csrc/shi_tomasi_nms.cu,
``shi_strip_kernel`` without its NMS stage) gives a warp a strip of output
rows by 28 columns, its 32 lanes reaching 2 columns past each side.
Neither kernel runs here, so these tests read the layout constants from
the sources and hold numpy emulations of the designs against the plain
versions:

- K11: the blocks store every pixel once at five sizes (752 x 480, a
  width that is no multiple of 4, a size near the smallest a grid takes,
  g = 5 and g = 8); the four LUTs a block stages are those of every pixel
  it stores, by the plain version's tile coordinates; an f32 emulation of
  the block's arithmetic (weights by the tile coordinates' f32 formula, a
  pixel's four entries from the staged cell, the row blend with one fused
  rounding, the column blend) is bitwise ``clahe_apply_plain``;
- K12: the strips cover every output pixel once at five sizes, each with
  the 2-px halo its result needs; an f32 emulation of the strip's
  arithmetic (each operation rounded on its own, neighbours by lane
  shifts, the square root torch's) is bitwise ``shi_tomasi_response`` at
  those sizes and on a constant image;
- the library chains chip_smoke.py times beside K11 and K12 compute the
  plain versions' maps (f64).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rvio_tpu_torch.ops.checks import (_checker_frame, _texture,
                                       clahe_apply_library, shi_library)
from rvio_tpu_torch.ops.clahe import (clahe_apply_plain, clahe_luts_plain,
                                      tile_shape)
from rvio_tpu_torch.ops.shi_tomasi import shi_tomasi_response
from test_torch_k9_k13_support import _emulate_strips, _strips

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "rvio_tpu_torch" / "csrc"


def _constants(source: str) -> dict:
    """The ``constexpr int NAME = <integer>;`` lines of a CUDA source."""
    text = (CSRC / source).read_text()
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (\w+) = (\d+);", text)}


K11 = _constants("clahe.cu")
K12 = _constants("shi_tomasi_nms.cu")
QX, RY, R = K11["APPLY_QX"], K11["APPLY_RY"], K11["APPLY_R"]
LANES = np.arange(32)


# ---- K11 ----

# (H, W, g): the tracker's frame, a width that is no multiple of 4, a size
# whose pad nears the image (clahe's _check_image refuses pad >= H), the
# frame at g = 8, and a small frame at g = 8
K11_SIZES = [(480, 752, 5), (481, 753, 5), (6, 7, 5), (480, 752, 8),
             (61, 95, 8)]


def _cell_start(j: int, n: int, size: int, g: int) -> int:
    """The kernel's ``cell_start``."""
    b = j * size + size // 2
    return 0 if j <= 0 else n if j >= g or b > n else b


def _cell_chunks(j, n, size, g, unit, per) -> int:
    """The kernel's ``cell_chunks``."""
    a, b = _cell_start(j, n, size, g), _cell_start(j + 1, n, size, g)
    if b <= a:
        return 0
    return -(-((b - 1) // unit - a // unit + 1) // per)


def _find_cell(c, n, size, g, unit, per):
    """The kernel's ``find_cell``: (cell, chunk within it)."""
    j = 0
    while j < g - 1:
        k = _cell_chunks(j, n, size, g, unit, per)
        if c < k:
            break
        c -= k
        j += 1
    return j, c


def _blocks(H: int, W: int, g: int):
    """Every block of rvio_clahe_apply's grid: (jy, jx, first row, row end,
    cell columns [xa, xb), the first column of each thread's quad (QX,))
    with the rows (RY, R) its threads take."""
    th, tw = tile_shape(H, W, g)
    gx = sum(_cell_chunks(j, W, tw, g, 4, QX) for j in range(g))
    gy = sum(_cell_chunks(j, H, th, g, 1, RY * R) for j in range(g))
    for by0 in range(gy):
        jy, by = _find_cell(by0, H, th, g, 1, RY * R)
        ya = _cell_start(jy, H, th, g) + by * RY * R
        yb = min(_cell_start(jy + 1, H, th, g), ya + RY * R)
        rows = ya + np.arange(RY)[:, None] + RY * np.arange(R)[None, :]
        for bx0 in range(gx):
            jx, bx = _find_cell(bx0, W, tw, g, 4, QX)
            xa, xb = _cell_start(jx, W, tw, g), _cell_start(jx + 1, W, tw, g)
            x0 = 4 * (xa // 4 + bx * QX + np.arange(QX))
            yield jy, jx, rows, yb, xa, xb, x0


def _axis(n: int, size: int, g: int):
    """The kernel's ``tile_pair`` at every index of an axis, in f32: (t0,
    t1, w0, w1) each (n,)."""
    f = np.float32
    t = (np.arange(n).astype(f) - f((size - 1) / 2)) / f(size)
    t0f = np.minimum(np.maximum(np.floor(t), f(0)), f(g - 1))
    fr = np.minimum(np.maximum(t - t0f, f(0)), f(1))
    t0 = t0f.astype(int)
    t1 = np.minimum(t0 + 1, g - 1)
    rest = f(1) - fr
    same = t0 == t1
    return t0, t1, np.where(same, rest + fr, rest), np.where(same, f(0), fr)


def _fma32(a, b, c):
    """fmaf(a, b, c) in f32, correctly rounded: a b exact in f64, the sum
    by TwoSum, rounded to odd in f64 and then to f32 (53 >= 24 + 2)."""
    p = a.astype(np.float64) * b.astype(np.float64)
    q = c.astype(np.float64)
    s = p + q
    bb = s - p
    err = (p - (s - bb)) + (q - bb)
    odd = np.nextafter(s, np.where(err > 0, np.inf, -np.inf))
    s = np.where((err != 0) & ((s.view(np.int64) & 1) == 0), odd, s)
    return s.astype(np.float32)


def _emulate_k11(img: np.ndarray, luts: np.ndarray, g: int):
    """K11's blocks in f32: (output, times each pixel was stored)."""
    f = np.float32
    H, W = img.shape
    th, tw = tile_shape(H, W, g)
    _, _, wy0, wy1 = _axis(H, th, g)
    _, _, wx0, wx1 = _axis(W, tw, g)
    out = np.full((H, W), np.nan, f)
    hits = np.zeros((H, W), int)
    for jy, jx, rows, yb, xa, xb, x0 in _blocks(H, W, g):
        ty1, tx1 = min(jy + 1, g - 1), min(jx + 1, g - 1)
        cell = luts[[jy * g + jx, ty1 * g + jx, jy * g + tx1,
                     ty1 * g + tx1]]                       # (4, 256)
        cols = (x0[:, None] + np.arange(4)[None, :]).ravel()
        keep = (cols >= xa) & (cols < xb)
        cols = cols[keep]
        ys = rows[rows < yb]
        if not len(cols) or not len(ys):
            continue
        v = img[np.ix_(ys, cols)]
        b = np.minimum(np.maximum(v, f(0)), f(255)).astype(int)
        e = cell[:, b]                                     # (4, ny, nx)
        a0, a1 = wy0[ys][:, None], wy1[ys][:, None]
        s0 = _fma32(a1, e[1], a0 * e[0])
        s1 = _fma32(a1, e[3], a0 * e[2])
        out[np.ix_(ys, cols)] = s0 * wx0[cols] + s1 * wx1[cols]
        hits[np.ix_(ys, cols)] += 1
    return out, hits


@pytest.mark.parametrize("hwg", K11_SIZES)
def test_k11_blocks_store_each_pixel_once_from_its_tiles(hwg):
    """Every pixel stored by exactly one block, and the four LUTs that
    block stages are the pixel's own: the cell's (jy, min(jy + 1, g - 1))
    x (jx, min(jx + 1, g - 1)) equal the plain version's tile pair at the
    pixel's row and column."""
    H, W, g = hwg
    th, tw = tile_shape(H, W, g)
    ty0, ty1, _, _ = _axis(H, th, g)
    tx0, tx1, _, _ = _axis(W, tw, g)
    hits = np.zeros((H, W), int)
    for jy, jx, rows, yb, xa, xb, x0 in _blocks(H, W, g):
        assert 0 <= xa <= xb <= W
        cols = (x0[:, None] + np.arange(4)[None, :]).ravel()
        cols = cols[(cols >= xa) & (cols < xb)]
        ys = rows[rows < yb]
        hits[np.ix_(ys, cols)] += 1
        assert (ty0[ys] == jy).all() and (ty1[ys] == min(jy + 1, g - 1)).all()
        assert (tx0[cols] == jx).all() and (tx1[cols] == min(jx + 1, g - 1)
                                            ).all()
    assert (hits == 1).all()


@pytest.mark.parametrize("hwg", K11_SIZES)
def test_k11_cell_arithmetic_bitwise_with_plain(hwg):
    H, W, g = hwg
    img = _checker_frame(np.random.default_rng(H), H, W)
    # a few pixels outside [0, 255] (clamped bins) and between integers
    img[::7, ::5] = torch.linspace(-30.0, 290.5, img[::7, ::5].numel()
                                   ).reshape(img[::7, ::5].shape)
    luts = clahe_luts_plain(img, 3.0, g)
    want = clahe_apply_plain(img, luts, g).numpy()
    got, hits = _emulate_k11(img.numpy(), luts.numpy(), g)
    assert (hits == 1).all()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_k11_library_chain_is_the_same_map():
    """The library chain chip_smoke.py times beside K11 computes the plain
    version's map in f64."""
    img = _checker_frame(np.random.default_rng(0), 120, 188).double()
    luts = clahe_luts_plain(img, 3.0, 5)
    got = clahe_apply_library(img, 5)(img, luts)
    want = clahe_apply_plain(img, luts, 5)
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())


# ---- K12 ----

K12_SIZES = [(5, 5), (37, 41), (60, 94), (480, 752), (481, 753)]
HALO = 2
COLS, ROWS = K12["RESP_COLS"], K12["RESP_ROWS"]


@pytest.mark.parametrize("hw", K12_SIZES)
def test_k12_strips_cover_each_pixel_once_with_halo(hw):
    H, W = hw
    assert COLS == 32 - 2 * HALO
    hits = np.zeros((H, W), int)
    for y0, x0 in zip(*_strips(H, W, nms=False)):
        x = x0 + LANES
        lanes = (LANES >= HALO) & (LANES < HALO + COLS) & (x < W)
        ys = np.arange(y0, min(y0 + ROWS, H))
        hits[np.ix_(ys, x[lanes])] += 1
        # the loaded rows y0-2 .. y0+ROWS+1 and the warp's columns reach 2
        # past every written pixel (the response of the box sums of the
        # products of the gradients)
        assert ys.min() - 2 >= y0 - HALO and ys.max() + 2 <= y0 + ROWS + 1
        assert x[lanes].min() - 2 >= x0 and x[lanes].max() + 2 <= x0 + 31
    assert (hits == 1).all()


@pytest.mark.parametrize("case", K12_SIZES + ["constant"])
def test_k12_strip_arithmetic_bitwise_with_plain(case):
    if case == "constant":
        img = np.full((480, 752), 77.3, np.float32)
    else:
        H, W = case
        img = _texture(np.random.default_rng(H), H, W, passes=1).float()
        img = img.numpy()
    want = shi_tomasi_response(torch.as_tensor(img)).numpy()
    got = _emulate_strips(img, nms=False)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_k12_library_chain_is_the_same_map():
    """The library chain chip_smoke.py times beside K12 computes the plain
    version's map in f64."""
    img = _texture(np.random.default_rng(0), 120, 188, passes=1)
    got = shi_library(img)(img).numpy()
    want = shi_tomasi_response(img).numpy()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
