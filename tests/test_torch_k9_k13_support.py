"""CPU tests of the facts the H100 designs of K9 and K13 rely on.

K9 (csrc/subpix_refine.cu) refines a corner in NW warps, each a band of
the window's rows: lane l takes the band's patch samples and window taps
l, l + 32, ...; K13 (csrc/shi_tomasi_nms.cu, ``shi_nms_kernel``) gives a
warp a strip of output rows by 26 columns, its 32 lanes reaching 3
columns past each side.  Neither kernel runs here, so these tests read the layout constants
from the sources and hold numpy emulations of the designs against the
plain versions:

- K9: the warps' lanes take each of the (2 win + 1)^2 taps once and
  sample the (2 win + 3)^2 patch for win = 1..7; the precomputed sample
  offsets, clipped per sample, give ``_sample_patches``'s patch at corners
  inside the tile, on its edges and drifted past it; the warp's order of
  the five sums (a lane's taps in turn, a butterfly, the warps in turn),
  in f32, stays within the check's 1e-3 px of the plain version in f64
  and, each element operation rounded as the plain version's, of the
  plain version in f32 on the check case;
- K13: the strips cover every output pixel once at five image sizes, each
  with the 3-px halo its result needs; an f32 emulation of the strip's
  arithmetic (each operation rounded on its own, neighbours by lane
  shifts, the square root torch's) is bitwise the plain version at those
  sizes and on a constant image; the library chain chip_smoke.py times
  beside K13 computes the same map (f64).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rvio_tpu_torch.ops.checks import (_texture, kernel_checks,
                                       shi_nms_library, shi_nms_case)
from rvio_tpu_torch.ops.klt_iterate import (_sample_patches,
                                            subpix_refine_plain)
from rvio_tpu_torch.ops.shi_tomasi import shi_tomasi_nms_plain

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "rvio_tpu_torch" / "csrc"


def _constants(source: str) -> dict:
    """The ``constexpr int NAME = <integer>;`` lines of a CUDA source."""
    text = (CSRC / source).read_text()
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (\w+) = (\d+);", text)}


K9 = _constants("subpix_refine.cu")
K13 = _constants("shi_tomasi_nms.cu")
MAX_WIN, NW = K9["MAX_WIN"], K9["NW"]
BAND = (2 * MAX_WIN + 1 + NW - 1) // NW               # window rows a warp
KS = ((BAND + 2) * (2 * MAX_WIN + 3) + 31) // 32      # samples a lane
KT = (BAND * (2 * MAX_WIN + 1) + 31) // 32            # taps a lane
LANES = np.arange(32)


# ---- K9 ----

def _walk(width: int, K: int):
    """The kernel's ``walk``: (row, column) of index l + 32 k in a
    row-major layout ``width`` wide, lanes l by k, by steps of 32."""
    dq, dr = divmod(32, width)
    r, c = LANES // width, LANES % width
    rows, cols = [], []
    for _ in range(K):
        rows.append(r)
        cols.append(c)
        r, c = r + dq, c + dr
        r, c = np.where(c >= width, r + 1, r), np.where(c >= width,
                                                        c - width, c)
    return np.stack(rows, 1), np.stack(cols, 1)


def _warp_layout(win: int, w: int):
    """Warp w's share of the window: its window rows [a0, a1); each lane's
    samples (patch row, column, on) (32, KS) of patch rows a0 .. a1 + 1
    and taps (window row, column, on) (32, KT) of rows [a0, a1).  A lane
    past them repeats a sample (stores nothing) or a tap (weighs 0)."""
    size = 2 * win + 1
    ps = size + 2
    band = -(-size // NW)
    a0 = min(w * band, size)
    a1 = min(a0 + band, size)
    idx_s = LANES[:, None] + 32 * np.arange(KS)[None, :]
    idx_t = LANES[:, None] + 32 * np.arange(KT)[None, :]
    s_on = idx_s < (a1 - a0 + 2) * ps
    t_on = idx_t < (a1 - a0) * size
    sy, sx = _walk(ps, KS)
    ta, tb = _walk(size, KT)
    return (a0, np.where(s_on, sy, 0) + a0, np.where(s_on, sx, 0), s_on,
            np.where(t_on, ta, 0) + a0, np.where(t_on, tb, 0), t_on)


@pytest.mark.parametrize("win", range(1, MAX_WIN + 1))
def test_k9_lanes_cover_taps_and_samples_once(win):
    """Over the NW warps every window tap is taken once; each warp samples
    the patch rows under its band once each (two rows overlap the next
    band's), and together they sample the whole patch; the division-free
    walk gives divmod's rows and columns."""
    size = 2 * win + 1
    ps = size + 2
    taps, samples = [], np.zeros((ps, ps), int)
    for w in range(NW):
        a0, sy, sx, s_on, ta, tb, t_on = _warp_layout(win, w)
        mine = sy[s_on] * ps + sx[s_on]
        assert len(np.unique(mine)) == len(mine)
        samples[sy[s_on], sx[s_on]] += 1
        taps += list(ta[t_on] * size + tb[t_on])
        # a tap's four neighbours lie in the warp's patch rows
        assert (ta[t_on] >= a0).all() and (ta[t_on] + 2 <= sy[s_on].max()).all()
    assert sorted(taps) == list(range(size * size))
    assert (samples >= 1).all()
    for width, K in ((ps, KS), (size, KT)):
        r, c = _walk(width, K)
        q, m = np.divmod(LANES[:, None] + 32 * np.arange(K)[None, :], width)
        assert np.array_equal(r, q) and np.array_equal(c, m)


def _kernel_patch(tile: np.ndarray, ly: float, lx: float, win: int):
    """The kernel's patch at tile coordinates (ly, lx), already clamped to
    the tile: each warp's lanes' samples from their precomputed (row,
    column), each sample's top-left pixel clipped to [0, TH-2] x
    [0, TW-2]; a sample two warps take is taken alike by both."""
    TH, TW = tile.shape
    ps = 2 * win + 3
    fy, fx = np.floor(ly), np.floor(lx)
    wy, wx = ly - fy, lx - fx
    patch = np.full((ps, ps), np.nan)
    for w in range(NW):
        _, sy, sx, on, _, _, _ = _warp_layout(win, w)
        i = np.clip(int(fy) - (win + 1) + sy, 0, TH - 2)
        j = np.clip(int(fx) - (win + 1) + sx, 0, TW - 2)
        r0 = tile[i, j] * (1 - wy) + tile[i + 1, j] * wy
        r1 = tile[i, j + 1] * (1 - wy) + tile[i + 1, j + 1] * wy
        v = r0 * (1 - wx) + r1 * wx
        done = ~np.isnan(patch[sy[on], sx[on]])
        assert np.array_equal(patch[sy[on], sx[on]][done], v[on][done])
        patch[sy[on], sx[on]] = v[on]
    return patch


@pytest.mark.parametrize("where", ["inside", "edge", "past"])
def test_k9_clipped_samples_match_sample_patches(where):
    """Corners inside the 40 x 32 tile, on each of its edges, and drifted
    up to 10 px past them (the kernel clamps the corner to the tile, then
    clips each sample, as subpix_system does)."""
    rng = np.random.default_rng(len(where))
    TH, TW = 40, 32
    tile = rng.uniform(0, 255, (TH, TW))
    if where == "inside":
        cy, cx = rng.uniform(9, TH - 10, 8), rng.uniform(9, TW - 10, 8)
    elif where == "edge":
        cy = np.array([0.0, TH - 1.0, 0.3, TH - 1.3, 20.5, 20.5, 0.0, TH - 1])
        cx = np.array([15.5, 15.5, 0.0, TW - 1.0, 0.2, TW - 1.2, 0.0, TW - 1])
    else:
        cy = rng.uniform(-10, TH + 9, 8)
        cx = np.where(np.arange(8) % 2, rng.uniform(-10, 0, 8),
                      rng.uniform(TW - 1, TW + 9, 8))
    ly, lx = np.clip(cy, 0, TH - 1), np.clip(cx, 0, TW - 1)
    for win in (1, 3, 5, MAX_WIN):
        want = _sample_patches(torch.as_tensor(tile)[None].expand(8, TH, TW),
                               torch.as_tensor(ly), torch.as_tensor(lx),
                               2 * win + 3).numpy()
        for n in range(8):
            got = _kernel_patch(tile, ly[n], lx[n], win)
            np.testing.assert_array_equal(got, want[n])


@pytest.fixture(scope="module")
def checks():
    return {c.name: c for c in kernel_checks("cpu")}


def _butterfly(v):
    """A warp's __shfl_xor_sync sum over axis -1 (32 lanes): lane l adds
    lane l ^ o for o = 16 .. 1; every lane ends with the same bits."""
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., LANES ^ o]
    return v[..., 0]


def _warp_refine(tiles, origin, pts, win: int, iters: int):
    """K9's loop in f32, each element operation rounded on its own as in
    the kernel: a lane's taps summed in turn, the warp's butterfly, the
    warps' sums added in warp order; the patch from
    :func:`_kernel_patch`."""
    f = np.float32
    tiles = tiles.astype(f)
    N, TH, TW = tiles.shape
    warps = []
    for w in range(NW):
        _, _, _, _, a, b, on = _warp_layout(win, w)
        oy, ox = (a - win).astype(f), (b - win).astype(f)
        sig = f(win / 2)
        wt = np.where(on, np.exp(-(ox * ox + oy * oy) / (f(2) * sig * sig)),
                      f(0)).astype(f)
        warps.append((a, b, oy, ox, wt))
    c = pts.astype(f).copy()
    of = origin.astype(f)
    for _ in range(iters):
        for n in range(N):
            ly = np.clip(c[n, 1] - of[n, 1], f(0), f(TH - 1))
            lx = np.clip(c[n, 0] - of[n, 0], f(0), f(TW - 1))
            P = _kernel_patch(tiles[n], ly, lx, win).astype(f)
            total = None
            for a, b, oy, ox, wt in warps:
                gx = (P[a + 1, b + 2] - P[a + 1, b]) * f(0.5)
                gy = (P[a + 2, b + 1] - P[a, b + 1]) * f(0.5)
                terms = [wt * gx * gx, wt * gx * gy, wt * gy * gy,
                         wt * (gx * gx * ox + gx * gy * oy),
                         wt * (gx * gy * ox + gy * gy * oy)]
                sums = []
                for term in terms:
                    lane = np.zeros(32, f)
                    for k in range(KT):
                        lane = lane + term[:, k]
                    sums.append(_butterfly(lane))
                total = sums if total is None else [
                    x + y for x, y in zip(total, sums)]
            gxx, gxy, gyy, bx, by = total
            det = gxx * gyy - gxy * gxy
            if abs(det) > f(1e-12):
                dx = (gyy * bx - gxy * by) / det
                dy = (-gxy * bx + gxx * by) / det
                c[n] += np.clip(np.array([dx, dy], f), f(-1), f(1))
    return c


def test_k9_warp_order_within_tolerance_of_f64(checks):
    """On the check case (200 corners, win 7, 10 iterations) the warp's
    f32 order stays within the check's 1e-3 px of the plain version in
    f64."""
    chk = checks["subpix_refine"]
    tiles, origin, pts = chk.args
    win, iters = chk.kwargs["win"], chk.kwargs["iters"]
    want = subpix_refine_plain(tiles.double(), origin, pts.double(),
                               win=win, iters=iters).numpy()
    got = _warp_refine(tiles.numpy(), origin.numpy(), pts.numpy(), win,
                       iters)
    assert np.abs(got - want).max() <= 1e-3


def test_k9_warp_order_within_tolerance_of_plain_f32(checks):
    """Each element operation rounded as the plain version's, the sums'
    order alone moves the check case's corners by under the check's 1e-3
    px from the plain version in f32."""
    chk = checks["subpix_refine"]
    tiles, origin, pts = chk.args
    got = _warp_refine(tiles.numpy(), origin.numpy(), pts.numpy(),
                       chk.kwargs["win"], chk.kwargs["iters"])
    assert np.abs(got - chk.run_plain().numpy()).max() <= 1e-3


# ---- K13 (the strip helpers serve K12 too: test_torch_k11_k12_support.py) --

K13_SIZES = [(5, 5), (37, 41), (60, 94), (480, 752), (481, 753)]


def _layout(nms: bool):
    """(halo, columns, rows) of a strip of ``shi_strip_kernel``: K13's, with
    the NMS stage, or K12's, without it."""
    if nms:
        return 3, K13["NMS_COLS"], K13["NMS_ROWS"]
    return 2, K13["RESP_COLS"], K13["RESP_ROWS"]


def _strips(H: int, W: int, nms: bool = True):
    """Every warp of K13's (or K12's) grid with a strip on the map: (first
    output row y0, first lane's column x0) each, as rvio_shi_tomasi_nms
    (rvio_shi_tomasi) launches it."""
    halo, cols, rows = _layout(nms)
    warps = K13["STRIP_WARPS"]
    strips_x = -(-W // cols)
    n = strips_x * -(-H // rows)
    wid = np.arange(-(-n // warps) * warps)
    sy, sx = wid // strips_x, wid % strips_x
    y0 = sy * rows
    keep = y0 < H
    return y0[keep], (sx * cols - halo)[keep]


@pytest.mark.parametrize("hw", K13_SIZES)
def test_k13_strips_cover_each_pixel_once_with_halo(hw):
    H, W = hw
    rows, cols = K13["NMS_ROWS"], K13["NMS_COLS"]
    hits = np.zeros((H, W), int)
    for y0, x0 in zip(*_strips(H, W)):
        x = x0 + LANES
        lanes = (LANES >= 3) & (LANES < 3 + cols) & (x < W)
        ys = np.arange(y0, min(y0 + rows, H))
        hits[np.ix_(ys, x[lanes])] += 1
        # the loaded rows y0-3 .. y0+rows+2 and the warp's columns reach 3
        # past every written pixel (the NMS of the response of the box
        # sums of the products of the gradients)
        assert ys.min() - 3 >= y0 - 3 and ys.max() + 3 <= y0 + rows + 2
        assert x[lanes].min() - 3 >= x0 and x[lanes].max() + 3 <= x0 + 31
    assert (hits == 1).all()


def _emulate_strips(img: np.ndarray, nms: bool = True) -> np.ndarray:
    """K13's (or K12's) strips in f32, each operation rounded on its own:
    the column sums down a lane's rows, the neighbours by lane shifts, the
    border and the NaN-propagating 3x3 maximum as the kernel takes them."""
    f = np.float32
    H, W = img.shape
    halo, cols, rows = _layout(nms)
    nr = rows + 2 * (halo - 2)                              # response rows
    y0, x0 = _strips(H, W, nms)
    S = len(y0)
    x = x0[:, None] + LANES[None, :]                                # (S, 32)
    ys = y0[:, None] + np.arange(-halo, rows + halo)[None, :]
    I = img.astype(f)[np.clip(ys, 0, H - 1)[:, :, None],
                      np.clip(x, 0, W - 1)[:, None, :]]         # (S, ., 32)

    def left(v):      # lane l - 1's value (lane 0 keeps its own)
        return np.concatenate([v[..., :1], v[..., :-1]], axis=-1)

    def right(v):     # lane l + 1's value (lane 31 keeps its own)
        return np.concatenate([v[..., 1:], v[..., -1:]], axis=-1)

    sm = (I[:, :-2] * f(0.125) + I[:, 1:-1] * f(0.25)) + I[:, 2:] * f(0.125)
    d = I[:, 2:] - I[:, :-2]
    ix = right(sm) - left(sm)
    iy = (left(d) * f(0.125) + d * f(0.25)) + right(d) * f(0.125)

    def box(p):
        cs = (p[:, :-2] + p[:, 1:-1]) + p[:, 2:]
        return (left(cs) + cs) + right(cs)

    sxx, sxy, syy = box(ix * ix), box(ix * iy), box(iy * iy)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    # the square root as the plain version takes it here: torch's CPU sqrt
    # is not always correctly rounded (1 ulp off on near-ties); on the card
    # torch.sqrt and the kernel's __fsqrt_rn both are
    disc = torch.sqrt(torch.as_tensor(np.maximum(tr * tr - f(4) * det, f(0))))
    v = (tr - disc.numpy()) * f(0.5)
    yr = y0[:, None, None] + np.arange(2 - halo, 2 - halo + nr)[None, :, None]
    xr = x[:, None, :]
    off = (yr < 0) | (yr >= H) | (xr < 0) | (xr >= W)
    border = (yr < 2) | (yr >= H - 2) | (xr < 2) | (xr >= W - 2)
    R = np.where(off, f(-np.inf), np.where(border, f(0), v))
    res = R
    if nms:
        cm = np.maximum(np.maximum(R[:, :-2], R[:, 1:-1]), R[:, 2:])
        m9 = np.maximum(np.maximum(left(cm), cm), right(cm))
        m = R[:, 1:-1]
        res = np.where(m >= m9, m, f(-np.inf))
    out = np.full((H, W), np.nan, f)
    yo = y0[:, None] + np.arange(rows)[None, :]
    for k in range(S):
        lanes = (LANES >= halo) & (LANES < halo + cols) & (x[k] < W)
        ok = yo[k] < H
        out[np.ix_(yo[k][ok], x[k][lanes])] = res[k][np.ix_(ok, lanes)]
    return out


@pytest.mark.parametrize("case", K13_SIZES + ["constant"])
def test_k13_strip_arithmetic_bitwise_with_plain(case):
    if case == "constant":
        img = np.full((480, 752), 77.3, np.float32)
    else:
        H, W = case
        img = _texture(np.random.default_rng(H), H, W, passes=1).float()
        img = img.numpy()
    want = shi_tomasi_nms_plain(torch.as_tensor(img)).numpy()
    got = _emulate_strips(img)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_k13_library_chain_is_the_same_map():
    """The library chain chip_smoke.py times beside K13 computes the plain
    version's map in f64 (in f32 its conv2d sums part by about 2e-4 of the
    response, where tr - disc cancels)."""
    img = _texture(np.random.default_rng(0), 120, 188, passes=1)
    chk = shi_nms_case("cpu", img)
    got = shi_nms_library(img)(img).numpy()
    want = chk.run_plain().numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-10 * np.abs(want).max()
