"""CPU tests of the facts the H100 designs of K10 and K3 rely on.

K10 (csrc/clahe.cu, ``clahe_luts_kernel``) runs a cluster of CTAs a tile,
each counting a band of the tile's rows, and sums the CDF in parallel
where the clip limit allows it; K3 (csrc/jac_project.cu) forms the three
reflectors from Hf alone and applies Q^T column by column.  Neither
kernel runs here, so these tests hold numpy emulations of their orders
against the plain versions:

- K10: the condition the wrapper computes (``cdf_any_order``) at the
  repo's clip limit and image sizes; the kernel's scan order (a shuffle
  scan a warp, the warps' totals, plus (b + 1) e/256) in f64, bitwise
  with ``torch.cumsum`` of the plain version where the condition holds,
  and the bin-order branch where it does not; the band split of a tile's
  rows over the cluster, with the reflected padding, counting every pixel
  once against ``clahe_hist_plain``;
- K3: the column-wise order in f64 (reflectors from Hf by one round of
  sums each, r and the Hx columns reflected one by one, stored at their
  absolute clone columns) within 1e-12 of ``jac_project_plain``, at both
  compiled row bounds and their edges, t_eff = 2 and L, c0 at both ends
  of the window and a feature of rank two (Ncols = 2).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.ops import clahe as k10
from rvio_tpu_torch.ops.checks import _checker_frame, jac_inputs
from rvio_tpu_torch.ops.jac_project import KERNEL_EPS, jac_project_plain

torch.set_num_threads(1)

# image sizes (H, W) the repo runs CLAHE at: RVIOConfig() and
# configs/euroc.yaml, the tests' small config, the CLAHE tests' shapes
REPO_SIZES = [(480, 752), (240, 320), (120, 130), (440, 750)]
CLIP = 3.0          # frontend/tracker.py: clahe(img, 3.0, 5)
GRID = 5


def _limit_area(hw, clip, g=GRID):
    th, tw = k10.tile_shape(*hw, g)
    area = th * tw
    return k10.clip_limit_count(clip, area), area


# ---- K10 ----

@pytest.mark.parametrize("hw", REPO_SIZES)
def test_cdf_condition_holds_at_repo_sizes(hw):
    """At the repo's clip limit every image size takes the parallel scan:
    the f32 limit lies on a grid 2^-k with area 2^k < 2^24 and (limit +
    area/256) 2^(k+8) < 2^24."""
    limit, area = _limit_area(hw, CLIP)
    k = Fraction(float(np.float32(limit))).denominator.bit_length() - 1
    assert area * 2 ** k < 2 ** 24
    assert (limit + area / 256) * 2 ** (k + 8) < 2 ** 24
    assert k10.cdf_any_order(limit, area)


def test_cdf_condition_fails_off_the_grid():
    """A limit whose f32 value needs more bits takes the bin-order scan:
    clip 2.7 at 752 x 480 (limit 152.8875, 2^-16 grid) and 320 x 240."""
    for hw in ((480, 752), (240, 320)):
        assert not k10.cdf_any_order(*_limit_area(hw, 2.7))
    assert k10.cdf_any_order(*_limit_area((440, 750), 2.7))


def _kernel_luts(img, clip, g=GRID):
    """The kernel's finish in numpy: the f32 clip, the excess summed
    exactly and rounded once, then with the condition a scan in each warp
    of 32 bins (Hillis-Steele, f64), the warps' totals before it and
    (b + 1) e/256; without it the clipped bins summed in bin order."""
    H, W = img.shape
    th, tw = k10.tile_shape(H, W, g)
    area = th * tw
    limit = np.float32(k10.clip_limit_count(clip, area))
    hist = k10.clahe_hist_plain(img, g).numpy().astype(np.float32)
    c = np.minimum(hist, limit)
    excess = (hist - c).astype(np.float64).sum(axis=1).astype(np.float32)
    share = (excess / np.float32(256)).astype(np.float32)[:, None]
    if k10.cdf_any_order(float(limit), area):
        s = c.astype(np.float64).reshape(-1, 8, 32).copy()
        o = 1
        while o < 32:
            s[..., o:] = s[..., o:] + s[..., :-o].copy()
            o *= 2
        pre = np.concatenate([np.zeros((len(s), 1)),
                              np.cumsum(s[..., 31], axis=1)[:, :-1]], axis=1)
        cdf = (pre[..., None] + s).reshape(-1, 256) + \
            np.arange(1, 257) * share.astype(np.float64)
    else:
        cdf = np.cumsum((c + share).astype(np.float32).astype(np.float64),
                        axis=1)
    v = cdf.astype(np.float32) * np.float32(255.0 / area)
    return torch.as_tensor(v).to(torch.bfloat16).float(), excess


def _frames(hw, n_random=2):
    rng = np.random.default_rng(hw[0] * 7 + hw[1])
    yield _checker_frame(rng, *hw)
    for _ in range(n_random):
        yield torch.as_tensor(rng.uniform(-20, 280, hw), dtype=torch.float32)
    yield torch.full(hw, 77.3)


@pytest.mark.parametrize("hw", REPO_SIZES + [(750, 440)])
def test_scan_order_is_bitwise_the_plain_cumsum(hw):
    """On the condition's grid the kernel's scan order gives the plain
    version's LUTs bitwise: the checker frame, random frames, a constant
    frame, at clip 3.0 and 2.0."""
    for img in _frames(hw):
        for clip in (CLIP, 2.0):
            assert k10.cdf_any_order(*_limit_area(hw, clip))
            got, _ = _kernel_luts(img, clip)
            assert torch.equal(got, k10.clahe_luts_plain(img, clip))


@pytest.mark.parametrize("hw", [(480, 752), (240, 320)])
def test_bin_order_branch(hw):
    """Off the grid (clip 2.7) the kernel sums the clipped bins in bin
    order, as torch.cumsum does: its LUTs are the plain version's on every
    tile whose f32 excess the plain version sums exactly (its f32 sum may
    round elsewhere; the kernel rounds the exact sum once)."""
    for img in _frames(hw):
        got, excess = _kernel_luts(img, 2.7)
        want = k10.clahe_luts_plain(img, 2.7)
        th, tw = k10.tile_shape(*hw, GRID)
        hist = k10.clahe_hist_plain(img, GRID).float()
        plain_excess = (hist - torch.clamp(
            hist, max=k10.clip_limit_count(2.7, th * tw))).sum(dim=1)
        same = torch.as_tensor(excess) == plain_excess
        assert bool(same.any())
        assert torch.equal(got[same], want[same])


def _band_pixels(H, W, g=GRID):
    """The (tile, row, column) every thread of every CTA of K10 reads, as
    csrc/clahe.cu maps them: CTA rank r of a tile's cluster the rows
    [r0, r1), r0 = r ceil(th / CL); thread tid on column c and row phase rp
    (several phases for tiles narrower than the block, column passes for
    wider ones), rows r0 + rp + j nph; the padded rows and columns read
    from their reflections."""
    CL, NT = k10.CTAS_PER_TILE, k10.LUT_THREADS
    th, tw = k10.tile_shape(H, W, g)
    tid = np.arange(NT)
    if tw < NT:
        nph, rp, c = NT // tw, tid // tw, tid % tw
        passes = 1
    else:
        nph, rp, c = 1, np.zeros(NT, int), tid
        passes = -(-tw // NT)
    bh = -(-th // CL)
    out = []
    for rank in range(CL):
        r0 = min(th, rank * bh)
        r1 = min(th, r0 + bh)
        steps = -(-(r1 - r0) // nph)
        for pas in range(passes):
            cc = c + pas * NT
            for j in range(steps):
                rr = r0 + rp + j * nph
                ok = (rp < nph) & (cc < tw) & (rr < r1)
                out.append(np.stack([rr[ok], cc[ok]], 1))
    return np.concatenate(out), th, tw


def _reflect(i, n):
    return np.where(i < n, i, 2 * (n - 1) - i)


@pytest.mark.parametrize("hw", [(480, 752), (240, 320), (750, 440),
                                (130, 120), (120, 130), (20, 1400)])
def test_band_split_counts_every_pixel_once(hw):
    """The cluster's bands cover each tile's th x tw pixels once each
    (tiles of 88 columns take two row phases, of 24-26 columns nine or
    ten, of 280 two column passes; tiles of 4 rows leave CTAs without a
    band), and the reflected reads count the plain version's histograms."""
    H, W = hw
    rc, th, tw = _band_pixels(H, W)
    seen = np.zeros((th, tw), int)
    np.add.at(seen, (rc[:, 0], rc[:, 1]), 1)
    assert (seen == 1).all()
    img = next(_frames(hw))
    x = img.numpy()
    bins = np.clip(x, 0, 255).astype(np.int64)
    hist = np.zeros((GRID * GRID, 256), np.int64)
    for p in range(GRID):
        for q in range(GRID):
            y = _reflect(p * th + rc[:, 0], H)
            xx = _reflect(q * tw + rc[:, 1], W)
            np.add.at(hist[p * GRID + q], bins[y, xx], 1)
    assert np.array_equal(hist, k10.clahe_hist_plain(img, GRID).numpy())


# ---- K3 ----

def _safe(zv, eps):
    return np.where(np.abs(zv) < eps, np.where(zv < 0, -eps, eps), zv)


def _k3_columns(z, Rcl, tcl, Rrl, trl, Rcr, tcr, phi, psi, rho, t_eff, c0,
                R_bc, t_bc, M, eps=KERNEL_EPS):
    """K3's order in f64: Hf a measurement at a time; the three reflectors
    from Hf alone, one round of sums each (||x||^2 and x . A_c; ||v||^2 =
    2 (||x||^2 - alpha x_k), v . A_c = x . A_c - alpha A_kc); then r and
    every output column of Hx on its own (built from the left factors and
    its subH column, reflected, masked) at its absolute clone column."""
    F, L = z.shape[:2]
    R2, XC = 2 * L, 6 * M
    rows = np.arange(R2)
    r_out = np.zeros((F, R2))
    hx = np.zeros((F, R2, XC))
    hfn = np.zeros(F)
    for f in range(F):
        te, c0f = min(int(t_eff[f]), L), int(c0[f])
        sp, cp, ss, cs = (np.sin(phi[f]), np.cos(phi[f]), np.sin(psi[f]),
                          np.cos(psi[f]))
        epf = np.array([cp * ss, sp, cp * cs])
        Ja = np.array([[-sp * ss, cp * cs], [cp, 0.0], [-sp * cs, -cp * ss]])
        A = np.zeros((R2, 3))
        res = np.zeros(R2)
        left = np.zeros((L, 2, 3))
        for l in range(L):
            h = Rcl[f, l] @ epf + rho[f] * tcl[f, l]
            zi = 1.0 / _safe(h[2], eps)
            Hp = np.array([[zi, 0, -h[0] * zi * zi], [0, zi, -h[1] * zi * zi]])
            left[l] = Hp @ R_bc.T @ Rrl[f, l]
            if l < te:
                A[2 * l:2 * l + 2, :2] = Hp @ Rcl[f, l] @ Ja
                if l > 0:
                    A[2 * l:2 * l + 2, 2] = Hp @ tcl[f, l]
                hr = Rcr[f, l] @ epf + rho[f] * tcr[f, l]
                res[2 * l:2 * l + 2] = z[f, l] - hr[:2] / _safe(hr[2], eps)
        hfn[f] = np.sqrt(np.sum(A[:, 2] ** 2))
        vs, betas = [], []
        for k in range(3):
            x = np.where(rows >= k, A[:, k], 0.0)
            sxx = x @ x
            normx = np.sqrt(sxx)
            alpha = -normx if A[k, k] >= 0 else normx
            vnorm2 = 2.0 * (sxx - alpha * A[k, k])
            beta = 2.0 / vnorm2 if vnorm2 > 1e-30 else 0.0
            v = x.copy()
            v[k] -= alpha
            for c in range(k + 1, 3):
                w = x @ A[:, c] - alpha * A[k, c]
                A[:, c] -= beta * v * w
            vs.append(v)
            betas.append(beta)
        ncols = 2 if hfn[f] < 1e-4 else 3
        keep = (rows >= ncols) & (rows < 2 * te)

        def reflect(col):
            for v, beta in zip(vs, betas):
                col = col - beta * v * (v @ col)
            return np.where(keep, col, 0.0)

        r_out[f] = reflect(res)
        pb = R_bc @ epf + rho[f] * t_bc
        for oc in range(XC):
            jj, b = oc // 6 - c0f, oc % 6
            if jj < 0 or jj > te - 2:
                continue
            Rj, tj, Rp = Rrl[f, jj + 1], trl[f, jj + 1], Rrl[f, jj]
            if b < 3:
                w = pb + rho[f] * (Rj.T @ tj)
                dpx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                                [-w[1], w[0], 0]])
                s3 = dpx @ Rj[b]
            else:
                s3 = -rho[f] * Rp[b - 3]
            col = np.zeros(R2)
            for i in range(jj + 1, te):
                col[2 * i:2 * i + 2] = left[i] @ s3
            hx[f, :, oc] = reflect(col)
    return r_out, hx, hfn


@pytest.mark.parametrize("L", [2, 15, 16, 17, 64])
def test_column_order_matches_plain(L):
    """The column-wise order equals jac_project_plain within 1e-12 in f64,
    for t_eff = 2 and t_eff = L, c0 at 0 and at M - t_eff + 1 (M = L - 1
    clones, as RVIOConfig() has), and a feature seen from one camera
    centre (||Hf[:, rho]|| = 0: Ncols = 2)."""
    M = max(L - 1, 2)
    F = 6
    t_eff = np.array([2, L, 2, L, L, L])
    c0 = np.array([0, 0, M - 1, M - L + 1, 0, 0]).clip(0)
    inputs = jac_inputs(RVIOConfig(), np.random.default_rng(L), F, L, M,
                        t_eff, c0)
    inputs[2] = inputs[2].copy()
    inputs[2][5] = 0.0                     # tc = 0: a rank-two feature
    *arrays, _ = inputs
    got = _k3_columns(*arrays, M)
    t = [torch.as_tensor(np.asarray(x)) for x in arrays]
    want = jac_project_plain(*t[:10], t[10], t[11], t[12], t[13], M,
                             eps=KERNEL_EPS)
    assert got[2][5] < 1e-4 <= got[2][:5].min()
    for g, w in zip(got, want):
        assert np.abs(g - w.numpy()).max() <= 1e-12
