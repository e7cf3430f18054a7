"""The port's image front-end modules against the JAX package, f64 on the CPU.

Each port function (its plain path: CPU tensors) gets the same numpy
inputs, made from a seed, as its JAX counterpart (the XLA oracle path,
``use_pallas=False`` where the JAX function has a Pallas branch).
Tolerance: 1e-10 on values; masks, indices and slots must be identical.
CLAHE also runs in f32, against the JAX function in f32, within 1e-3 gray
(the two sum the CDF in other orders; bf16 LUT entries agree).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from rvio_tpu.frontend import detector as jdet
from rvio_tpu.frontend import image as jimg
from rvio_tpu.frontend import klt as jklt
from rvio_tpu.frontend import ransac as jran
from rvio_tpu.frontend import undistort as jund
from rvio_tpu_torch.frontend import detector as tdet
from rvio_tpu_torch.frontend import image as timg
from rvio_tpu_torch.frontend import klt as tklt
from rvio_tpu_torch.frontend import ransac as tran
from rvio_tpu_torch.frontend import undistort as tund
from rvio_tpu_torch.ops import shi_tomasi as tshi

torch.set_num_threads(1)
TOL = 1e-10
EUROC_DIST = dict(k1=-0.28340811, k2=0.07395907, p1=0.00019359,
                  p2=1.76187114e-05)


def T(x):
    return torch.as_tensor(np.array(x))


def close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=tol)


def texture(seed, h=240, w=320, sigma=2.0):
    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.uniform(0, 255, (h, w)), sigma)
    return (img - img.min()) / (img.max() - img.min()) * 255.0


def shifted_pair(seed, shift, h=240, w=320):
    """A texture and the same texture moved by ``shift`` (x, y) px."""
    base = texture(seed, h + 40, w + 40)
    img1 = base[20:20 + h, 20:20 + w]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pts = np.stack([xx + 20 - shift[0], yy + 20 - shift[1]], -1)
    img2 = timg.bilinear_sample(T(base), T(pts)).numpy()
    return img1, img2


@pytest.mark.parametrize("shape", [(240, 320), (61, 83)])
def test_image_filters(shape):
    img = texture(1, *shape)
    for name in ("scharr_gradients", "sobel_gradients"):
        for a, b in zip(getattr(jimg, name)(jnp.asarray(img)),
                        getattr(timg, name)(T(img))):
            close(b, a)
    close(timg.box_filter(T(img), 3), jimg.box_filter(jnp.asarray(img), 3))
    ref = jimg.build_pyramid(jnp.asarray(img), 3)
    got = timg.build_pyramid(T(img), 3)
    for a, b in zip(ref, got):
        assert a.shape == tuple(b.shape)
        close(b, a)


def test_bilinear_sample():
    img = texture(2, 50, 70)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-5, 75, (200, 2))
    close(timg.bilinear_sample(T(img), T(pts)),
          jimg.bilinear_sample(jnp.asarray(img), jnp.asarray(pts)))


@pytest.mark.parametrize("fisheye", [False, True])
def test_undistort(fisheye):
    rng = np.random.default_rng(4)
    intr = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                **EUROC_DIST, fisheye=fisheye)
    if fisheye:
        intr.update(k1=0.03, k2=-0.01, p1=0.002, p2=0.0005)
    xy = rng.uniform(-0.5, 0.5, (300, 2))
    px = jund.project_to_pixels(jnp.asarray(xy), **intr)
    close(tund.project_to_pixels(T(xy), **intr), px)
    close(tund.undistort_normalize(T(np.asarray(px)), **intr),
          jund.undistort_normalize(px, **intr))


def test_distort_pairs():
    rng = np.random.default_rng(5)
    xy = rng.uniform(-0.5, 0.5, (100, 2))
    ks = (0.01, -0.002, 0.001, -0.0005)
    for f in ("distort_fisheye", "undistort_fisheye"):
        close(getattr(tund, f)(T(xy), *ks), getattr(jund, f)(jnp.asarray(xy), *ks))
    for f in ("distort_radtan", "undistort_radtan"):
        close(getattr(tund, f)(T(xy), **EUROC_DIST, k3=0.01),
              getattr(jund, f)(jnp.asarray(xy), **EUROC_DIST, k3=0.01))


def _clahe_input(H, W, seed=0):
    """tests/test_ops.py's CLAHE input (blocks of noise plus pixel noise in
    [0, 255])."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(H // 8, W // 8))
    img = np.kron(base, np.ones((8, 8)))[:H, :W]
    img = (img - img.min()) / (img.max() - img.min()) * 230.0 + 10.0
    img += rng.normal(size=img.shape) * 4.0
    return np.clip(img, 0, 255)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-10), ("float32", 1e-3)])
@pytest.mark.parametrize("shape", [(480, 752), (120, 130), (440, 750)])
def test_clahe(shape, dtype, tol):
    img = _clahe_input(*shape).astype(dtype)
    ref = jimg.clahe(jnp.asarray(img), 3.0, 5, use_pallas=False)
    got = timg.clahe(T(img), 3.0, 5)
    assert got.dtype == getattr(torch, dtype)
    close(got, ref, tol=tol)
    if dtype == "float64":
        # the row blend's fused product-sum rounds as the oracle's
        # contraction does: bitwise, which the 1e-8 m images -> poses test
        # over 32 frames needs (a 1-ulp image difference reaches a KLT slot)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_shi_tomasi_response_entry():
    """The detector's public response (K12's plain path on the CPU)."""
    for seed in (6, 7):
        img = texture(seed, sigma=1.5)
        close(tdet.shi_tomasi_response(T(img)),
              jdet.shi_tomasi_response(jnp.asarray(img), use_pallas=False))


def _masks_equal(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [6, 7])
def test_shi_tomasi_and_nms(seed):
    img = texture(seed, sigma=1.5)
    close(tshi.shi_tomasi_response(T(img)),
          jdet.shi_tomasi_response(jnp.asarray(img), use_pallas=False),
          tol=1e-8)
    _masks_equal(tdet.nms_masked_response(T(img)),
                 jdet.nms_masked_response(jnp.asarray(img), use_pallas=False))


def _tie_map(seed):
    """A response map of small integers: plateaus of equal values inside
    cells and equal peaks in neighbouring cells exercise every tie-break."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 4, (96, 120)).astype(np.float64)
    m[10:14, 20:26] = 9.0        # one plateau spanning two 12 px cells
    m[40, 30] = m[40, 37] = 9.0  # equal peaks nearer than a cell
    return m


def _local_max(m):
    H, W = m.shape
    mp = np.pad(m, 1, constant_values=-np.inf)
    return np.all([m >= mp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                   for dy in (-1, 0, 1) for dx in (-1, 0, 1)], axis=0)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["texture", "ties"])
def test_grid_top_corners(seed, case):
    """On the NMS-masked map, the only form the tracker runs (the JAX
    function's ``pre_nms=True``)."""
    if case == "texture":
        img = texture(8 + seed, sigma=1.5)
        resp = np.asarray(jdet.shi_tomasi_response(jnp.asarray(img),
                                                   use_pallas=False))
        cell, k = 15, 120
    else:
        resp, cell, k = _tie_map(9 + seed), 12, 60
    resp = np.where(_local_max(resp), resp, -np.inf)
    pr, vr = jdet.grid_top_corners(jnp.asarray(resp), cell, k, 0.01,
                                   pre_nms=True)
    pg, vg = tdet.grid_top_corners(T(resp), cell, k, 0.01)
    np.testing.assert_array_equal(vg.numpy(), np.asarray(vr))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(pr))
    assert np.asarray(vr).sum() > 5


def test_corner_subpix():
    img = texture(10, sigma=1.2)
    rng = np.random.default_rng(11)
    pts = rng.uniform(2, [318, 238], (60, 2))      # border corners included
    close(tdet.corner_subpix(T(img), T(pts), win=7, iters=10),
          jdet.corner_subpix(jnp.asarray(img), jnp.asarray(pts), win=7,
                             iters=10))


def test_find_newer():
    rng = np.random.default_rng(12)
    cand = rng.uniform(0, [320, 240], (80, 2))
    cand[:5] = [[-3, 10], [330, 20], [100, 250], [0, 0], [np.nan, 5]]
    ref = rng.uniform(0, [320, 240], (40, 2))
    ref[3] = cand[20] + 2.0                  # a tracked corner too close
    cv = rng.uniform(size=80) < 0.9
    rv = rng.uniform(size=40) < 0.8
    kw = dict(img_w=320, img_h=240, block_w=80, block_h=60, min_dist=12.0,
              max_feats=40)
    ref_mask = jdet.find_newer(jnp.asarray(cand), jnp.asarray(cv),
                               jnp.asarray(ref), jnp.asarray(rv), **kw)
    got = tdet.find_newer(T(cand), T(cv), T(ref), T(rv), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_mask))
    assert 0 < got.sum() < 80


def test_tile_sampling_primitives():
    """klt's on-tile Scharr and patch sampler (K8's and K9's plain
    arithmetic), centres inside, on and beyond the tile edges."""
    rng = np.random.default_rng(17)
    tiles = rng.uniform(0, 255, (30, 40, 32))
    for a, b in zip(jklt._tile_scharr(jnp.asarray(tiles)),
                    tklt._tile_scharr(T(tiles))):
        close(b, a)
    ly = rng.uniform(-3, 42, 30)
    lx = rng.uniform(-3, 34, 30)
    for win in (15, 17):
        close(tklt._sample_patches(T(tiles), T(ly), T(lx), win),
              jklt._sample_patches(jnp.asarray(tiles), jnp.asarray(ly),
                                   jnp.asarray(lx), win))
    o = rng.integers(-30, 400, (30, 2))
    np.testing.assert_array_equal(
        tklt._align_origins(T(o), 240, 320).numpy(),
        np.asarray(jklt._align_origins(jnp.asarray(o), 240, 320)))


@pytest.mark.parametrize("shift", [(3.7, -2.4), (13.0, 8.5)])
def test_klt_track(shift):
    img1, img2 = shifted_pair(13, shift)
    rng = np.random.default_rng(14)
    pts = rng.uniform(1, [319, 239], (60, 2))        # border features too
    pts[:25] = np.stack(np.meshgrid(np.arange(40, 300, 52),
                                    np.arange(40, 220, 40)), -1).reshape(-1, 2)
    act = rng.uniform(size=60) < 0.9
    kw = dict(win=15, max_iters=30, eps=1e-2, min_eig=1e-3)
    jp = lambda x: jimg.build_pyramid(jnp.asarray(x), 3)    # noqa: E731
    tp = lambda x: timg.build_pyramid(T(x), 3)              # noqa: E731
    pr, sr, er = jklt.klt_track(jp(img1), jp(img2), jnp.asarray(pts),
                                jnp.asarray(act), **kw)
    pg, sg, eg = tklt.klt_track(tp(img1), tp(img2), T(pts), T(act), **kw)
    np.testing.assert_array_equal(sg.numpy(), np.asarray(sr))
    assert np.asarray(sr).mean() > 0.5
    close(pg, pr)
    close(eg, er)


def test_klt_track_past_31():
    """A 33 x 33 window, past what the 32-wide tile leaves room for: the
    wander bound (32 - 33) / 2 - 1 is negative, so the JAX function loses
    every feature on its first trip at the coarsest level and returns the
    level's guesses; the port's plain path (K8's plain version) loses
    every one as it does, with its positions and errors."""
    img1, img2 = shifted_pair(13, (3.7, -2.4))
    rng = np.random.default_rng(15)
    pts = rng.uniform(1, [319, 239], (60, 2))
    act = rng.uniform(size=60) < 0.9
    kw = dict(win=33, max_iters=30, eps=1e-2, min_eig=1e-3)
    jp = lambda x: jimg.build_pyramid(jnp.asarray(x), 3)    # noqa: E731
    tp = lambda x: timg.build_pyramid(T(x), 3)              # noqa: E731
    pr, sr, er = jklt.klt_track(jp(img1), jp(img2), jnp.asarray(pts),
                                jnp.asarray(act), **kw)
    pg, sg, eg = tklt.klt_track(tp(img1), tp(img2), T(pts), T(act), **kw)
    assert not np.asarray(sr).any() and not sg.numpy().any()
    close(pg, pr)
    close(eg, er)
    assert np.abs(np.asarray(er)).max() > 0       # the error is formed


def _ransac_scene(rng, n=120, outlier_frac=0.2):
    from scipy.spatial.transform import Rotation
    pts3 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                     rng.uniform(3, 10, n)], axis=1)
    R = Rotation.from_rotvec([0.02, -0.04, 0.03]).as_matrix().T
    pc2 = pts3 @ R.T + np.array([0.1, -0.05, 0.02])
    p1 = pts3 / pts3[:, 2:3]
    p2 = pc2 / pc2[:, 2:3]
    bad = rng.uniform(size=n) < outlier_frac
    p2[bad, :2] += rng.normal(size=(bad.sum(), 2)) * 0.05
    return p1, p2, R


@pytest.mark.parametrize("sampson", [True, False])
def test_gyro_ransac(sampson):
    rng = np.random.default_rng(15)
    p1, p2, R = _ransac_scene(rng)
    cand = rng.uniform(size=len(p1)) < 0.9
    thr = 1e-5 if sampson else 1e-3
    key = jax.random.key(3)
    # the JAX function draws u from its key; feed the port those draws
    u = np.asarray(jax.random.uniform(key, (len(p1),)))
    ref = jran.gyro_ransac(key, jnp.asarray(p1), jnp.asarray(p2),
                           jnp.asarray(cand), jnp.asarray(R), thr,
                           use_sampson=sampson)
    got = tran.gyro_ransac(T(u), T(p1), T(p2), T(cand), T(R), thr,
                           use_sampson=sampson)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.5 < got.numpy().mean() < np.asarray(cand).mean()
    # too few candidates: the flags pass through
    few = np.zeros_like(cand)
    few[:10] = True
    np.testing.assert_array_equal(
        tran.gyro_ransac(T(u), T(p1), T(p2), T(few), T(R), thr).numpy(), few)


def test_integrate_gyro_rotation():
    rng = np.random.default_rng(16)
    w = rng.normal(size=(16, 3)) * 0.5
    w[4] = 1e-9                                   # the small-angle branch
    dt = np.full(16, 0.005)
    valid = np.arange(16) < 11
    R_bc = np.asarray(jran.integrate_gyro_rotation(
        jnp.asarray(rng.normal(size=(1, 3))), jnp.asarray([0.3]),
        jnp.asarray([True]), jnp.eye(3), 1e-6))
    ref = jran.integrate_gyro_rotation(jnp.asarray(w), jnp.asarray(dt),
                                       jnp.asarray(valid), jnp.asarray(R_bc),
                                       1e-6)
    got = tran.integrate_gyro_rotation(T(w), T(dt), T(valid), T(R_bc), 1e-6)
    close(got, ref)
