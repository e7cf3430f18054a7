"""The image kernels' plain versions against the JAX package's Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as tests/test_ops.py
runs them.  They compute the TPU's variant of each function, so each check
holds only where that variant agrees with the oracle the port follows:

- K6 tile gather: exact, at origins the TPU kernel takes (8-aligned rows,
  columns inside its 256-wide DMA band);
- K13 response + NMS: on [4, H-4) x [4, W-4) in f64 on a smoothed image,
  values to rel 1e-10 and the -inf masks equal (the Pallas and XLA
  responses differ in summation order, tests/test_ops.py:583-587);
- K9 subpix: within tests/test_ops.py:141-144's 1e-3 px median and
  0.15 px max (the TPU kernel samples edge-padded 56 x 48 tiles);
- K8 LK level, through ``klt_track_fused(interpret=True)`` on interior
  features, within tests/test_frontend.py:242-252's tolerances (status
  agreeing on > 95 %, positions and err within 0.01 where both live);
- K10 + K11 CLAHE: the port's ``clahe`` within tests/test_ops.py:147-179's
  0.75 gray of ``clahe_pallas(interpret=True)`` (the Pallas variant rounds
  its row-blended LUT to bf16 a second time), and K10's histograms equal
  to numpy's per tile;
- K12 response: within tests/test_ops.py:228-236's rtol 2e-4, atol 2e-2
  of ``shi_tomasi_pallas(interpret=True)`` (f32, summation order);
- K7 aligned gather: exact, edge clamping included.

Each also checks that the wrapper, on a CPU tensor, is its plain version.
"""

import jax.numpy as jnp
import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from rvio_tpu.frontend.image import build_pyramid as jax_pyramid
import pytest

from rvio_tpu.frontend.klt import klt_track_fused
from rvio_tpu.ops.clahe import clahe_pallas
from rvio_tpu.ops.klt_iterate import subpix_refine_pallas
from rvio_tpu.ops.shi_tomasi import shi_tomasi_nms_pallas, shi_tomasi_pallas
from rvio_tpu.ops.tile_gather import (gather_tiles_narrow_pallas,
                                      gather_tiles_pallas)
from rvio_tpu_torch.frontend.detector import (corner_subpix,
                                              shi_tomasi_response)
from rvio_tpu_torch.frontend.image import (bilinear_sample, build_pyramid,
                                           clahe)
from rvio_tpu_torch.frontend.klt import klt_track
from rvio_tpu_torch.ops import clahe as kclahe
from rvio_tpu_torch.ops import shi_tomasi, tile_gather

torch.set_num_threads(1)


def texture(seed, h=240, w=320, sigma=1.0):
    return gaussian_filter(np.random.default_rng(seed).uniform(0, 255, (h, w)),
                           sigma)


def test_k6_gather_matches_pallas():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (96, 640)).astype(np.float32)
    orig = rng.integers(0, 300, (31, 2)).astype(np.int32)
    orig[:, 1] = (np.clip(orig[:, 1], 0, 96 - 40) // 8) * 8
    orig[:, 0] = np.clip(orig[:, 0], 0, 640 - 256)
    ref = np.asarray(gather_tiles_narrow_pallas(jnp.asarray(img),
                                                jnp.asarray(orig), th=40,
                                                tw=32, interpret=True))
    got = tile_gather.gather_tiles_plain(torch.as_tensor(img),
                                         torch.as_tensor(orig), 40, 32)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the oracle's clamping at and beyond the edges, through the wrapper
    edge = torch.as_tensor([[-20, -16], [900, 500], [630, 90]], dtype=torch.int32)
    tiles = tile_gather.gather_tiles(torch.as_tensor(img), edge, 40, 32)
    np.testing.assert_array_equal(tiles[0].numpy(), img[0:40, 0:32])
    np.testing.assert_array_equal(tiles[1].numpy(), img[56:96, 608:640])
    assert torch.equal(tiles, tile_gather.gather_tiles_plain(
        torch.as_tensor(img), edge, 40, 32))


def test_k13_nms_matches_pallas_interior():
    img = texture(3, sigma=1.5)
    ref = np.asarray(shi_tomasi_nms_pallas(jnp.asarray(img), interpret=True))
    got = shi_tomasi.shi_tomasi_nms(torch.as_tensor(img)).numpy()
    assert np.array_equal(got, shi_tomasi.shi_tomasi_nms_plain(
        torch.as_tensor(img)).numpy())
    a, b = got[4:-4, 4:-4], ref[4:-4, 4:-4]
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(b)
    assert 50 < fin.sum() < fin.size // 4
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-10, atol=0)


def test_k9_subpix_matches_pallas():
    img = texture(9)
    rng = np.random.default_rng(9)
    pts = np.stack(np.meshgrid(np.arange(40, 280, 24), np.arange(40, 200, 24)),
                   -1).reshape(-1, 2).astype(np.float64)
    pts += rng.uniform(-0.4, 0.4, pts.shape)
    ref = np.asarray(subpix_refine_pallas(jnp.asarray(img), jnp.asarray(pts),
                                          win=7, interpret=True))
    got = corner_subpix(torch.as_tensor(img), torch.as_tensor(pts), win=7,
                        iters=10).numpy()
    d = np.abs(got - ref)
    assert np.median(d) < 1e-3
    assert d.max() < 0.15


def test_k8_lk_level_matches_fused_pallas():
    h, w, shift = 240, 320, (3.7, 2.4)
    base = texture(21, h + 20, w + 20, sigma=2.0)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    src = np.stack([xx + 10 - shift[0], yy + 10 - shift[1]], -1)
    img1 = base[10:10 + h, 10:10 + w]
    img2 = bilinear_sample(torch.as_tensor(base), torch.as_tensor(src)).numpy()
    pts = np.stack(np.meshgrid(np.arange(90, 240, 16), np.arange(90, 160, 16)),
                   -1).reshape(-1, 2).astype(np.float64)
    act = np.ones(len(pts), bool)
    pr, sr, er = klt_track_fused(jax_pyramid(jnp.asarray(img1), 3),
                                 jax_pyramid(jnp.asarray(img2), 3),
                                 jnp.asarray(pts), jnp.asarray(act), win=15,
                                 interpret=True)
    pg, sg, eg = klt_track(build_pyramid(torch.as_tensor(img1), 3),
                           build_pyramid(torch.as_tensor(img2), 3),
                           torch.as_tensor(pts), torch.as_tensor(act), win=15)
    sr, sg = np.asarray(sr), sg.numpy()
    assert (sr == sg).mean() > 0.95
    both = sr & sg
    assert both.mean() > 0.8
    np.testing.assert_allclose(pg.numpy()[both], np.asarray(pr)[both],
                               atol=0.01)
    np.testing.assert_allclose(eg.numpy()[both], np.asarray(er)[both],
                               atol=0.01)


def blocky(H, W, seed=0):
    """tests/test_ops.py's CLAHE input: 8 x 8 blocks of noise, rescaled to
    [10, 240], plus pixel noise, clipped to [0, 255], f32."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(H // 8, W // 8))
    img = np.kron(base, np.ones((8, 8)))[:H, :W]
    img = (img - img.min()) / (img.max() - img.min()) * 230.0 + 10.0
    img += rng.normal(size=img.shape) * 4.0
    return np.clip(img, 0, 255).astype(np.float32)


@pytest.mark.parametrize("shape", [(480, 752), (120, 130), (440, 750)])
def test_k10_k11_clahe_matches_pallas(shape):
    img = blocky(*shape)
    ref = np.asarray(clahe_pallas(jnp.asarray(img), 3.0, 5, interpret=True))
    got = clahe(torch.as_tensor(img), 3.0, 5)
    np.testing.assert_allclose(got.numpy(), ref, atol=0.75)
    luts = kclahe.clahe_luts(torch.as_tensor(img), 3.0, 5)
    assert torch.equal(luts, kclahe.clahe_luts_plain(torch.as_tensor(img)))
    assert torch.equal(got, kclahe.clahe_apply_plain(torch.as_tensor(img),
                                                     luts, 5))


def test_k10_hist_matches_bincount():
    """Exact per-tile counts of the reflect-padded frame (the padding rows
    and columns reflect without repeating the edge), as numpy bins them."""
    rng = np.random.default_rng(5)
    H, W, g = 480, 752, 5
    th, tw = -(-H // g), -(-W // g)
    img = rng.uniform(-3.0, 258.0, (H, W)).astype(np.float32)
    x = np.pad(img, ((0, th * g - H), (0, tw * g - W)), mode="reflect")
    hist = kclahe.clahe_hist_plain(torch.as_tensor(img), g)
    assert torch.equal(kclahe._luts_and_hist(torch.as_tensor(img), 3.0, g)[1],
                       hist.int())
    for p in range(g):
        for q in range(g):
            tile = x[p * th:(p + 1) * th, q * tw:(q + 1) * tw]
            ref = np.bincount(np.clip(tile.astype(np.int64).ravel(), 0, 255),
                              minlength=256)
            np.testing.assert_array_equal(hist[p * g + q].numpy(), ref)
    assert int(hist.sum()) == th * tw * g * g


@pytest.mark.parametrize("shape", [(480, 752), (123, 217)])
def test_k12_response_matches_pallas(shape):
    img = np.random.default_rng(17).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(shi_tomasi_pallas(jnp.asarray(img), interpret=True))
    got = shi_tomasi_response(torch.as_tensor(img))
    assert torch.equal(got, shi_tomasi.shi_tomasi_response(
        torch.as_tensor(img)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-2)
    assert np.all(got.numpy()[:2] == 0) and np.all(got.numpy()[:, -2:] == 0)


def test_k7_gather_aligned_matches_pallas():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (120, 640)).astype(np.float32)
    orig = rng.integers(-40, 700, (37, 2)).astype(np.int32)
    orig[:4] = [[-9, -5], [700, 130], [383, 81], [129, 7]]   # edges, aligns
    ref = np.asarray(gather_tiles_pallas(jnp.asarray(img), jnp.asarray(orig),
                                         th=40, tw=256, interpret=True))
    got = tile_gather.gather_tiles_aligned(torch.as_tensor(img),
                                           torch.as_tensor(orig))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got[0].numpy(), img[0:40, 0:256])
    np.testing.assert_array_equal(got[1].numpy(), img[80:120, 384:640])
    np.testing.assert_array_equal(got[2].numpy(), img[80:120, 256:512])
    np.testing.assert_array_equal(got[3].numpy(), img[0:40, 128:384])
    # a frame narrower than the tile: the oracle's edge clamp beyond it
    small = torch.as_tensor(img[:30, :200])
    tiles = tile_gather.gather_tiles_aligned(small, torch.as_tensor(orig[:3]))
    assert torch.equal(tiles, tile_gather.gather_tiles_plain(
        small, torch.zeros((3, 2), dtype=torch.int32), 40, 256))
