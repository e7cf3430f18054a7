"""Pins for two faults of the port's own making or suspicion.

- Every module of ``rvio_tpu_torch`` imports on its own, from a clean
  state: an import cycle (``import rvio_tpu_torch.ops.shi_tomasi`` alone
  once failed) shows only when the cycle's module is the first one loaded,
  which an import of the whole package in order hides.
- K9's plain version at weak corners: a corner on the image's top rows
  (inside the detector's 4-px border), its structure tensor's
  determinant about 18 and condition about 100, as the weakest of the
  refill candidates on the tracked workload's frame 100.  There ten
  cornerSubPix steps amplify f32 rounding.  The port's plain version and
  the JAX package's ``corner_subpix`` are the same function (f64: 1e-10
  px), and in f32, from the same f32 inputs, the port's parts from f64
  by no more than JAX's does (its largest and its median gap over the
  corners): the function's conditioning, not the port, sets the gap.  The
  two f32 versions round two operations differently (the Gaussian
  weights' exp and the order of the window sums), and on single corners
  either may be the further.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rvio_tpu.frontend.detector import corner_subpix
from rvio_tpu_torch.frontend.klt import TILE, TILE_H, tile_origins
from rvio_tpu_torch.ops.checks import _texture
from rvio_tpu_torch.ops.klt_iterate import subpix_refine_plain, subpix_system
from rvio_tpu_torch.ops.tile_gather import gather_tiles_plain

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

IMPORT_EACH = """
import importlib, pkgutil, sys
import torch
import rvio_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rvio_tpu_torch.__path__,
                                               'rvio_tpu_torch.')]
failed = []
for name in names:
    for k in [k for k in sys.modules
              if k == 'rvio_tpu_torch' or k.startswith('rvio_tpu_torch.')]:
        del sys.modules[k]
    try:
        importlib.import_module(name)
    except Exception as e:
        failed.append(f'{name}: {type(e).__name__}: {e}')
print(len(names))
print('\\n'.join(failed))
"""


def test_each_port_module_imports_alone():
    """One interpreter imports torch once, then each module of the port
    first, after dropping every ``rvio_tpu_torch`` module; names the
    modules that fail."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", IMPORT_EACH], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, *failed = out.stdout.strip().split("\n")
    assert int(n) >= 50
    failed = [f for f in failed if f]
    assert not failed, "modules that fail to import alone:\n" + "\n".join(
        failed)


# a smooth texture stretched 10x along x (gradients along y dominate: a
# condition about 100), dimmed to det about 18 on a bright base, as a weak
# corner of an equalized frame
WEAK_SCALE, WEAK_BASE = 0.06, 200.0


def _weak_corners():
    """(image (120, 188), corners (N, 2)), f32 values held in f64 (so the
    f32 and f64 runs start from the same inputs): points on rows 1-3 with
    det in [9, 36] and condition in [50, 200] at the f64 result."""
    t = _texture(np.random.default_rng(0), 120, 19, passes=3)
    img = torch.nn.functional.interpolate(
        t[None, None], size=(120, 188), mode="bilinear",
        align_corners=True)[0, 0] * WEAK_SCALE + WEAK_BASE
    img = img.float().double()
    xs = np.arange(20.3, 168, 2.0)
    pts = torch.tensor([[x, y + 0.2] for y in (1, 2, 3) for x in xs]
                       ).float().double()
    p, tiles, o = _port(img, pts)
    gxx, gxy, gyy = (x.numpy() for x in subpix_system(tiles, o, p, 7)[:3])
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    big = (tr + np.sqrt(tr * tr - 4 * det)) / 2
    cond = big * big / det
    keep = (det > 9) & (det < 36) & (cond > 50) & (cond < 200)
    return img, pts[torch.as_tensor(keep)]


def _port(img, pts):
    """The port's detector path on the CPU: the 40 x 32 tiles, then
    ``subpix_refine_plain`` (win 7, 10 iterations)."""
    H, W = img.shape
    o = tile_origins(pts.float(), H, W)
    tiles = gather_tiles_plain(img, o, TILE_H, TILE)
    return subpix_refine_plain(tiles, o, pts, win=7, iters=10), tiles, o


def test_k9_weak_corners_part_from_f64_as_the_reference_does():
    img, pts = _weak_corners()
    assert len(pts) >= 20
    port64 = _port(img, pts)[0].numpy()
    port32 = _port(img.float(), pts.float())[0].double().numpy()
    ref64 = np.asarray(corner_subpix(jnp.asarray(img.numpy()),
                                     jnp.asarray(pts.numpy()), win=7,
                                     iters=10))
    ref32 = np.asarray(corner_subpix(
        jnp.asarray(img.float().numpy()), jnp.asarray(pts.float().numpy()),
        win=7, iters=10), np.float64)
    assert ref32.dtype == np.float64 and jax.config.jax_enable_x64
    # one function: the two f64 versions agree
    assert np.abs(port64 - ref64).max() <= 1e-10
    gap_port = np.abs(port32 - port64).max(axis=1)
    gap_ref = np.abs(ref32 - ref64).max(axis=1)
    # both f32 versions part from f64 on these corners, the port's no
    # further than the reference's
    assert gap_ref.max() > 1e-4
    assert gap_port.max() <= gap_ref.max()
    assert np.median(gap_port) <= np.median(gap_ref)
