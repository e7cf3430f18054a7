"""The image half of the port's utils/visualize.py against the JAX
package's: tests/test_runtime_aux.py's ``test_debug_images`` on the port,
and ``draw_tracks``/``draw_detections`` array-equal and the PNG files of
``save_debug_image`` byte-equal to rvio_tpu.utils.visualize's on seeded
inputs (points past the image's edges included)."""

import os

import numpy as np
import pytest
import torch

from rvio_tpu.utils import visualize as jvis
from rvio_tpu_torch.utils import (draw_detections, draw_tracks,
                                  save_debug_image)

torch.set_num_threads(1)


def test_debug_images(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (60, 80))
    prev = rng.uniform(10, 70, (5, 2))
    new = prev + rng.normal(0, 2, (5, 2))
    inl = np.array([1, 1, 0, 1, 0], bool)
    out = draw_tracks(img, prev, new, inl)
    assert out.shape == img.shape
    p = str(tmp_path / "track.png")
    save_debug_image(p, out)
    assert os.path.getsize(p) > 100
    out2 = draw_detections(img, prev, new)
    save_debug_image(str(tmp_path / "newer.png"), out2)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_matches_jax(seed, tmp_path):
    rng = np.random.default_rng(seed)
    H, W = 48, 64
    img = rng.uniform(-20, 280, (H, W))          # clipped when saved
    prev = rng.uniform(-5, 70, (12, 2))          # some off the image
    new = prev + rng.normal(0, 6, (12, 2))
    inl = rng.random(12) < 0.6
    pairs = [(draw_tracks(img, prev, new, inl),
              jvis.draw_tracks(img, prev, new, inl)),
             (draw_detections(img, prev, new),
              jvis.draw_detections(img, prev, new))]
    for k, (got, ref) in enumerate(pairs):
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
        ours, theirs = tmp_path / f"p{k}.png", tmp_path / f"j{k}.png"
        save_debug_image(str(ours), got)
        jvis.save_debug_image(str(theirs), ref)
        assert ours.read_bytes() == theirs.read_bytes()
