"""The benchmark's simulator and renderer against the port's originals
(rvio_tpu_torch/dataio/synthetic.py), on the CPU at a short duration."""

import numpy as np
import pytest

from benchmark.gen import render, sim
from benchmark.tests.conftest import FISHEYE_CAMERA, SMALL_CAMERA
from rvio_tpu_torch import RVIOConfig
from rvio_tpu_torch.dataio.synthetic import render_frame, simulate_sequence

KW = dict(duration=6.0, static_time=1.5, ramp_time=2.0, n_landmarks=1500,
          motion_scale=0.8, meas_noise=0.001, imu_noise=True)


def _cfg(camera=None):
    cfg = RVIOConfig()
    if camera:
        cfg = cfg.replace(camera=cfg.camera.__class__(**camera))
    return cfg


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_simulator_matches_the_original(seed):
    cfg = _cfg()
    a = simulate_sequence(cfg, seed=seed, **KW)
    b = sim.simulate(cfg, seed=seed, **KW)
    for k in ("imu_t", "frame_t", "gt_p", "gt_R", "landmarks", "feat_meas",
              "feat_len", "feat_type2", "feat_valid"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    # the body rate is a central difference over 1e-6 s: its last digits
    # follow the order of the products
    np.testing.assert_allclose(a.imu_w, b.imu_w, rtol=0, atol=1e-9)
    np.testing.assert_allclose(a.imu_a, b.imu_a, rtol=0, atol=1e-12)


def test_simulator_without_features_draws_the_same_stream():
    cfg = _cfg()
    a = sim.simulate(cfg, seed=9, **KW)
    b = sim.simulate(cfg, seed=9, features=False, **KW)
    np.testing.assert_array_equal(a.imu_a, b.imu_a)
    np.testing.assert_array_equal(a.landmarks, b.landmarks)
    assert b.feat_meas is None


@pytest.mark.parametrize("camera", [None, SMALL_CAMERA, FISHEYE_CAMERA],
                         ids=["euroc", "small", "fisheye"])
def test_renderer_matches_the_original(camera):
    cfg = _cfg(camera)
    s = simulate_sequence(cfg, seed=4, **KW)
    ks = [0, 35, 60, 90, len(s.frame_t) - 1]
    got = render.render(cfg, s, ks, "cpu", block=2)
    for j, k in enumerate(ks):
        want = np.clip(render_frame(cfg, s, k), 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(got[j], want, err_msg=f"frame {k}")
    assert (got == 230).any() and (got == 20).any()
