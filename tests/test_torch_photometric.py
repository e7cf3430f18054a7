"""The port's photometric stress option against the JAX package.

- the four cases of tests/test_photometric.py ``TestApplyPhotometric`` on
  the port's ``apply_photometric``, each also equal to the JAX package's
  function on the same input;
- ``run_rendered_sequence_scan(..., photometric=...)`` at the small image
  config of tests/test_torch_tracker.py with CLAHE on, every stress at
  once, f64 on the CPU against the JAX driver with the same stress and
  draws: positions and attitudes to 1e-8, counters exactly;
- on the card (``gpu``), the end-to-end class of tests/test_photometric.py
  (``TestStressAccuracy``) at ``RVIOConfig()`` in f32, with its ATE gates;
  ``-s`` prints each stress's ATE.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvio_tpu import config as jconfig
from rvio_tpu.dataio import synthetic as jsynthetic
from rvio_tpu.runtime.driver import bundle_imu
from rvio_tpu.runtime.image_driver import \
    run_rendered_sequence_scan as jax_run_rendered
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.dataio.synthetic import (PhotometricStress,
                                             apply_photometric)
from rvio_tpu_torch.runtime import run_rendered_sequence_scan
from rvio_tpu_torch.runtime.image_driver import _find_init_frame
from test_torch_tracker import _cfg, jax_draws

torch.set_num_threads(1)


def _same_as_jax(img, k, t, stress, **kw):
    """The port's output, checked equal to the JAX package's."""
    out = apply_photometric(img, k, t, stress, **kw)
    ref = jsynthetic.apply_photometric(
        img, k, t, jsynthetic.PhotometricStress(**vars(stress)), **kw)
    np.testing.assert_array_equal(out, ref)
    return out


class TestApplyPhotometric:
    def test_exposure_step_changes_gain(self):
        img = np.full((40, 60), 100.0, np.float32)
        st = PhotometricStress(exposure_gains=(1.0, 0.5),
                               exposure_period_s=1.0)
        out0 = _same_as_jax(img, 0, 0.0, st)
        out1 = _same_as_jax(img, 20, 1.0, st)
        assert out0.mean() == pytest.approx(100.0)
        assert out1.mean() == pytest.approx(50.0)

    def test_vignette_darkens_corners_not_center(self):
        img = np.full((41, 61), 200.0, np.float32)
        st = PhotometricStress(vignette_strength=0.6)
        out = _same_as_jax(img, 0, 0.0, st)
        assert out[20, 30] == pytest.approx(200.0, abs=2.0)
        assert out[0, 0] < 100.0

    def test_blur_spreads_point_along_flow(self):
        img = np.zeros((41, 61), np.float32)
        img[20, 30] = 255.0
        st = PhotometricStress(blur_px=6.0)
        out = _same_as_jax(img, 1, 0.0, st, flow=np.array([6.0, 0.0]))
        row = out[20]
        assert (row > 1.0).sum() >= 4          # smeared horizontally
        assert out[:, 30].max() < 255.0
        assert out.sum() == pytest.approx(255.0, rel=0.05)  # energy kept

    def test_noise_burst_deterministic_and_periodic(self):
        img = np.full((30, 30), 128.0, np.float32)
        st = PhotometricStress(burst_period_s=0.5, burst_sigma=30.0, seed=3)
        a = _same_as_jax(img, 10, 0.5, st, fps=20.0)
        b = _same_as_jax(img, 10, 0.5, st, fps=20.0)
        np.testing.assert_array_equal(a, b)            # deterministic
        assert a.std() > 15.0                          # burst frame (k=10)
        quiet = _same_as_jax(img, 11, 0.55, st, fps=20.0)
        assert quiet.std() < 1.0                       # off-burst clean


COMBINED = dict(exposure_gains=(1.0, 0.55, 1.5), exposure_period_s=2.5,
                vignette_strength=0.35, blur_px=3.0, noise_sigma=4.0,
                burst_period_s=2.0, burst_sigma=18.0)


def test_stressed_run_matches_jax():
    """CLAHE on, every stress of tests/test_photometric.py's combined case,
    the same frames on both sides: the JAX driver and the port agree."""
    jcfg, tcfg = _cfg(jconfig, True), _cfg(tconfig, True)
    sim = jsynthetic.simulate_sequence(jcfg, duration=5.0, static_time=1.0,
                                       ramp_time=1.5, seed=6, n_landmarks=400,
                                       motion_scale=0.5)
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    _, k0 = _find_init_frame(tcfg, groups, len(sim.frame_t), torch.float64,
                             "cpu")
    n = k0 + 1 + 20
    jstress = jsynthetic.PhotometricStress(**COMBINED)
    ref = jax_run_rendered(jcfg, sim, dtype=jnp.float64, chunk_size=16,
                           max_frames=n, photometric=jstress)
    got = run_rendered_sequence_scan(
        tcfg, sim, dtype=torch.float64, device="cpu", chunk_size=16,
        max_frames=n, uniforms=jax_draws(0, 20, 40),
        photometric=PhotometricStress(**COMBINED))
    clean = run_rendered_sequence_scan(
        tcfg, sim, dtype=torch.float64, device="cpu", chunk_size=16,
        max_frames=n, uniforms=jax_draws(0, 20, 40))
    assert len(got.timestamps) == len(ref.timestamps) == 20
    np.testing.assert_array_equal(got.timestamps, ref.timestamps)
    np.testing.assert_array_equal(got.n_good, ref.n_good)
    for k in ("n_tracked", "n_lost", "n_new", "n_usable", "tl_good_sum"):
        np.testing.assert_array_equal(got.diag[k], ref.diag[k], err_msg=k)
    np.testing.assert_allclose(got.positions, ref.positions, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.quaternions, ref.quaternions, rtol=0,
                               atol=1e-8)
    # the stress reaches the tracker
    assert not np.array_equal(got.diag["n_tracked"], clean.diag["n_tracked"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _stress_run(cuda, stress):
    """tests/test_photometric.py's ``_run`` on the card (f32)."""
    from rvio_tpu_torch.dataio.synthetic import simulate_sequence
    from rvio_tpu_torch.eval.ate import ate_rmse
    cfg = tconfig.RVIOConfig()
    sim = simulate_sequence(cfg, duration=9.0, static_time=1.5, ramp_time=4.0,
                            seed=7, n_landmarks=2000, motion_scale=0.8,
                            imu_noise=True)
    res = run_rendered_sequence_scan(cfg, sim, device=cuda, chunk_size=16,
                                     photometric=stress)
    ate = ate_rmse(res.positions,
                   sim.gt_p[np.searchsorted(sim.frame_t, res.timestamps)])
    print(f"photometric stress {stress}: {len(res.timestamps)} frames, ATE "
          f"{ate:.4f} m, n_good mean {res.n_good.mean():.2f}")
    return res, ate


# tests/test_photometric.py TestStressAccuracy: stress, ATE gate, n_good gate
STRESS_CASES = {
    "exposure_steps": (dict(exposure_gains=(1.0, 0.45, 1.6),
                            exposure_period_s=2.0), 0.25, 4.0),
    "vignetting": (dict(vignette_strength=0.5), 0.25, 4.0),
    "motion_blur": (dict(blur_px=5.0), 0.30, 3.0),
    "noise_bursts": (dict(noise_sigma=6.0, burst_period_s=1.5,
                          burst_sigma=25.0), 0.30, 3.0),
    "combined": (COMBINED, 0.35, 3.0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(STRESS_CASES))
def test_stress_accuracy_on_card(cuda, case):
    kw, ate_gate, good_gate = STRESS_CASES[case]
    res, ate = _stress_run(cuda, PhotometricStress(**kw))
    assert ate < ate_gate, f"{case} ATE {ate:.3f} m"
    assert res.n_good.mean() > good_gate
