"""The reference-faithful mode of tests/test_strict_parity.py on the port.

Every deviation from the reference switched off (``init.sigma_v0 = 0``,
``init.freeze_bias_average = False``, ``init.forward_rotate_attitude =
False``, ``tpu.fej = False``, ``tpu.adaptive_noise = False``), at the small
config of tests/test_fault_handling.py (100 Hz IMU, 10 fps, 32 slots) on a
sharp motion onset, the reference's own regime: ``SequenceDriver`` of the
port against the JAX package's, both in f64 on the CPU, frame for frame
(1e-8 m), and the mode still tracks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvio_tpu import config as jconfig
from rvio_tpu.dataio.synthetic import simulate_sequence
from rvio_tpu.runtime.driver import SequenceDriver as JaxDriver
from rvio_tpu.runtime.driver import batches_from_sim as jax_batches
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.eval.ate import ate_rmse
from rvio_tpu_torch.runtime import SequenceDriver, batches_from_sim

torch.set_num_threads(1)
TOL_M = 1e-8


def strict_cfg(mod):
    return mod.RVIOConfig(
        imu=mod.ImuConfig(rate_hz=100.0), camera=mod.CameraConfig(fps=10.0),
        tracker=mod.TrackerConfig(num_features=32, max_tracking_length=6,
                                  min_tracking_length=3),
        init=mod.InitConfig(sigma_v0=0.0, freeze_bias_average=False,
                            forward_rotate_attitude=False),
        tpu=mod.TpuConfig(imu_block=16, fej=False, adaptive_noise=False))


@pytest.fixture(scope="module")
def runs():
    sim = simulate_sequence(strict_cfg(jconfig), duration=8.0,
                            static_time=1.5, ramp_time=0.6, rotation_lead=0.1,
                            seed=7, meas_noise=0.001, imu_noise=True)
    args = (sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    ref = JaxDriver(strict_cfg(jconfig), dtype=jnp.float64).run(
        *args, jax_batches(sim))
    got = SequenceDriver(strict_cfg(tconfig), dtype=torch.float64,
                         device="cpu").run(*args, batches_from_sim(sim))
    return sim, ref, got


def test_config_is_reference_faithful():
    cfg = strict_cfg(tconfig)
    assert cfg.init.sigma_v0 == 0.0
    assert not cfg.init.freeze_bias_average
    assert not cfg.init.forward_rotate_attitude
    assert not cfg.tpu.adaptive_noise
    assert not cfg.tpu.fej


def test_strict_mode_matches_jax(runs):
    _, ref, got = runs
    assert len(got.timestamps) == len(ref.timestamps) > 50
    np.testing.assert_array_equal(got.timestamps, ref.timestamps)
    np.testing.assert_array_equal(got.n_good, ref.n_good)
    np.testing.assert_allclose(got.positions, ref.positions, rtol=0,
                               atol=TOL_M)
    np.testing.assert_allclose(got.quaternions, ref.quaternions, rtol=0,
                               atol=TOL_M)


def test_strict_mode_tracks(runs):
    """The bounds of tests/test_strict_parity.py, on the port: the mode
    converges, and updates fire on most frames."""
    sim, _, got = runs
    idx = np.searchsorted(sim.frame_t, got.timestamps)
    assert ate_rmse(got.positions, sim.gt_p[idx]) < 0.20
    warm = got.n_good[20:]
    assert warm.mean() > 4 and (warm > 2).mean() > 0.8
