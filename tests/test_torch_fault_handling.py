"""Degraded input on the port, against the JAX package (tests/
test_fault_handling.py): a hole in the IMU stream, ``bundle_imu``'s empty
groups, and a 2 s vision outage, at that file's small config, with
``SequenceDriver`` in f64 on the CPU on both sides: the same frames, the
same accepted-feature counts and positions within 1e-8 m, and the JAX
test's own bounds on the port.
"""

import jax.numpy as jnp
import numpy as np
import torch

from rvio_tpu import config as jconfig
from rvio_tpu.dataio.synthetic import simulate_sequence
from rvio_tpu.runtime.driver import SequenceDriver as JaxDriver
from rvio_tpu.runtime.driver import batches_from_sim as jax_batches
from rvio_tpu.runtime.driver import bundle_imu as jax_bundle_imu
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.eval.ate import ate_rmse
from rvio_tpu_torch.runtime import (SequenceDriver, batches_from_sim,
                                    bundle_imu)

torch.set_num_threads(1)
TOL_M = 1e-8


def _cfg(mod):
    return mod.RVIOConfig(
        imu=mod.ImuConfig(rate_hz=100.0), camera=mod.CameraConfig(fps=10.0),
        tracker=mod.TrackerConfig(num_features=32, max_tracking_length=6,
                                  min_tracking_length=3),
        tpu=mod.TpuConfig(imu_block=16))


def _both(imu_t, imu_w, imu_a, frame_t, jb, tb):
    ref = JaxDriver(_cfg(jconfig), dtype=jnp.float64).run(
        imu_t, imu_w, imu_a, frame_t, jb)
    got = SequenceDriver(_cfg(tconfig), dtype=torch.float64,
                         device="cpu").run(imu_t, imu_w, imu_a, frame_t, tb)
    np.testing.assert_array_equal(got.timestamps, ref.timestamps)
    np.testing.assert_array_equal(got.n_good, ref.n_good)
    np.testing.assert_allclose(got.positions, ref.positions, rtol=0,
                               atol=TOL_M)
    np.testing.assert_allclose(got.quaternions, ref.quaternions, rtol=0,
                               atol=TOL_M)
    return got


def test_frames_without_imu_are_skipped():
    sim = simulate_sequence(_cfg(jconfig), duration=8.0, static_time=1.0,
                            ramp_time=1.5, seed=21, meas_noise=5e-4)
    keep = (sim.imu_t < 4.0) | (sim.imu_t > 4.35)
    got = _both(sim.imu_t[keep], sim.imu_w[keep], sim.imu_a[keep],
                sim.frame_t, jax_batches(sim), batches_from_sim(sim))
    assert np.isfinite(got.positions).all()
    in_hole = (got.timestamps > 4.0) & (got.timestamps < 4.3)
    assert in_hole.sum() <= 1
    idx = np.searchsorted(sim.frame_t, got.timestamps)
    assert ate_rmse(got.positions, sim.gt_p[idx]) < 1.0


def test_bundle_imu_empty_groups():
    imu_t = np.array([0.01, 0.02, 0.2, 0.21])
    w = np.zeros((4, 3))
    a = np.tile([0, 0, 9.8], (4, 1))
    frame_t = np.array([0.05, 0.1, 0.25])
    groups = bundle_imu(imu_t, w, a, frame_t)
    ref = jax_bundle_imu(imu_t, w, a, frame_t)
    assert [len(g[0]) for g in groups] == [2, 0, 2]
    for g, r in zip(groups, ref):
        for x, y in zip(g, r):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_long_vision_outage_dead_reckons():
    sim = simulate_sequence(_cfg(jconfig), duration=10.0, static_time=1.0,
                            ramp_time=1.5, seed=22, meas_noise=5e-4)
    jb, tb = jax_batches(sim), batches_from_sim(sim)
    for batches in (jb, tb):
        for k, t in enumerate(sim.frame_t):
            if 4.0 < t < 6.0:
                b = batches[k]
                batches[k] = type(b)(meas=b.meas,
                                     track_len=np.zeros_like(b.track_len),
                                     is_type2=b.is_type2,
                                     valid=np.zeros_like(b.valid))
    got = _both(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t, jb, tb)
    t = got.timestamps
    assert got.n_good[(t > 4.3) & (t < 6.0)].max(initial=0) == 0
    assert got.n_good[t > 7.0].mean() > 1
    idx = np.searchsorted(sim.frame_t, t)
    assert ate_rmse(got.positions, sim.gt_p[idx]) < 1.0
