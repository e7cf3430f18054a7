"""The initialization gate on the port, against the JAX package
(tests/test_init_gate.py): at ``RVIOConfig()`` on a slow 5 s motion onset,
the port's ``InitializationGate`` (f64, CPU) fires at the JAX gate's frame
with its initial state (1e-12), with the bias-average freeze on and off,
and the freeze's own bounds hold on the port: it keeps the gyro-bias
error under 1e-3 rad/s without moving the firing frame, where the
reference-faithful average is poisoned by more than 3e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvio_tpu import config as jconfig
from rvio_tpu.dataio.synthetic import simulate_sequence
from rvio_tpu.runtime.driver import InitializationGate as JaxGate
from rvio_tpu.runtime.driver import bundle_imu
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.runtime import InitializationGate

torch.set_num_threads(1)
TOL = 1e-12


def _fire(gate, groups):
    for k, (w, a, dts) in enumerate(groups):
        if len(w) < 2:
            continue
        st = gate.feed(w, a, dts)
        if st is not None:
            return k, st
    raise AssertionError("gate never fired")


def _cfgs(freeze):
    j, t = jconfig.RVIOConfig(), tconfig.RVIOConfig()
    return (dataclasses.replace(j, init=dataclasses.replace(
                j.init, freeze_bias_average=freeze)),
            dataclasses.replace(t, init=dataclasses.replace(
                t.init, freeze_bias_average=freeze)))


@pytest.fixture(scope="module", params=[False, True], ids=["clean", "noisy"])
def sim(request):
    s = simulate_sequence(jconfig.RVIOConfig(), duration=10.0,
                          static_time=1.5, ramp_time=5.0, seed=7,
                          n_landmarks=500, motion_scale=0.8,
                          imu_noise=request.param)
    return s, bundle_imu(s.imu_t, s.imu_w, s.imu_a, s.frame_t)


def _state_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name), np.float64)
            for f in dataclasses.fields(st)}


@pytest.mark.parametrize("freeze", [True, False], ids=["freeze", "reference"])
def test_gate_matches_jax(sim, freeze):
    s, groups = sim
    jcfg, tcfg = _cfgs(freeze)
    k_ref, ref = _fire(JaxGate(jcfg, jnp.float64), groups)
    k_got, got = _fire(InitializationGate(tcfg, torch.float64, "cpu"), groups)
    assert k_got == k_ref
    ref, got = _state_arrays(ref), _state_arrays(got)
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=TOL,
                                   err_msg=name)


def test_freeze_bounds_on_the_port(sim):
    s, groups = sim
    k_on, st_on = _fire(InitializationGate(_cfgs(True)[1], torch.float64,
                                           "cpu"), groups)
    k_off, st_off = _fire(InitializationGate(_cfgs(False)[1], torch.float64,
                                             "cpu"), groups)
    assert k_on == k_off
    err_on = np.linalg.norm(st_on.bg.numpy() - s.bg)
    err_off = np.linalg.norm(st_off.bg.numpy() - s.bg)
    assert err_on < 1.5e-3, err_on
    assert err_off > 3e-3, err_off
