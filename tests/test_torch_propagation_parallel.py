"""The port's parallel-prefix propagation against the JAX package's.

The cases of tests/test_propagation.py::TestParallelPropagation, in f64:
``propagate(parallel=True)`` against JAX ``_propagate_parallel`` at
1e-12 on every state field (two tree orders of one prefix), against the
port's own sequential form at JAX's stated bounds (about 1e-13 in f64),
zero valid samples leaving the state as it was, and garbage in the
padding (dt != 0 where ``valid`` is False) changing nothing.  Also the
batched form: B streams in one call, each equal to its own call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvio_tpu.filter.propagation import ImuBlock as JImuBlock
from rvio_tpu.filter.propagation import _propagate_parallel
from rvio_tpu.state import FilterState as JState
from rvio_tpu.state import make_initial_state as j_initial
from rvio_tpu_torch.filter.propagation import ImuBlock, propagate
from rvio_tpu_torch.state import (stack_states, state_from_numpy,
                                  state_to_numpy)

torch.set_num_threads(1)
F64 = torch.float64
KW = dict(gravity=9.8082, small_angle=0.001745, sigma_g=1.7e-4,
          sigma_wg=1.9e-5, sigma_a=2e-3, sigma_wa=3e-3)
FIELDS = ("q_R", "p_R", "v_R", "P")


def _case(seed, k_valid, K=16):
    """tests/test_propagation.py's ``_random_state_and_block`` in numpy:
    (state dict, (w, a, dt, valid))."""
    rng = np.random.default_rng(seed)
    M = 14
    d = {k: np.asarray(v) for k, v in j_initial(M, jnp.float64)
         .__dict__.items()}
    q = rng.normal(size=4)
    A = rng.normal(size=(24 + 6 * M, 24 + 6 * M)) * 0.01
    g = np.array([0.03, -0.02, 0.999])
    d.update(q_R=q / np.linalg.norm(q), p_R=rng.normal(size=3) * 0.1,
             v_R=rng.normal(size=3), g=g / np.linalg.norm(g),
             bg=rng.normal(size=3) * 0.01, ba=rng.normal(size=3) * 0.05,
             P=A @ A.T + np.eye(24 + 6 * M) * 1e-6, n_clones=np.int32(M))
    w = rng.normal(size=(k_valid, 3)) * 0.8
    a = rng.normal(size=(k_valid, 3)) * 2.0 + [0, 0, 9.8]
    dt = np.full(k_valid, 0.005) + rng.uniform(0, 2e-4, size=k_valid)
    pad = K - k_valid
    return d, (np.pad(w, ((0, pad), (0, 0))), np.pad(a, ((0, pad), (0, 0))),
               np.pad(dt, (0, pad)), np.arange(K) < k_valid)


def _port(d, imu, parallel):
    w, a, dt, valid = imu
    blk = ImuBlock(w=torch.as_tensor(w), a=torch.as_tensor(a),
                   dt=torch.as_tensor(dt), valid=torch.as_tensor(valid))
    return state_to_numpy(propagate(state_from_numpy(d, "cpu", F64), blk,
                                    parallel=parallel, **KW))


def _jax(d, imu):
    w, a, dt, valid = imu
    out = _propagate_parallel(
        JState(**{k: jnp.asarray(v) for k, v in d.items()}),
        JImuBlock(w=jnp.asarray(w), a=jnp.asarray(a), dt=jnp.asarray(dt),
                  valid=jnp.asarray(valid)), **KW)
    return {k: np.asarray(v) for k, v in out.__dict__.items()}


@pytest.mark.parametrize("k_valid", [1, 7, 11, 16])
def test_matches_jax_parallel(k_valid):
    d, imu = _case(seed=k_valid, k_valid=k_valid)
    got, ref = _port(d, imu, True), _jax(d, imu)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("k_valid", [1, 7, 11, 16])
def test_matches_sequential(k_valid):
    """tests/test_propagation.py::test_matches_sequential on the port."""
    d, imu = _case(seed=k_valid, k_valid=k_valid)
    par, seq = _port(d, imu, True), _port(d, imu, False)
    for k in ("q_R", "p_R", "v_R"):
        np.testing.assert_allclose(par[k], seq[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(par["P"], seq["P"], rtol=1e-9, atol=1e-13)


def test_zero_valid_samples_freezes_state():
    d, (w, a, dt, valid) = _case(seed=5, k_valid=4)
    empty = (w, a, dt, np.zeros_like(valid))
    for parallel in (False, True):
        out = _port(d, empty, parallel)
        for k in FIELDS:
            np.testing.assert_allclose(out[k], d[k], rtol=0, atol=1e-15,
                                       err_msg=k)


def test_garbage_in_padding_is_ignored():
    d, (w, a, dt, valid) = _case(seed=3, k_valid=9)
    ref = _port(d, (w, a, dt, valid), True)
    w2, a2, dt2 = w.copy(), a.copy(), dt.copy()
    w2[9:], a2[9:], dt2[9:] = 1e3, -1e4, 0.005
    out = _port(d, (w2, a2, dt2, valid), True)
    for k in FIELDS:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_batched_streams_equal_single_calls():
    """Three streams with their own states and sample counts in one call:
    each equals its single call bitwise."""
    cases = [_case(seed=s, k_valid=k) for s, k in ((1, 16), (2, 5), (4, 0))]
    states = stack_states([state_from_numpy(d, "cpu", F64)
                           for d, _ in cases])
    blk = ImuBlock(*(torch.as_tensor(np.stack(x))
                     for x in zip(*(imu for _, imu in cases))))
    out = state_to_numpy(propagate(states, blk, parallel=True, **KW))
    for i, (d, imu) in enumerate(cases):
        one = _port(d, imu, True)
        for k in FIELDS:
            np.testing.assert_array_equal(out[k][i], one[k], err_msg=k)
