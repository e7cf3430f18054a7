"""rvio_tpu_torch.state against rvio_tpu.state (f64 on CPU, 1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvio_tpu.state import FilterState as JState
from rvio_tpu.state import augment_window as j_augment
from rvio_tpu.state import compose_state as j_compose
from rvio_tpu.state import static_initialize as j_static
from rvio_tpu_torch.state import (augment_window, compose_state,
                                  state_from_numpy, state_to_numpy,
                                  static_initialize)

torch.set_num_threads(1)
M = 5
TOL = 1e-12


def _jax_to_np(st):
    return {k: np.asarray(v) for k, v in st.__dict__.items()}


def _np_to_jax(d):
    return JState(**{k: jnp.asarray(v) for k, v in d.items()})


def _assert_states(port, ref, tol=TOL):
    a, b = state_to_numpy(port), _jax_to_np(ref)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=tol, err_msg=k)


def _random_state(rng, n_clones, frame_idx):
    D = 24 + 6 * M
    A = rng.normal(size=(D, D)) * 0.05
    P = A @ A.T + 1e-4 * np.eye(D)
    P[24 + 6 * n_clones:, :] = 0
    P[:, 24 + 6 * n_clones:] = 0

    def quat():
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        return q * np.sign(q[3])

    clones = np.tile([0, 0, 0, 1, 0, 0, 0.0], (M, 1))
    for c in range(n_clones):
        clones[c] = np.concatenate([quat(), rng.normal(size=3)])
    g = np.array([0.05, -0.02, 1.0])
    return dict(q_G=quat(), p_G=rng.normal(size=3), g=g / np.linalg.norm(g),
                q_R=quat(), p_R=rng.normal(size=3), v_R=rng.normal(size=3),
                bg=rng.normal(size=3) * 1e-3, ba=rng.normal(size=3) * 1e-2,
                clones=clones, P=P, n_clones=np.int32(n_clones),
                frame_idx=np.int32(frame_idx), clones_fej=clones.copy(),
                sigma2_scale=np.float64(1.3))


@pytest.mark.parametrize("align,dR", [(True, False), (False, False),
                                      (True, True)])
def test_static_initialize(align, dR):
    rng = np.random.default_rng(0)
    w = rng.normal(size=3) * 1e-3
    a = np.array([0.3, -0.2, 9.7]) + rng.normal(size=3) * 0.01
    rot = None
    if dR:
        from scipy.spatial.transform import Rotation
        rot = Rotation.from_rotvec([0.01, -0.02, 0.005]).as_matrix()
    kw = dict(gravity=9.8082, imu_rate=200.0, sigma_a=2e-3, sigma_wg=1.9e-5,
              sigma_wa=3e-3, enable_alignment=align, max_clones=M,
              sigma_v0=0.1, use_bias_estimates=True, dR_since_avg=rot)
    ref = j_static(jnp.asarray(w), jnp.asarray(a), 120, **kw)
    port = static_initialize(w, a, 120, dtype=torch.float64, device="cpu", **kw)
    _assert_states(port, ref)


@pytest.mark.parametrize("n_clones,frame_idx", [(2, 5), (M, 9), (0, 0)])
def test_augment_window(n_clones, frame_idx):
    """Growth (n < M), slide (n == M) and the skipped first frame."""
    d = _random_state(np.random.default_rng(1), n_clones, frame_idx)
    ref = j_augment(_np_to_jax(d))
    port = augment_window(state_from_numpy(d, "cpu", torch.float64))
    _assert_states(port, ref)


def test_compose_state():
    d = _random_state(np.random.default_rng(2), 3, 4)
    ref, (rq, rp, rv) = j_compose(_np_to_jax(d))
    port, (pq, pp, pv) = compose_state(state_from_numpy(d, "cpu", torch.float64))
    _assert_states(port, ref)
    for a, b in ((pq, rq), (pp, rp), (pv, rv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)


def test_state_round_trip():
    d = _random_state(np.random.default_rng(3), 4, 7)
    back = state_to_numpy(state_from_numpy(d, "cpu", torch.float64))
    for k in d:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    assert back["n_clones"].dtype == np.int32
