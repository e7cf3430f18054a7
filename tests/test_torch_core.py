"""rvio_tpu_torch.core against rvio_tpu.core (f64 on CPU, 1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvio_tpu.core import chi2 as jchi2
from rvio_tpu.core import quaternion as jq
from rvio_tpu.core import so3 as jso3
from rvio_tpu_torch.core import chi2 as tchi2
from rvio_tpu_torch.core import quaternion as tq
from rvio_tpu_torch.core import so3 as tso3

torch.set_num_threads(1)
TOL = 1e-12


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _rand_quats(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


class TestQuaternion:
    def test_mul_inv_to_rot(self):
        rng = np.random.default_rng(0)
        q1, q2 = _rand_quats(rng, 64), _rand_quats(rng, 64)
        _close(tq.quat_mul(_t(q1), _t(q2)), jq.quat_mul(jnp.asarray(q1),
                                                        jnp.asarray(q2)))
        _close(tq.quat_inv(_t(q1)), jq.quat_inv(jnp.asarray(q1)))
        _close(tq.quat_to_rot(_t(q1)), jq.quat_to_rot(jnp.asarray(q1)))
        _close(tq.quat_normalize(_t(q1 * 3.0)),
               jq.quat_normalize(jnp.asarray(q1 * 3.0)))

    @pytest.mark.parametrize("branch", ["r00", "r11", "r22", "trace"])
    def test_rot_to_quat_branches(self, branch):
        """Each of the four Breckenridge branches, selected in the
        reference's priority order, on rotations that force it."""
        rng = np.random.default_rng(1)
        axis = {"r00": [1, 0, 0], "r11": [0, 1, 0], "r22": [0, 0, 1],
                "trace": [1, 1, 1]}[branch]
        angle = 0.3 if branch == "trace" else 2.8   # near pi -> axis diag
        qs = []
        for _ in range(16):
            ax = np.asarray(axis, float) + 0.05 * rng.normal(size=3)
            ax /= np.linalg.norm(ax)
            a = angle + 0.05 * rng.normal()
            q = np.concatenate([ax * np.sin(a / 2), [np.cos(a / 2)]])
            qs.append(q)
        R = np.asarray(jq.quat_to_rot(jnp.asarray(np.stack(qs))))
        T = np.trace(R, axis1=1, axis2=2)
        d = np.diagonal(R, axis1=1, axis2=2)
        k = {"r00": 0, "r11": 1, "r22": 2}.get(branch)
        if k is None:
            assert np.all(d.max(axis=1) <= T)
        else:
            assert np.all(np.argmax(d, axis=1) == k) and np.all(d[:, k] > T)
        _close(tq.rot_to_quat(_t(R)), jq.rot_to_quat(jnp.asarray(R)))

    def test_small_quat_both_branches(self):
        rng = np.random.default_rng(2)
        dth = np.concatenate([rng.normal(size=(16, 3)) * 1e-3,
                              rng.normal(size=(16, 3)) * 4.0])  # |v| >= 1 guard
        _close(tq.small_quat_from_dtheta(_t(dth)),
               jq.small_quat_from_dtheta(jnp.asarray(dth)))

    def test_identity(self):
        _close(tq.quat_identity(torch.float64), jq.quat_identity(jnp.float64))


class TestSo3:
    def test_skew(self):
        w = np.random.default_rng(3).normal(size=(10, 3))
        _close(tso3.skew(_t(w)), jso3.skew(jnp.asarray(w)))

    @pytest.mark.parametrize("scale", [1e-5, 1.5])   # small-angle / exact
    def test_delta_rot_and_coeffs(self, scale):
        rng = np.random.default_rng(4)
        w = rng.normal(size=(12, 3)) * scale
        dt = rng.uniform(0.001, 0.01, size=12)
        sa = 0.001745329
        _close(tso3.delta_rot(_t(w), _t(dt), sa),
               jso3.delta_rot(jnp.asarray(w), jnp.asarray(dt), sa))
        w1 = np.linalg.norm(w, axis=1)
        for a, b in zip(tso3.so3_integration_coeffs(_t(w1), _t(dt), sa),
                        jso3.so3_integration_coeffs(jnp.asarray(w1),
                                                    jnp.asarray(dt), sa)):
            _close(a, b, 1e-15)

    def test_rodrigues_np(self):
        rng = np.random.default_rng(5)
        for w in (rng.normal(size=3), np.zeros(3)):
            np.testing.assert_array_equal(tso3.rodrigues_np(w, 0.01),
                                          jso3.rodrigues_np(w, 0.01))


class TestChi2:
    def test_tables_equal(self):
        np.testing.assert_array_equal(tchi2.CHI2_095, jchi2.CHI2_095)
        np.testing.assert_array_equal(tchi2.chi2_truncated_means(30),
                                      jchi2.chi2_truncated_means(30))
        np.testing.assert_array_equal(tchi2.chi2_gate_thresholds(30),
                                      jchi2.chi2_gate_thresholds(30))
