"""The port's copy of rvio_tpu/parallel/stitch.py against the JAX
package's module (numpy in both; the same inputs give the same arrays):
the ports of tests/test_handoff.py TestStitchPrimitives and
tests/test_parallel.py TestStitching, each also run through the JAX
functions."""

import numpy as np
import pytest
import torch

from rvio_tpu.parallel import stitch as jstitch
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.dataio.synthetic import simulate_sequence
from rvio_tpu_torch.eval.ate import ate_rmse
from rvio_tpu_torch.parallel.stitch import (boundary_transforms,
                                            fit_yaw_transform,
                                            prefix_product, stitch_segments)
from rvio_tpu_torch.runtime import SequenceDriver, batches_from_sim
from test_torch_batched import small_cfg

torch.set_num_threads(1)


def _yaw(y):
    c, s = np.cos(y), np.sin(y)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def test_prefix_product_matches_sequential_and_jax():
    rng = np.random.default_rng(3)
    Ts = []
    for _ in range(11):
        T = np.eye(4)
        T[:3, :3] = _yaw(rng.uniform(-np.pi, np.pi))
        T[:3, 3] = rng.normal(size=3)
        Ts.append(T)
    out = prefix_product(np.asarray(Ts))
    np.testing.assert_array_equal(out, jstitch.prefix_product(np.asarray(Ts)))
    acc = np.eye(4)
    for i, T in enumerate(Ts):
        acc = acc @ T
        np.testing.assert_allclose(out[i], acc, atol=1e-12)


@pytest.mark.parametrize("with_rotations", [True, False])
def test_fit_yaw_transform_matches_jax(with_rotations):
    """The orientation-based fit recovers a known yaw + translation even
    when the overlap barely translates; the position-only fit on a moving
    overlap; both as the JAX function's."""
    rng = np.random.default_rng(0)
    Rz, t = _yaw(0.8), np.array([3.0, -1.0, 0.5])
    scale = 0.005 if with_rotations else 2.0
    cur_p = scale * rng.normal(size=(20, 3))
    cur_R = np.stack([np.linalg.qr(np.eye(3) + 0.3 * rng.normal(size=(3, 3)))[0]
                      for _ in range(20)])
    prev_p = (Rz @ cur_p.T).T + t
    prev_R = Rz @ cur_R
    args = (cur_p, prev_p) + ((cur_R, prev_R) if with_rotations else ())
    T = fit_yaw_transform(*args)
    np.testing.assert_array_equal(T, jstitch.fit_yaw_transform(*args))
    np.testing.assert_allclose(T[:3, :3], Rz, atol=1e-10)
    np.testing.assert_allclose(T[:3, 3], t, atol=0.02)


def test_stitch_drift_8_segments_matches_jax():
    """An 8-segment chain with small per-segment noise: bounded drift, and
    the same stitched trajectory and offsets as the JAX function."""
    rng = np.random.default_rng(1)
    tt = np.linspace(0, 8 * np.pi, 1600)
    world = np.stack([10 * np.cos(tt / 4), 10 * np.sin(tt / 4),
                      0.5 * np.sin(tt)], axis=1)
    tang = np.gradient(world, axis=0)
    Rws = np.stack([_yaw(y) for y in np.arctan2(tang[:, 1], tang[:, 0])])
    S, ov = 8, 40
    n = len(world) // S
    seg_p, seg_R = [], []
    for s in range(S):
        lo, hi = max(s * n - ov, 0), min((s + 1) * n, len(world))
        p = world[lo:hi] + 0.01 * rng.normal(size=(hi - lo, 3))
        Rz = _yaw(rng.uniform(-np.pi, np.pi))
        seg_p.append((Rz @ (p - p[0]).T).T)
        seg_R.append(np.einsum("ij,njk->nik", Rz, Rws[lo:hi]))
    overlaps = [ov] * (S - 1)
    stitched, offsets = stitch_segments(seg_p, seg_R, overlaps=overlaps)
    jp, jo = jstitch.stitch_segments(seg_p, seg_R, overlaps=overlaps)
    np.testing.assert_array_equal(stitched, jp)
    np.testing.assert_array_equal(offsets, jo)
    assert len(stitched) == len(world)
    assert ate_rmse(stitched, world) < 0.25
    np.testing.assert_array_equal(boundary_transforms(seg_p, seg_R),
                                  jstitch.boundary_transforms(seg_p, seg_R))
    # the hard chain (no overlap), with and without rotations
    for rots in (seg_R, None):
        np.testing.assert_array_equal(
            stitch_segments(seg_p, rots)[0],
            jstitch.stitch_segments(seg_p, rots)[0])


def test_stitch_reassembles_split_trajectory():
    """A filtered trajectory (the port's driver, f64 on the CPU) split into
    two overlapping segments, the second in a frame of its own, stitched
    back (the port of tests/test_parallel.py TestStitching)."""
    cfg = small_cfg(tconfig)
    sim = simulate_sequence(cfg, duration=16.0, static_time=1.0, seed=2,
                            meas_noise=5e-4)
    full = SequenceDriver(cfg, dtype=torch.float64, device="cpu").run(
        sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t, batches_from_sim(sim))
    n_half = len(full.positions) // 2
    ov = 12
    seg_a = full.positions[:n_half + ov]
    seg_b_world = full.positions[n_half:]
    Rz = _yaw(0.6)
    seg_b = (Rz @ (seg_b_world - seg_b_world[0]).T).T
    stitched, offsets = stitch_segments([seg_a, seg_b], overlaps=[ov])
    jp, _ = jstitch.stitch_segments([seg_a, seg_b], overlaps=[ov])
    np.testing.assert_array_equal(stitched, jp)
    expect = np.concatenate([seg_a, seg_b_world[ov:]], axis=0)
    assert np.linalg.norm(stitched - expect, axis=1).max() < 0.15
