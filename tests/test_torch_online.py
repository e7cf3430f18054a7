"""The port's live path: InputBuffer, ImagePipeline and OnlineDriver.

f64 on the CPU at the small image config of tests/test_online.py:25-35
(320x240 frames, 48 slots, L = 8, equalizer on):

- the port's copy of InputBuffer pops exactly what the JAX package's does
  for the same pushes;
- ``ImagePipeline`` against the JAX ``ImagePipeline`` frame by frame, with
  the JAX chain's RANSAC draws and one frame whose IMU group overflows the
  static block (the propagation-only sub-steps): positions within 1e-8 m,
  n_good and the counters equal;
- ``OnlineDriver`` (plain and pipelined spin) against the port's own
  ``run_rendered_sequence_scan`` with the same seed, so the same draws:
  positions within 1e-12 m;
- dropped images are counted from sequence gaps and the filter keeps
  tracking through them (tests/test_online.py's bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvio_tpu import config as jconfig
from rvio_tpu.dataio.synthetic import render_frame, simulate_sequence
from rvio_tpu.runtime.driver import bundle_imu
from rvio_tpu.runtime.image_driver import ImagePipeline as JaxPipeline
from rvio_tpu.runtime.input_buffer import InputBuffer as JaxBuffer
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.eval.ate import ate_rmse
from rvio_tpu_torch.runtime import (ImagePipeline, InputBuffer, OnlineDriver,
                                    run_rendered_sequence_scan)

torch.set_num_threads(1)


def _mini_cfg(mod):
    return mod.RVIOConfig(
        imu=mod.ImuConfig(rate_hz=100.0),
        camera=mod.CameraConfig(fps=10.0, width=320, height=240, fx=200.0,
                                fy=200.0, cx=160.0, cy=120.0, k1=-0.05,
                                k2=0.01, p1=0.0, p2=0.0),
        tracker=mod.TrackerConfig(num_features=48, max_tracking_length=8,
                                  min_tracking_length=3, min_distance=12.0,
                                  block_size_x=80, block_size_y=60),
        init=mod.InitConfig(sigma_v0=0.1),
        tpu=mod.TpuConfig(imu_block=16))


def _sim(duration):
    return simulate_sequence(_mini_cfg(jconfig), duration=duration,
                             static_time=1.0, ramp_time=1.5, seed=6,
                             n_landmarks=400, motion_scale=0.5)


def _u8(cfg, sim, k):
    return np.clip(render_frame(cfg, sim, k), 0, 255).astype(np.uint8)


def test_input_buffer_copy_matches():
    rng = np.random.default_rng(3)
    bufs = (JaxBuffer(), InputBuffer())
    t_imu = np.sort(rng.uniform(0.0, 2.0, 90))
    t_img = np.sort(rng.uniform(0.0, 2.2, 12))
    events = ([("imu", t, i) for i, t in enumerate(t_imu)]
              + [("img", t, i) for i, t in enumerate(t_img)])
    order = rng.permutation(len(events))      # out-of-order arrivals too
    popped = [[], []]
    for j in order:
        kind, t, i = events[j]
        for b, out in zip(bufs, popped):
            if kind == "imu":
                b.push_imu(t, np.full(3, float(i)), np.full(3, t))
            else:
                b.push_image(t, i)
            m = b.get_measurements(0.01)
            out.append(None if m is None else m)
    got_any = 0
    for a, b in zip(*popped):
        assert (a is None) == (b is None)
        if a is None:
            continue
        got_any += 1
        assert a[0] == b[0] and a[1] == b[1]
        for x, y in zip(a[2:], b[2:]):
            np.testing.assert_array_equal(x, y)
    assert got_any >= 3
    assert len(bufs[0]) == len(bufs[1])


def _jax_draws(seed, T, N):
    key = jax.random.key(seed)
    rows = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        rows.append(np.asarray(jax.random.uniform(sub, (N,))))
    return np.stack(rows)


def test_image_pipeline_matches_jax():
    jcfg, tcfg = _mini_cfg(jconfig), _mini_cfg(tconfig)
    sim = _sim(3.6)
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    # a dropped frame: its IMU goes to the next one, which then holds more
    # samples than the static block of 16
    drop = 24
    w, a, d = (np.concatenate([x, y]) for x, y in zip(groups[drop],
                                                      groups[drop + 1]))
    groups[drop + 1] = (w, a, d)
    assert len(w) > jcfg.tpu.imu_block
    frames = [k for k in range(len(sim.frame_t)) if k != drop]
    jp = JaxPipeline(jcfg, dtype=jnp.float64)
    tp = ImagePipeline(tcfg, dtype=torch.float64, device="cpu",
                       uniforms=_jax_draws(0, len(frames), 48))
    n_out = 0
    for k in frames:
        img = _u8(jcfg, sim, k)
        ref = jp.process(sim.frame_t[k], img, *groups[k])
        got = tp.process(sim.frame_t[k], img, *groups[k])
        assert (ref is None) == (got is None), k
        if ref is None:
            continue
        n_out += 1
        for key in ("n_good", "n_usable", "tl_good_sum", "did_update"):
            assert int(got[key]) == int(ref[key]), (k, key)
        np.testing.assert_allclose(got["p_Gk"].numpy(),
                                   np.asarray(ref["p_Gk"]), rtol=0, atol=1e-8)
        np.testing.assert_allclose(got["q_kG"].numpy(),
                                   np.asarray(ref["q_kG"]), rtol=0, atol=1e-8)
    assert n_out >= 10 and tp.n_tracked == n_out


def _feed(drv, cfg, sim, frames, pipelined):
    """tests/test_online.py's feed: a frame's IMU, then its image, then a
    spin; returns the outputs in order."""
    imu_done, outs = 0, []
    for k, t in enumerate(sim.frame_t):
        end = int(np.searchsorted(sim.imu_t, t, side="right"))
        for j in range(imu_done, end):
            drv.push_imu(sim.imu_t[j], sim.imu_w[j], sim.imu_a[j], seq=j)
        imu_done = end
        drv.push_image(t, frames[k], seq=k)
        got = drv.spin_once_pipelined() if pipelined else drv.spin_once()
        if got is not None:
            outs.append(got)
    if pipelined:
        last = drv.drain()
        if last is not None:
            outs.append(last)
    return outs


@pytest.fixture(scope="module")
def streamed():
    cfg = _mini_cfg(tconfig)
    sim = _sim(4.0)
    frames = [_u8(cfg, sim, k) for k in range(len(sim.frame_t))]
    ref = run_rendered_sequence_scan(cfg, sim, dtype=torch.float64,
                                     device="cpu", seed=4)
    return cfg, sim, frames, ref


@pytest.mark.parametrize("pipelined", [False, True])
def test_online_driver_matches_scan(streamed, pipelined):
    cfg, sim, frames, ref = streamed
    drv = OnlineDriver(cfg, dtype=torch.float64, seed=4, device="cpu")
    outs = _feed(drv, cfg, sim, frames, pipelined)
    assert drv.drops == {"imu": 0, "image": 0}
    m = len(outs)
    assert m >= len(ref.timestamps) - 1 and m > 15
    np.testing.assert_array_equal([o["t"] for o in outs], ref.timestamps[:m])
    np.testing.assert_array_equal([o["n_good"] for o in outs],
                                  ref.n_good[:m])
    np.testing.assert_allclose(np.stack([o["p_Gk"] for o in outs]),
                               ref.positions[:m], rtol=0, atol=1e-12)
    assert [p[0] for p in drv.poses] == [o["t"] for o in outs]


def test_online_drop_detection_and_recovery():
    """Dropped image messages are counted (seq gap) and the filter keeps
    tracking through them (tests/test_online.py:82-109)."""
    cfg = _mini_cfg(tconfig)
    sim = _sim(7.0)
    drv = OnlineDriver(cfg, dtype=torch.float64, device="cpu")
    dropped = {25, 26, 40}
    events = ([("imu", t, i) for i, t in enumerate(sim.imu_t)]
              + [("img", t, i) for i, t in enumerate(sim.frame_t)])
    events.sort(key=lambda e: e[1])
    for kind, t, i in events:
        if kind == "imu":
            drv.push_imu(t, sim.imu_w[i], sim.imu_a[i], seq=i)
        elif i not in dropped:
            drv.push_image(t, _u8(cfg, sim, i), seq=i)
    while drv.spin_once() is not None or len(drv.buffer) > 0:
        pass
    assert drv.drops == {"imu": 0, "image": 3}
    est_t = np.asarray([p[0] for p in drv.poses])
    est_p = np.asarray([p[1] for p in drv.poses])
    assert len(est_p) > 30
    idx = np.searchsorted(sim.frame_t, est_t)
    ate = ate_rmse(est_p, sim.gt_p[idx])
    assert ate < 0.25, f"ATE {ate:.3f} m after dropped frames"
