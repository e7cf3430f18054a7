"""The port's tracker and images -> poses driver against the JAX package.

f64 on the CPU at the small image config of tests/test_tracker_images.py
(320x240 frames, N = 40 slots, L = 8), with the equalizer (CLAHE) off and
on, the same on both sides.  Both sides get the JAX chain's RANSAC draws:
``key, sub = jax.random.split(key)`` then ``jax.random.uniform(sub, (N,))``
per frame.

- tracker: init_fn plus 12 track_fn frames on rendered frames; every
  TrackerState field, every UpdateBatch and the debug counters agree to
  1e-10 (masks, lengths and slots exactly);
- images -> poses: about 30 filtered frames through
  ``run_rendered_sequence_scan``; positions agree to 1e-8 m, n_good and
  the acceptance counters exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvio_tpu import config as jconfig
from rvio_tpu.dataio.synthetic import render_frame, simulate_sequence
from rvio_tpu.frontend.tracker import make_tracker as jax_make_tracker
from rvio_tpu.runtime.driver import bundle_imu
from rvio_tpu.runtime.image_driver import \
    run_rendered_sequence_scan as jax_run_rendered
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.frontend import make_tracker
from rvio_tpu_torch.runtime import run_rendered_sequence_scan
from rvio_tpu_torch.runtime.image_driver import (_find_init_frame,
                                                 uniform_table)

torch.set_num_threads(1)
N_FRAMES = 12


def _cfg(mod, equalizer=False):
    return mod.RVIOConfig(
        imu=mod.ImuConfig(rate_hz=100.0),
        camera=mod.CameraConfig(fps=10.0, width=320, height=240, fx=200.0,
                                fy=200.0, cx=160.0, cy=120.0, k1=-0.05,
                                k2=0.01, p1=0.0, p2=0.0),
        tracker=mod.TrackerConfig(num_features=40, max_tracking_length=8,
                                  min_tracking_length=3, min_distance=12.0,
                                  block_size_x=80, block_size_y=60,
                                  enable_equalizer=equalizer),
        init=mod.InitConfig(sigma_v0=0.1),
        tpu=mod.TpuConfig(imu_block=16))


def jax_draws(seed, T, N):
    """The uniforms the JAX drivers' key chain feeds RANSAC, (T, N)."""
    key = jax.random.key(seed)
    rows = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        rows.append(np.asarray(jax.random.uniform(sub, (N,))))
    return np.stack(rows)


@pytest.fixture(scope="module", params=[False, True],
                ids=["equalizer_off", "equalizer_on"])
def tracked(request):
    jcfg, tcfg = (_cfg(jconfig, request.param),
                  _cfg(tconfig, request.param))
    sim = simulate_sequence(jcfg, duration=4.0, static_time=1.0, seed=5,
                            n_landmarks=300, motion_scale=0.6)
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    N, K = jcfg.tracker.num_features, jcfg.tpu.imu_block
    j_init, j_track = jax_make_tracker(jcfg, jnp.float64)
    t_init, t_track = make_tracker(tcfg, device="cpu", dtype=torch.float64)
    k0 = 12
    img = render_frame(jcfg, sim, k0)
    js, jn = j_init(jnp.asarray(img))
    ts, tn = t_init(torch.as_tensor(img))
    out = [(js, ts, None, None, None, None)]
    draws = jax_draws(0, N_FRAMES, N)
    key = jax.random.key(0)
    for i, k in enumerate(range(k0 + 1, k0 + 1 + N_FRAMES)):
        img = render_frame(jcfg, sim, k)
        w, a, dts = groups[k]
        pad = K - len(w)
        wn = np.pad(w, ((0, pad), (0, 0)))
        dn = np.pad(dts, (0, pad))
        vn = np.arange(K) < len(w)
        key, sub = jax.random.split(key)
        js, jb, jd = j_track(js, jnp.asarray(img), jnp.asarray(wn),
                             jnp.asarray(dn), jnp.asarray(vn), sub)
        ts, tb, td = t_track(ts, torch.as_tensor(img), torch.as_tensor(wn),
                             torch.as_tensor(dn), torch.as_tensor(vn),
                             torch.as_tensor(draws[i]))
        out.append((js, ts, jb, tb, jd, td))
    return out, int(jn), int(tn)


FIELDS = ("pos", "hist", "length", "active", "pyramid")


@pytest.mark.parametrize("field", FIELDS)
def test_tracker_state_matches_jax(tracked, field):
    frames, jn, tn = tracked
    assert jn == tn > 15
    for f, (js, ts, *_rest) in enumerate(frames):
        a, b = getattr(js, field), getattr(ts, field)
        if field == "pyramid":
            for x, y in zip(a, b):
                np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0,
                                           atol=1e-10)
        elif field in ("length", "active"):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"frame {f}")
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-10, err_msg=f"frame {f}")


def test_update_batches_match_jax(tracked):
    frames, _, _ = tracked
    n_valid = 0
    for f, (_, _, jb, tb, jd, td) in enumerate(frames[1:]):
        for name in ("track_len", "is_type2", "valid"):
            np.testing.assert_array_equal(
                getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                err_msg=f"frame {f} {name}")
        np.testing.assert_allclose(tb.meas.numpy(), np.asarray(jb.meas),
                                   rtol=0, atol=1e-10)
        for name in ("n_tracked", "n_lost", "n_new"):
            assert int(td[name]) == int(jd[name]), (f, name)
        np.testing.assert_allclose(td["klt_err"].numpy(),
                                   np.asarray(jd["klt_err"]), rtol=0,
                                   atol=1e-10)
        n_valid += int(tb.valid.sum())
    assert n_valid > 0
    # the tracker really tracks: most active slots survive each frame
    assert np.mean([int(d["n_tracked"]) for *_x, d in frames[1:]]) > 10


def test_uniform_table_prefix():
    a = uniform_table(3, 5, 7)
    b = uniform_table(3, 9, 7)
    assert a.dtype == torch.float64 and tuple(a.shape) == (5, 7)
    assert torch.equal(a, b[:5])
    assert ((b >= 0) & (b < 1)).all()


@pytest.mark.parametrize("equalizer", [False, True])
def test_images_to_poses_matches_jax(equalizer):
    jcfg, tcfg = _cfg(jconfig, equalizer), _cfg(tconfig, equalizer)
    sim = simulate_sequence(jcfg, duration=6.0, static_time=1.0,
                            ramp_time=1.5, seed=6, n_landmarks=400,
                            motion_scale=0.5)
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    _, k0 = _find_init_frame(tcfg, groups, len(sim.frame_t), torch.float64,
                             "cpu")
    n = k0 + 1 + 32
    ref = jax_run_rendered(jcfg, sim, dtype=jnp.float64, chunk_size=16,
                           max_frames=n)
    got = run_rendered_sequence_scan(
        tcfg, sim, dtype=torch.float64, device="cpu", chunk_size=16,
        max_frames=n, uniforms=jax_draws(0, 32, 40))
    assert len(got.timestamps) == len(ref.timestamps) >= 30
    np.testing.assert_array_equal(got.timestamps, ref.timestamps)
    np.testing.assert_array_equal(got.n_good, ref.n_good)
    assert got.n_good.sum() > 0
    for k in ("n_tracked", "n_lost", "n_new", "n_usable", "tl_good_sum"):
        np.testing.assert_array_equal(got.diag[k], ref.diag[k], err_msg=k)
    np.testing.assert_allclose(got.positions, ref.positions, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.quaternions, ref.quaternions, rtol=0,
                               atol=1e-8)
    assert got.acceptance_stats() == pytest.approx(ref.acceptance_stats(),
                                                   abs=1e-12)
