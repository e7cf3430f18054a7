"""The port's warm segment handoff against rvio_tpu/parallel/handoff.py
(f64, CPU), on the same numpy inputs:

- ``bootstrap_velocity_gravity`` at 1e-10, a window without structure
  returning None in both;
- ``warm_initialize``, with bootstrap values and its fallback, at 1e-12;
- ``segment_plan`` exactly;
- ``make_masked_segment_scan`` with masked leading rows at 1e-8 m, the
  masked frames leaving each segment's state as it was;
- ``run_segments_warm`` on a 40 s sequence split into 4 segments with a
  60-frame warm-up: stitched positions at 1e-6 m, the same repaired
  segments and the same bootstrap decisions; then with one segment's body
  frames stripped of their features, so the repair pass runs in both; a
  ``mesh`` whose ``seg`` axis does not divide the segments refused (the
  mesh runs themselves: tests/test_torch_mesh.py and
  tests/test_torch_parallel_mp.py);
- ``msckf_update`` with ``adaptive_noise`` and ``adaptive_rampup > 0``
  (the warm split's setting), one filter and a batch of two, against
  JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_bundles
from rvio_tpu import config as jconfig
from rvio_tpu.dataio.synthetic import simulate_sequence
from rvio_tpu.filter import update as jupd
from rvio_tpu.parallel import handoff as jhand
from rvio_tpu.parallel.segment import stack_states as jax_stack_states
from rvio_tpu.state import FilterState as JState
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.filter.update import UpdateBatch, msckf_update
from rvio_tpu_torch.parallel import (bootstrap_velocity_gravity,
                                     make_masked_segment_scan,
                                     run_segments_warm, segment_plan,
                                     stack_states, warm_initialize)
from rvio_tpu_torch.state import state_from_numpy, state_to_numpy
from test_torch_batched import jax_state_np, port_bundles, small_cfg
from test_torch_update import R_BC, SIGMA, T_BC, _scene

torch.set_num_threads(1)
F64 = torch.float64
S, W = 4, 60          # segments and warm-up frames of the split cases


@pytest.fixture(scope="module")
def drive():
    """A 40 s sequence: JAX's init state and stacked bundles."""
    cfg = small_cfg(jconfig)
    sim = simulate_sequence(cfg, duration=40.0, static_time=1.0, seed=5,
                            meas_noise=5e-4, imu_noise=True)
    state0, bundles, _ = build_bundles(cfg, sim, jnp.float64)
    return state0, bundles


def _host(bundles):
    b = bundles
    return [np.asarray(x) for x in (b.imu.w, b.imu.a, b.imu.dt, b.imu.valid,
                                    b.batch.meas, b.batch.track_len,
                                    b.batch.valid)]


@pytest.mark.parametrize("w0", [40, 150, 260, 385])
def test_bootstrap_matches_jax(drive, w0):
    _, bundles = drive
    arrays = _host(bundles)
    got = bootstrap_velocity_gravity(small_cfg(tconfig), *arrays, w0, 30)
    ref = jhand.bootstrap_velocity_gravity(small_cfg(jconfig), *arrays, w0,
                                           30)
    assert (got is None) == (ref is None)
    if w0 == 385:          # one frame: no track ends in the window
        assert got is None
        return
    for x, y in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-10)
    assert got[2].keys() == ref[2].keys()
    for k in got[2]:
        np.testing.assert_allclose(got[2][k], ref[2][k], rtol=1e-10)


@pytest.mark.parametrize("boot,align", [(True, True), (False, True),
                                        (False, False)])
def test_warm_initialize_matches_jax(boot, align):
    kw = dict(v0=np.array([0.3, -0.1, 0.05]),
              g0=np.array([0.05, -0.02, 0.998]) / np.linalg.norm(
                  [0.05, -0.02, 0.998]),
              sigma_g0=0.1, sigma_v0=0.4) if boot else {}
    a0 = np.array([0.5, 0.2, 9.7])
    jcfg, tcfg = small_cfg(jconfig), small_cfg(tconfig)
    if not align:
        jcfg = jcfg.replace(init=dataclasses.replace(
            jcfg.init, enable_alignment=False))
        tcfg = tcfg.replace(init=dataclasses.replace(
            tcfg.init, enable_alignment=False))
    got = state_to_numpy(warm_initialize(tcfg, a0, F64, "cpu", **kw))
    ref = jax_state_np(jhand.warm_initialize(jcfg, a0, jnp.float64, **kw))
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-12,
                                   err_msg=k)
        assert got[k].shape == ref[k].shape, k
    if not boot:
        assert got["g"][2] > 0.99 and got["P"][15, 15] > 0.5


@pytest.mark.parametrize("T,n,w", [(100, 4, 10), (386, 4, 60), (7, 3, 5),
                                   (3000, 8, 150), (10, 1, 0)])
def test_segment_plan_matches_jax(T, n, w):
    got, ref = segment_plan(T, n, w), jhand.segment_plan(T, n, w)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2] and got[0].dtype == ref[0].dtype


def test_masked_segment_scan_matches_jax(drive):
    """Two segments of 50 frames from the init state, the second's first
    20 frames masked out: every output at 1e-8, and the final states."""
    state0, bundles = drive
    n, skip = 50, 20
    jb = jax.tree.map(lambda x: jnp.stack([x[:n], x[:n]]), bundles)
    ok = np.ones((2, n), bool)
    ok[1, :skip] = False
    jst = jax_stack_states([state0, state0])
    jf, jo = jhand.make_masked_segment_scan(small_cfg(jconfig))(
        jst, jb, jnp.asarray(ok))
    run = make_masked_segment_scan(small_cfg(tconfig), "cpu", F64)
    tf, to = run(state_from_numpy(jax_state_np(jst), "cpu", F64),
                 port_bundles(jb), torch.as_tensor(ok))
    for k in ("p_Gk", "q_kG", "v_k"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), rtol=0,
                                   atol=1e-8, err_msg=k)
    np.testing.assert_array_equal(to["n_good"].numpy(),
                                  np.asarray(jo["n_good"]))
    np.testing.assert_array_equal(to["ok"].numpy(), ok)
    got, ref = state_to_numpy(tf), jax_state_np(jf)
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-8,
                                   err_msg=k)
    # the masked rows kept segment 1 at the init state: it ran 30 frames
    assert got["frame_idx"].tolist() == [n, n - skip]


def _split_case(drive, strip_segment=None):
    state0, bundles = drive
    if strip_segment is not None:
        # the segment's body frames lose every feature: its filter
        # dead-reckons, and the repair pass re-runs it
        T = bundles.imu.w.shape[0]
        _, _, B = segment_plan(T, S, W)
        valid = np.asarray(bundles.batch.valid).copy()
        valid[strip_segment * B:(strip_segment + 1) * B] = False
        bundles = dataclasses.replace(bundles, batch=dataclasses.replace(
            bundles.batch, valid=jnp.asarray(valid)))
    jres = jhand.run_segments_warm(small_cfg(jconfig), state0, bundles, S, W,
                                   dtype=jnp.float64)
    tres = run_segments_warm(
        small_cfg(tconfig), state_from_numpy(jax_state_np(state0), "cpu",
                                             F64),
        port_bundles(bundles), S, W, device="cpu")
    return jres, tres


def _assert_same_split(jres, tres):
    (jp, jo, ji), (tp, to, ti) = jres, tres
    assert tp.shape == jp.shape
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(to["n_good"].numpy(),
                                  np.asarray(jo["n_good"]))
    assert ti["repaired_segments"] == ji["repaired_segments"]
    for k in ("body_len", "warmup", "overlap_fit"):
        assert ti[k] == ji[k], k
    for d, e in zip(ti["bootstrap_diags"], ji["bootstrap_diags"]):
        assert (d is None) == (e is None)
        if d is not None:
            assert ("rejected" in d) == ("rejected" in e)
            if "sigma_v" in d:
                np.testing.assert_allclose(d["sigma_v"], e["sigma_v"],
                                           rtol=1e-8)


def test_run_segments_warm_matches_jax(drive):
    jres, tres = _split_case(drive)
    _assert_same_split(jres, tres)
    assert tres[2]["repaired_segments"] == []
    ok = tres[1]["ok"].numpy()
    ng = tres[1]["n_good"].numpy()
    assert all(ng[s][ok[s]].mean() > 3.0 for s in range(S))


def test_run_segments_warm_repair_matches_jax(drive):
    jres, tres = _split_case(drive, strip_segment=S - 1)
    _assert_same_split(jres, tres)
    assert tres[2]["repaired_segments"] == [S - 1]
    assert tres[2]["repair_scan"] is not None


class _Seg3Mesh:
    """A (3, 1) mesh's coordinates on the CPU, without ranks."""

    device_type = "cpu"

    def size(self, dim):
        return (3, 1)[dim]

    def get_local_rank(self, name):
        return 0


def test_run_segments_warm_refuses_mesh(drive):
    state0, bundles = drive
    with pytest.raises(ValueError, match="do not divide over seg=3"):
        run_segments_warm(small_cfg(tconfig),
                          state_from_numpy(jax_state_np(state0), "cpu", F64),
                          port_bundles(bundles), S, W, mesh=_Seg3Mesh())


def _update_inputs(seed):
    d, (meas, tlen, typ2, valid) = _scene(seed=seed, noise=5e-4)
    return d, dict(meas=meas, track_len=tlen, is_type2=typ2, valid=valid)


@pytest.mark.parametrize("rampup", [4, 40])
def test_msckf_update_adaptive_rampup_matches_jax(rampup):
    """The adaptive-noise EMA in the warm-start regime: the downward step
    ramps with the frame age (frame_idx 10: 10/40 of it at rampup 40, all
    of it at 4) and the mass-rejection escape is off; one filter and a
    batch of two scenes, each against JAX's call."""
    kw = dict(R_bc=R_BC, t_bc=T_BC, sigma_im=SIGMA, min_clone_states=2,
              compression="cholesky", adaptive_noise=True,
              adaptive_rampup=rampup)
    scenes = [_update_inputs(s) for s in (26, 27)]
    refs = []
    for d, b in scenes:
        jst, jdiag = jupd.msckf_update(
            JState(**{k: jnp.asarray(v) for k, v in d.items()}),
            jupd.UpdateBatch(**{k: jnp.asarray(v) for k, v in b.items()}),
            **kw)
        refs.append((jax_state_np(jst), jdiag))
    assert refs[0][0]["sigma2_scale"] != scenes[0][0]["sigma2_scale"]

    def port_batch(bs):
        return UpdateBatch(
            meas=torch.as_tensor(np.stack([b["meas"] for b in bs])),
            track_len=torch.as_tensor(np.stack([b["track_len"] for b in bs])
                                      ).long(),
            is_type2=torch.as_tensor(np.stack([b["is_type2"] for b in bs])),
            valid=torch.as_tensor(np.stack([b["valid"] for b in bs])))

    one, _ = msckf_update(state_from_numpy(scenes[0][0], "cpu", F64),
                          UpdateBatch(**{k: v[0] for k, v in vars(port_batch(
                              [scenes[0][1]])).items()}), **kw)
    two, diag = msckf_update(
        stack_states([state_from_numpy(d, "cpu", F64) for d, _ in scenes]),
        port_batch([b for _, b in scenes]), **kw)
    got1, got2 = state_to_numpy(one), state_to_numpy(two)
    for k in got1:
        np.testing.assert_allclose(got1[k], refs[0][0][k], rtol=0,
                                   atol=1e-10, err_msg=k)
        for s in range(2):
            np.testing.assert_allclose(got2[k][s], refs[s][0][k], rtol=0,
                                       atol=1e-10, err_msg=k)
    for s in range(2):
        assert bool(diag["did_update"][s]) == bool(refs[s][1]["did_update"])
        assert int(diag["n_good"][s]) == int(refs[s][1]["n_good"])
