"""The port's segment-batched filter against the JAX package (f64, CPU).

- ``make_batched_sequence_scan`` at B = 2 (seeds 3 and 4, 8 s, the small
  config of tests/test_parallel.py): each row against the JAX function's
  row at 1e-8 m and against the port's single-sequence scan (which
  composes the window chain in its parallel form, the batched scan in its
  sequential form, as in the JAX package), the port of
  tests/test_parallel.py TestBatchedSequenceScan; the second sequence has
  no valid features for five frames, so the rows take different update
  decisions there and the per-segment gate is exercised;
- at B = 1 the batched scan is the single scan, bitwise, where both
  compose the window chain in the same form;
- the plain versions of K1 and K5 at B = 3 are three B = 1 calls, bitwise;
- ``stack_states`` and ``state_from_numpy`` of a stacked JAX state give
  the same batched state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_bundles
from rvio_tpu import config as jconfig
from rvio_tpu.dataio.synthetic import simulate_sequence
from rvio_tpu.parallel.segment import stack_states as jax_stack_states
from rvio_tpu.runtime.step import \
    make_batched_sequence_scan as jax_batched_scan
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.filter.propagation import ImuBlock
from rvio_tpu_torch.filter.update import UpdateBatch
from rvio_tpu_torch.ops.ekf_tail import ekf_tail_plain
from rvio_tpu_torch.ops.propagate_block import propagate_block_plain
from rvio_tpu_torch.parallel import stack_states
from rvio_tpu_torch.runtime import (FrameBundle, make_batched_sequence_scan,
                                    make_sequence_scan)
from rvio_tpu_torch.state import state_from_numpy, state_to_numpy

torch.set_num_threads(1)
F64 = torch.float64
SEEDS = (3, 4)
GAP = slice(30, 35)    # frames where the second sequence has no features


def small_cfg(mod, **tpu):
    """tests/test_parallel.py's small config."""
    return mod.RVIOConfig(
        imu=mod.ImuConfig(rate_hz=100.0), camera=mod.CameraConfig(fps=10.0),
        tracker=mod.TrackerConfig(num_features=24, max_tracking_length=6,
                                  min_tracking_length=3),
        tpu=mod.TpuConfig(imu_block=16, **tpu))


def jax_state_np(st) -> dict:
    return {k: np.asarray(v) for k, v in st.__dict__.items()}


def port_bundles(jb, device="cpu") -> FrameBundle:
    """A JAX FrameBundle's arrays (any leading axes) as the port's."""
    def t(x, dtype=None):
        x = torch.as_tensor(np.array(x), device=device)
        return x if dtype is None else x.to(dtype)

    return FrameBundle(
        imu=ImuBlock(w=t(jb.imu.w), a=t(jb.imu.a), dt=t(jb.imu.dt),
                     valid=t(jb.imu.valid)),
        batch=UpdateBatch(meas=t(jb.batch.meas),
                          track_len=t(jb.batch.track_len, torch.int64),
                          is_type2=t(jb.batch.is_type2),
                          valid=t(jb.batch.valid)))


@pytest.fixture(scope="module")
def two_sequences():
    """The two seeded sequences, cut to a common length T: JAX's init
    states and bundles (the inputs both packages take)."""
    cfg = small_cfg(jconfig)
    sims = [simulate_sequence(cfg, duration=8.0, static_time=1.0, seed=s,
                              meas_noise=5e-4, imu_noise=True)
            for s in SEEDS]
    built = [build_bundles(cfg, sim, jnp.float64) for sim in sims]
    T = min(b[1].imu.w.shape[0] for b in built)
    states = [b[0] for b in built]
    bundles = [jax.tree.map(lambda x: x[:T], b[1]) for b in built]
    # Both seeds update on every frame from the same frame on; the second
    # loses its features for five frames, so the rows' gates must part.
    b1 = bundles[1]
    valid = np.asarray(b1.batch.valid).copy()
    valid[GAP] = False
    bundles[1] = b1.__class__(imu=b1.imu, batch=b1.batch.__class__(
        meas=b1.batch.meas, track_len=b1.batch.track_len,
        is_type2=b1.batch.is_type2, valid=jnp.asarray(valid)))
    return states, bundles


def test_batched_scan_matches_jax_and_single_scan(two_sequences):
    jstates, jbundles = two_sequences
    B = len(jstates)
    vrun = jax_batched_scan(small_cfg(jconfig))
    jstacked = jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *jbundles)
    _, jout = vrun(jax_stack_states(jstates), jstacked)

    tcfg = small_cfg(tconfig)
    run = make_batched_sequence_scan(tcfg, "cpu", F64)
    states = stack_states([state_from_numpy(jax_state_np(s), "cpu", F64)
                           for s in jstates])
    final, out = run(states, port_bundles(jstacked))
    T = jbundles[0].imu.w.shape[0]
    assert out["p_Gk"].shape == (B, T, 3) and final.P.shape[0] == B
    single = make_sequence_scan(tcfg, "cpu", F64)
    for s in range(B):
        np.testing.assert_allclose(out["p_Gk"][s].numpy(),
                                   np.asarray(jout["p_Gk"][s]), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(out["q_kG"][s].numpy(),
                                   np.asarray(jout["q_kG"][s]), rtol=0,
                                   atol=1e-8)
        np.testing.assert_array_equal(out["n_good"][s].numpy(),
                                      np.asarray(jout["n_good"][s]))
        _, one = single(state_from_numpy(jax_state_np(jstates[s]), "cpu",
                                         F64),
                        port_bundles(jbundles[s]))
        np.testing.assert_allclose(out["p_Gk"][s].numpy(),
                                   one["p_Gk"].numpy(), rtol=0, atol=1e-8)
        np.testing.assert_array_equal(out["did_update"][s].numpy(),
                                      one["did_update"].numpy())
    # the rows take their own update decisions
    assert bool(out["did_update"][0, GAP].all())
    assert not bool(out["did_update"][1, GAP].any())


def test_batch_of_one_is_the_single_scan_bitwise(two_sequences):
    """Where both compose the window chain sequentially, the batched scan
    at B = 1 is the single scan: the same body at the same shapes."""
    jstates, jbundles = two_sequences
    cfg = small_cfg(tconfig, parallel_propagation=False)
    st = state_from_numpy(jax_state_np(jstates[0]), "cpu", F64)
    bd = port_bundles(jbundles[0])
    f1, o1 = make_sequence_scan(cfg, "cpu", F64)(st, bd)
    fb, ob = make_batched_sequence_scan(cfg, "cpu", F64)(
        stack_states([st]), port_bundles(jax.tree.map(lambda x: x[None],
                                                      jbundles[0])))
    assert o1.keys() == ob.keys()
    for k in o1:
        assert torch.equal(ob[k][0], o1[k]), k
    a, b = state_to_numpy(fb), state_to_numpy(f1)
    for k in a:
        np.testing.assert_array_equal(a[k][0], b[k], err_msg=k)


def _k1_inputs(rng, B, K=16):
    from rvio_tpu_torch.core.so3 import rodrigues_np
    out = []
    for _ in range(B):
        A = rng.normal(size=(24, 24)) * 0.01
        ax = rng.normal(size=3)
        g = np.array([0.05, -0.02, 0.998]) + rng.normal(size=3) * 0.01
        out.append([rng.normal(size=(K, 3)) * 0.4,
                    rng.normal(size=(K, 3)) * 2.0 + [0, 0, 9.8],
                    np.where(np.arange(K) < rng.integers(1, K), 0.005, 0.0),
                    rodrigues_np(ax / np.linalg.norm(ax), 1.0),
                    rng.normal(size=3), g / np.linalg.norm(g),
                    rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.05,
                    A @ A.T + np.eye(24) * 1e-4])
    return [torch.as_tensor(np.stack(x)) for x in zip(*out)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_k1_batch_is_single_calls(dtype):
    args = [x.to(dtype) for x in _k1_inputs(np.random.default_rng(5), 3)]
    kw = dict(gravity=9.81, small_angle=1e-6, sigma_g=1e-3, sigma_wg=1e-4,
              sigma_a=1e-2, sigma_wa=1e-3)
    whole = propagate_block_plain(*args, **kw)
    for b in range(3):
        one = propagate_block_plain(*(x[b:b + 1] for x in args), **kw)
        for x, y in zip(whole, one):
            assert torch.equal(x[b:b + 1], y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_k5_batch_is_single_calls(dtype):
    rng = np.random.default_rng(6)
    n, D = 30, 54
    Cs, bs, Ps = [], [], []
    for _ in range(3):
        H = rng.normal(size=(40, n)) * 0.5
        H[:, 24:] = 0                     # invalid clones: zero columns
        A = rng.normal(size=(D, D)) * 0.05
        Cs.append(H.T @ H)
        bs.append(H.T @ rng.normal(size=40) * 0.01)
        Ps.append(A @ A.T + 1e-4 * np.eye(D))
    C, b, P = (torch.as_tensor(np.stack(x)).to(dtype) for x in (Cs, bs, Ps))
    sig2 = torch.tensor([1e-4, 2e-4, 3e-4], dtype=dtype)
    whole = ekf_tail_plain(C, b, P, sig2)
    for i in range(3):
        one = ekf_tail_plain(C[i:i + 1], b[i:i + 1], P[i:i + 1],
                             sig2[i:i + 1])
        for x, y in zip(whole, one):
            assert torch.equal(x[i:i + 1], y)


def test_stack_states_and_state_from_numpy(two_sequences):
    """A stack of JAX states, as numpy, is the port's stack of the same
    states; and it round-trips through state_to_numpy."""
    jstates, _ = two_sequences
    jst = jax_stack_states(list(jstates) + [jstates[0]])
    from_stack = state_from_numpy(jax_state_np(jst), "cpu", F64)
    stacked = stack_states([state_from_numpy(jax_state_np(s), "cpu", F64)
                            for s in list(jstates) + [jstates[0]]])
    assert from_stack.batched and from_stack.max_clones == \
        small_cfg(tconfig).window_size
    a, b = state_to_numpy(from_stack), state_to_numpy(stacked)
    ref = jax_state_np(jst)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a[k], ref[k], err_msg=k)
        assert a[k].dtype == ref[k].dtype, k
