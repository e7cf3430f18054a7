"""K5, the fused EKF tail, and the filter's fused branch on the CPU.

- ``ekf_tail_plain`` (f32) against ``ekf_tail_pallas(interpret=True)`` on
  the cases of tests/test_ops.py::TestEkfTailKernel at its tolerances, and
  a batch of three against three single calls;
- ``ekf_tail_plain`` in f64 against that test's oracle chain in f64 (1e-10);
- the fallback: on the 20 rank-deficient C of
  tests/test_torch_update.py::test_info_ridge_keeps_f32_cholesky_finite the
  plain version flags exactly where ``info_cholesky`` does, and its dx and
  P_new are the unfused chain's, bitwise;
- K5's check (ops/checks.ekf_tail_case) refuses a P_new without sig2 K K^T,
  which the error relative to P_new's largest entry alone lets through;
- ``msckf_update`` (whose Cholesky branch always calls ``ekf_tail``) in f64
  against the JAX package's with ``ekf_tail_fused=True`` (whose flag runs
  the unfused chain off a TPU) at 1e-10 with the same gates, and in f32
  bitwise the update with the unfused chain called in its place.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rvio_tpu.filter.update as jupd
import test_ops
from rvio_tpu.ops.ekf_tail import ekf_tail_pallas
from rvio_tpu.state import FilterState as JState
import rvio_tpu_torch.filter.update as pupd
from rvio_tpu_torch.filter.update import UpdateBatch, msckf_update
from rvio_tpu_torch.ops.checks import (EKF_TAIL_FALLBACK_SCALED_TOL,
                                       EKF_TAIL_FALLBACK_TOL,
                                       EKF_TAIL_SCALED_TOL, ekf_tail_case,
                                       ekf_tail_fallback_inputs,
                                       ekf_tail_stack, scaled_cov_err)
from rvio_tpu_torch.ops.ekf_tail import (cholesky_tail, ekf_tail,
                                         ekf_tail_plain, info_cholesky,
                                         nan_cholesky)
from rvio_tpu_torch.state import state_from_numpy, state_to_numpy
from test_torch_update import R_BC, SIGMA, T_BC, M, _scene, _t

torch.set_num_threads(1)


def _batch(*xs, dtype=torch.float32):
    return tuple(torch.as_tensor(np.asarray(x)).to(dtype)[None] for x in xs)


def _scaled_close(got, ref, atol):
    s = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(np.asarray(got) / s, np.asarray(ref) / s,
                               rtol=0, atol=atol)


@pytest.mark.parametrize("M,n_rows,masked,dead,seed,atol", [
    (14, 3000, 0.5, 2, 1, 2e-5),       # test_flagship_shape
    (7, 320, 0.5, 2, 2, 2e-5),         # test_small_window
    (14, 200, 0.9, 6, 3, 5e-2),        # test_few_rows_heavy_masking
])
def test_plain_matches_pallas_interpret(M, n_rows, masked, dead, seed, atol):
    C, b, P, sig2 = ekf_tail_stack(np.random.default_rng(seed), M, n_rows,
                                   masked_frac=masked, dead_clones=dead)
    dx_k, P_k = ekf_tail_pallas(jnp.asarray(C), jnp.asarray(b),
                                jnp.asarray(P), jnp.float32(sig2),
                                interpret=True)
    dx, P_new, fb = ekf_tail(*_batch(C, b, P, sig2))
    assert dx.dtype == torch.float32 and not bool(fb[0])
    _scaled_close(dx[0].numpy(), dx_k, atol)
    _scaled_close(P_new[0].numpy(), P_k, atol)


def test_plain_batch_matches_single_calls():
    """B = 3 systems at once equal three calls of one (the batched slice's
    shape; tests/test_ops.py::test_batched_vmap vmaps the TPU kernel)."""
    rng = np.random.default_rng(5)
    cases = [ekf_tail_stack(rng, 7, 100, masked_frac=0.0) for _ in range(3)]
    C, b, P, sig2 = (np.stack(x) for x in zip(*cases))
    got = ekf_tail(*(torch.as_tensor(x) for x in (C, b, P, sig2)))
    for i, case in enumerate(cases):
        one = ekf_tail(*_batch(*case))
        for x, y in zip(got, one):
            assert torch.equal(x[i], y[0])


@pytest.mark.parametrize("M,n_rows,seed", [(14, 3000, 1), (7, 320, 2)])
def test_plain_f64_matches_oracle_chain(M, n_rows, seed):
    C, b, P, sig2 = (np.float64(x) for x in ekf_tail_stack(
        np.random.default_rng(seed), M, n_rows, dead_clones=2))
    dx_o, P_o = test_ops.TestEkfTailKernel._oracle(
        jnp.asarray(C), jnp.asarray(b), jnp.asarray(P), jnp.float64(sig2))
    assert dx_o.dtype == jnp.float64
    dx, P_new, fb = ekf_tail(*_batch(C, b, P, sig2, dtype=torch.float64))
    assert not bool(fb[0])
    _scaled_close(dx[0].numpy(), dx_o, 1e-10)
    _scaled_close(P_new[0].numpy(), P_o, 1e-10)


def test_plain_fallback_is_the_unfused_chain():
    rng_p = np.random.default_rng(99)
    G = rng_p.normal(size=(108, 108)) * 0.02
    P = torch.as_tensor(G @ G.T + 1e-4 * np.eye(108), dtype=torch.float32)
    sig2 = torch.tensor(2.3e-6)
    fell_back = 0
    for seed in range(20):
        rng = np.random.default_rng(seed)
        A = rng.normal(size=(81, 84))
        A[:, 1] = 1.5 * A[:, 0]
        A[:, :2] *= 30.0
        C = torch.as_tensor(A.T @ A).float()
        b = torch.as_tensor(A.T @ rng.normal(size=81) * 0.01).float()
        dx, P_new, fb = ekf_tail_plain(C[None], b[None], P[None], sig2[None])
        _, want_fb = info_cholesky(C)
        assert bool(fb[0]) == bool(want_fb)
        ref = cholesky_tail(C, b, P, sig2)
        assert torch.equal(dx[0], ref[0]) and torch.equal(P_new[0], ref[1])
        assert torch.isfinite(dx).all() and torch.isfinite(P_new).all()
        fell_back += bool(fb[0])
    assert fell_back > 0


def _without_noise_term(C, b, P, sig2):
    """The chain with sig2 K K^T left out of the Joseph form: a planted
    fault in the small, well-observed blocks of P_new."""
    C, b, P, sig2 = C[0], b[0], P[0], sig2[0]
    Lc, fallback = info_cholesky(C)
    rn = torch.linalg.solve_triangular(Lc, b[:, None], upper=False)[:, 0]
    Hn = torch.cat([torch.zeros(C.shape[0], 24), Lc.T], dim=1)
    PHt = P @ Hn.T
    S = Hn @ PHt + sig2 * torch.eye(C.shape[0])
    K = torch.cholesky_solve(PHt.T, nan_cholesky(0.5 * (S + S.T))).T
    I_KH = torch.eye(P.shape[0]) - K @ Hn
    P_new = I_KH @ P @ I_KH.T
    return (K @ rn)[None], (0.5 * (P_new + P_new.T))[None], fallback[None]


@pytest.mark.parametrize("case", ["stack", "wider_ridge"])
def test_check_refuses_p_new_without_noise_term(case):
    """K5's check against a kernel whose P_new lacks sig2 K K^T: the error
    scaled by P_new's diagonal refuses it (on the stack the error relative
    to the largest entry alone would not), while the f32 chain's rounding
    against f64 stays far inside the scaled limit."""
    if case == "stack":
        inputs = ekf_tail_stack(np.random.default_rng(0), 14, 3000)
        tol, scaled_tol = 2e-5, EKF_TAIL_SCALED_TOL
    else:
        inputs = ekf_tail_fallback_inputs(np.random.default_rng(0))
        tol, scaled_tol = EKF_TAIL_FALLBACK_TOL, EKF_TAIL_FALLBACK_SCALED_TOL
    chk = ekf_tail_case("cpu", *inputs, tol=tol, what=case,
                        scaled_tol=scaled_tol)
    assert chk.check() == 0.0                # on the CPU both are the plain
    plain = chk.run_plain()
    bad = _without_noise_term(*chk.args)
    assert torch.equal(bad[2], plain[2])
    ref = plain[1].double().numpy()
    assert scaled_cov_err(bad[1].double().numpy(), ref) > 0.5
    if case == "stack":
        assert (np.abs(bad[1].numpy() - ref).max() / np.abs(ref).max()
                < tol)
    with pytest.raises(AssertionError, match="scaled by sqrt"):
        chk.compare(bad, plain)
    # the chain in f64 with the ridge the f32 factor took
    C64, b64, P64, s64 = (a[0].double() for a in chk.args)
    if bool(plain[2][0]):
        n = C64.shape[-1]
        C64 = C64 + (n * float(np.finfo(np.float32).eps) - 1e-8) * max(
            float(torch.trace(C64)), 1.0) * torch.eye(n, dtype=torch.float64)
    P_64 = cholesky_tail(C64, b64, P64, s64)[1].numpy()
    assert scaled_cov_err(ref[0], P_64) < scaled_tol / 5


def _update(d, batch, dtype, **kw):
    meas, tlen, typ2, valid = batch
    return msckf_update(
        state_from_numpy(d, "cpu", dtype),
        UpdateBatch(meas=_t(meas, dtype), track_len=_t(tlen, torch.int64),
                    is_type2=torch.tensor(typ2), valid=torch.tensor(valid)),
        **kw)


@pytest.mark.parametrize("fej,adaptive,seed", [(False, True, 26),
                                               (True, False, 1)])
def test_fused_update_matches_jax_f64(fej, adaptive, seed):
    d, batch = _scene(seed=seed, noise=5e-4)
    meas, tlen, typ2, valid = batch
    kw = dict(R_bc=R_BC, t_bc=T_BC, sigma_im=SIGMA, min_clone_states=2,
              compression="cholesky", fej=fej, adaptive_noise=adaptive)
    jst, jdiag = jupd.msckf_update(
        JState(**{k: jnp.asarray(v) for k, v in d.items()}),
        jupd.UpdateBatch(meas=jnp.asarray(meas), track_len=jnp.asarray(tlen),
                         is_type2=jnp.asarray(typ2), valid=jnp.asarray(valid)),
        ekf_tail_fused=True, **kw)
    pst, pdiag = _update(d, batch, torch.float64, **kw)
    np.testing.assert_array_equal(pdiag["passed"].numpy(),
                                  np.asarray(jdiag["passed"]))
    assert bool(pdiag["did_update"]) == bool(jdiag["did_update"]) is True
    assert not bool(pdiag["ridge_fallback"])
    got = state_to_numpy(pst)
    for k, v in jst.__dict__.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=0, atol=1e-10,
                                   err_msg=k)


@pytest.mark.parametrize("seed", [26, 1])
def test_fused_update_f32_equals_unfused(seed, monkeypatch):
    """On a CPU tensor ``ekf_tail`` runs the plain version, the unfused
    chain: the update equals, bitwise, the one that calls
    ``cholesky_tail`` in its place."""
    d, batch = _scene(seed=seed, noise=5e-4)
    kw = dict(R_bc=R_BC, t_bc=T_BC, sigma_im=SIGMA, min_clone_states=2,
              compression="cholesky", adaptive_noise=True)
    on, don = _update(d, batch, torch.float32, **kw)
    calls = []

    def unfused(C, b, P, sig2):
        calls.append(C.shape)
        return tuple(x[None] for x in cholesky_tail(C[0], b[0], P[0],
                                                    sig2[0]))

    monkeypatch.setattr(pupd, "ekf_tail", unfused)
    off, doff = _update(d, batch, torch.float32, **kw)
    assert bool(don["did_update"]) and calls == [(1, 6 * M, 6 * M)]
    for k, v in state_to_numpy(off).items():
        np.testing.assert_array_equal(state_to_numpy(on)[k], v, err_msg=k)
    assert bool(don["ridge_fallback"]) == bool(doff["ridge_fallback"])
