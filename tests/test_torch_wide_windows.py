"""The filter kernels' plain versions at windows past the narrow kernels'
sizes, against the JAX package on the CPU.

A window of ``max_tracking_length`` L takes K3 at L measurements, K4 at
m = 2L and K5 at n = 6 (L - 1); on the card, L = 17 is the first window
past K5's narrow kernel (n = 92), L = 33 past K4's warp instances
(m = 64) and L = 65 past K3's (L = 64).  The plain versions are what the
CPU runs and what the card's kernels are held against:

- ``jac_project_plain`` (f64) against the JAX package's XLA oracle
  (``_build_jacobians`` + ``_householder_project``, jitted over the
  features; interpret mode takes 10-20 s a length) at L = 33 and 65:
  ||Hf[:, rho]|| within rtol 1e-12 and the projection's orthogonal
  invariants H^T H, H^T r, r^T r within 1e-10 of their scale (the first
  reflector's sign follows the rounding of an entry that is zero by
  construction, as tests/test_torch_update.py notes);
- ``batched_quadform_plain`` against ``batched_quadform_pallas(interpret=
  True)`` at m = 66 and 130, an indefinite lane included: NaN in the same
  lane, rtol 1e-9 elsewhere (f64);
- ``ekf_tail_plain`` (f32) against ``ekf_tail_pallas(interpret=True)`` at
  n = 96 (2e-5 of the largest entry, tests/test_torch_ekf_tail.py's
  tolerance), and in f64 against the XLA Cholesky tail of
  tests/test_ops.py at n = 192 and 384 (1e-10); in f32 on a case that
  takes the wider ridge, against that tail in f64 with the wider ridge,
  within ops/checks.py's wider-ridge limits;
- the order of the Joseph form both K5 routes take (the chain's: I - K Hn
  formed first) against the narrow kernel's earlier one (K Hn P
  subtracted after the product), each emulated in f32 against f64, and
  ops/checks.py's limit on P_new scaled by its diagonal, which admits the
  first and rejects the second;
- the f64 feature-level sequence scan at L = 33 against the JAX step;
- the filter body (runtime/step.py ``_segment_body``, through
  ``make_filter_step``) at L = 17, 33 and 65 sends its tail through
  ``ekf_tail`` (K5 on the card) once a frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rvio_tpu_torch.filter.update as pupd
import test_ops
import test_torch_update
from rvio_tpu import config as jconfig
from rvio_tpu.dataio.synthetic import simulate_sequence
from rvio_tpu.filter.update import _build_jacobians, _householder_project
from rvio_tpu.ops.ekf_tail import ekf_tail_pallas
from rvio_tpu.ops.spd_solve import batched_quadform_pallas
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.ops.checks import (EKF_TAIL_FALLBACK_SCALED_TOL,
                                       EKF_TAIL_FALLBACK_TOL,
                                       EKF_TAIL_SCALED_TOL,
                                       ekf_tail_fallback_inputs,
                                       ekf_tail_stack, ekf_tail_tol,
                                       joseph_p_new, scaled_cov_err)
from rvio_tpu_torch.ops.ekf_tail import (NX, ekf_tail, ekf_tail_plain,
                                         info_cholesky)
from rvio_tpu_torch.ops.jac_project import jac_project_plain
from rvio_tpu_torch.ops.lm_triangulate import EPS_DEPTH
from rvio_tpu_torch.ops.spd_solve import batched_quadform_plain
from rvio_tpu_torch.runtime import make_filter_step, make_sequence_scan
from test_torch_scan import _feature_inputs, _port_bundles

torch.set_num_threads(1)
F64 = torch.float64


def _t(x, dtype=F64):
    return torch.as_tensor(np.asarray(x)).to(dtype)


# ---- K3 ---------------------------------------------------------------------

def _jac_oracle(s):
    """The JAX package's per-feature Jacobians and projection (f64), with
    the integration masks of its msckf_update."""
    L, M = s["L"], s["M"]

    def one(z, phi, psi, rho, Rrel, trel, Rc, tc, c0, te):
        r, Hf, Hx = _build_jacobians(z, phi, psi, rho, Rrel, trel, Rc, tc,
                                     c0, te, jnp.asarray(s["R_bc"]),
                                     jnp.asarray(s["t_bc"]), M, Rc, tc)
        _, Hx_p, r_p = _householder_project(Hf, Hx, r)
        hfn = jnp.linalg.norm(Hf[:, 2])
        rows = jnp.arange(2 * L)
        m = (rows >= jnp.where(hfn < 1e-4, 2, 3)) & (rows < 2 * te)
        return (jnp.where(m, r_p, 0.0), jnp.where(m[:, None], Hx_p, 0.0),
                hfn)

    out = jax.jit(jax.vmap(one))(*(jnp.asarray(s[k]) for k in (
        "z", "phi", "psi", "rho", "Rrel", "trel", "Rc", "tc", "c0",
        "t_eff")))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("L", [33, 65])
def test_jac_project_plain_matches_oracle(L):
    s = test_torch_update.TestJacProjectPlain()._setup(F=6, L=L, M=L - 1, seed=L,
                                     c0_mode="rand")
    want = _jac_oracle(s)
    got = jac_project_plain(
        *(_t(s[k]) for k in ("z", "Rc", "tc", "Rrel", "trel", "Rc", "tc",
                             "phi", "psi", "rho")),
        _t(s["t_eff"], torch.int64), _t(s["c0"], torch.int64),
        _t(s["R_bc"]), _t(s["t_bc"]), s["M"], eps=EPS_DEPTH)
    assert got[1].shape == (6, 2 * L, 6 * (L - 1))
    assert np.abs(want[1]).max() > 0
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-12)

    def invs(r, h):
        return (np.einsum("frc,frd->fcd", h, h), np.einsum("frc,fr->fc", h, r),
                np.einsum("fr,fr->f", r, r))

    for a, b in zip(invs(want[0], want[1]),
                    invs(got[0].numpy(), got[1].numpy())):
        sc = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(b / sc, a / sc, rtol=0, atol=1e-10)


# ---- K4 ---------------------------------------------------------------------

@pytest.mark.parametrize("m", [66, 130])
def test_quadform_plain_matches_pallas(m):
    rng = np.random.default_rng(m)
    F = 6
    A = rng.normal(size=(F, m, m))
    S = A @ np.transpose(A, (0, 2, 1)) + 1e-2 * np.eye(m)
    S[2] -= 2 * np.abs(np.linalg.eigvalsh(S[2])).max() * np.eye(m)
    r = rng.normal(size=(F, m))
    want = np.asarray(batched_quadform_pallas(jnp.asarray(S), jnp.asarray(r),
                                              interpret=True))
    got = batched_quadform_plain(_t(S), _t(r)).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert np.flatnonzero(nan).tolist() == [2]
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=1e-9)


# ---- K5 ---------------------------------------------------------------------

def _scaled_close(got, ref, atol):
    s = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(np.asarray(got) / s, np.asarray(ref) / s,
                               rtol=0, atol=atol)


def test_ekf_tail_plain_matches_pallas_n96():
    """16 clones (n = 96), the first window past the narrow kernel."""
    C, b, P, sig2 = ekf_tail_stack(np.random.default_rng(1), 16, 600,
                                   dead_clones=2)
    dx_k, P_k = ekf_tail_pallas(jnp.asarray(C), jnp.asarray(b),
                                jnp.asarray(P), jnp.float32(sig2),
                                interpret=True)
    dx, P_new, fb = ekf_tail(*(torch.as_tensor(np.asarray(x))[None]
                               for x in (C, b, P, sig2)))
    assert dx.shape == (1, 120) and not bool(fb[0])
    _scaled_close(dx[0].numpy(), dx_k, 2e-5)
    _scaled_close(P_new[0].numpy(), P_k, 2e-5)


@pytest.mark.parametrize("M", [32, 64])
def test_ekf_tail_plain_f64_matches_oracle_chain(M):
    C, b, P, sig2 = (np.float64(x) for x in ekf_tail_stack(
        np.random.default_rng(M), M, 40 * 6 * M, dead_clones=2))
    dx_o, P_o = test_ops.TestEkfTailKernel._oracle(
        jnp.asarray(C), jnp.asarray(b), jnp.asarray(P), jnp.float64(sig2))
    dx, P_new, fb = ekf_tail_plain(*(_t(x)[None] for x in (C, b, P, sig2)))
    assert not bool(fb[0]) and P_new.shape == (1, NX + 6 * M, NX + 6 * M)
    _scaled_close(dx[0].numpy(), dx_o, 1e-10)
    _scaled_close(P_new[0].numpy(), P_o, 1e-10)


def test_ekf_tail_plain_wider_ridge_n192():
    """A C whose f32 factor fails with the 1e-8 ridge: the plain version
    takes n eps_f32 max(tr C, 1) and stays, in f32, within the
    wider-ridge limits of ops/checks.py of the XLA tail in f64 with that
    ridge (the JAX package has no wider ridge: its update is NaN there)."""
    n = 192
    C, b, P, sig2 = ekf_tail_fallback_inputs(np.random.default_rng(2), n=n)
    dx, P_new, fb = ekf_tail_plain(*(torch.as_tensor(np.asarray(x))[None]
                                     for x in (C, b, P, sig2)))
    assert bool(fb[0]) and bool(info_cholesky(torch.as_tensor(C))[1])
    ridge = n * float(np.finfo(np.float32).eps)
    dx_o, P_o = test_ops.TestEkfTailKernel._oracle(
        *(jnp.asarray(np.float64(x)) for x in (C, b, P, sig2)),
        ridge_rel=ridge)
    dx_o, P_o = np.asarray(dx_o), np.asarray(P_o)
    for got, want in ((dx[0], dx_o), (P_new[0], P_o)):
        err = np.abs(got.double().numpy() - want).max() / np.abs(want).max()
        assert err < EKF_TAIL_FALLBACK_TOL, err
    assert scaled_cov_err(P_new[0].double().numpy(),
                          P_o) < EKF_TAIL_FALLBACK_SCALED_TOL


@pytest.mark.parametrize("M", [14, 16])
def test_joseph_order_keeps_the_small_entries(M):
    """At n = 84 (the narrow kernel's, RVIOConfig()'s) and n = 96 (the
    wide route's) the chain's order keeps P_new within 1e-4 of its f64
    value scaled by P_new's diagonal; the narrow kernel's earlier order,
    which subtracts nearly equal products, parts by more than ten times
    that in f32 (csrc/ekf_tail.cu now takes the chain's order)."""
    C, b, P, sig2 = (torch.as_tensor(np.asarray(x)) for x in ekf_tail_stack(
        np.random.default_rng(97), M, 3840))
    ref = joseph_p_new(*(x.double() for x in (C, b, P, sig2)), True).numpy()
    chain = scaled_cov_err(joseph_p_new(C, b, P, sig2, True).double().numpy(),
                           ref)
    narrow = scaled_cov_err(
        joseph_p_new(C, b, P, sig2, False).double().numpy(), ref)
    assert chain < 1e-4 < 10 * chain < narrow, (chain, narrow)


@pytest.mark.parametrize("seed", [97, 98, 99])
@pytest.mark.parametrize("M", [14, 16])
def test_scaled_limit_admits_the_chain_order_only(M, seed):
    """ops/checks.py's EKF_TAIL_SCALED_TOL, the limit on K5's P_new against
    its plain version scaled by P_new's diagonal, is at most 1e-4 and
    admits the chain's order of the Joseph form but not the narrow
    kernel's earlier order (emulated in f32 by ``joseph_p_new(...,
    False)``), at n = 84 and 96 on the seeded stacks of
    scripts/joseph_order.py: against the plain version in f32 (what the
    kernel checks compare) and against the chain's order in f64."""
    C, b, P, sig2 = (torch.as_tensor(np.asarray(x)) for x in ekf_tail_stack(
        np.random.default_rng(seed), M, 3840))
    plain = ekf_tail_plain(*(x[None] for x in (C, b, P, sig2)))[1][0]
    ref = joseph_p_new(*(x.double() for x in (C, b, P, sig2)), True)
    chain = joseph_p_new(C, b, P, sig2, True).double().numpy()
    narrow = joseph_p_new(C, b, P, sig2, False).double().numpy()
    limit = ekf_tail_tol(EKF_TAIL_SCALED_TOL, 6 * M)
    assert EKF_TAIL_SCALED_TOL <= 1e-4 and limit < 1.1e-4
    for want in (plain.double().numpy(), ref.numpy()):
        ok, bad = scaled_cov_err(chain, want), scaled_cov_err(narrow, want)
        assert ok <= limit < bad, (ok, bad)


# ---- the filter at wide windows -----------------------------------------------

def _wide_cfg(mod, L):
    return mod.RVIOConfig(
        imu=mod.ImuConfig(rate_hz=100.0), camera=mod.CameraConfig(fps=10.0),
        tracker=mod.TrackerConfig(num_features=16, max_tracking_length=L),
        tpu=mod.TpuConfig(imu_block=16, compression="cholesky"))


def test_sequence_scan_matches_jax_at_33():
    """max_tracking_length 33 (a window of 32 clones, n = 192, K4 at
    m = 66) on a narrow feature config: the f64 sequence scan against
    JAX's, positions and attitudes within 1e-8, n_good exactly."""
    from rvio_tpu.filter.propagation import ImuBlock as JaxImu
    from rvio_tpu.filter.update import UpdateBatch as JaxBatch
    from rvio_tpu.runtime.step import FrameBundle as JaxBundle
    from rvio_tpu.runtime.step import make_sequence_scan as jax_scan
    cfg = (_wide_cfg(jconfig, 33), _wide_cfg(tconfig, 33))
    sim = simulate_sequence(cfg[0], duration=6.0, static_time=1.0, seed=11,
                            meas_noise=0.0015, imu_noise=True)
    jstate, tstate, arrays = _feature_inputs(cfg, sim)
    w, a, dt, valid, meas, tlen, typ2, ok = arrays
    jb = JaxBundle(imu=JaxImu(w=jnp.asarray(w), a=jnp.asarray(a),
                              dt=jnp.asarray(dt), valid=jnp.asarray(valid)),
                   batch=JaxBatch(meas=jnp.asarray(meas),
                                  track_len=jnp.asarray(tlen, jnp.int32),
                                  is_type2=jnp.asarray(typ2),
                                  valid=jnp.asarray(ok)))
    _, ref = jax_scan(cfg[0])(jstate, jb)
    _, got = make_sequence_scan(cfg[1], "cpu", F64)(tstate,
                                                    _port_bundles(arrays))
    # tracks of the full length, and updates once the window has filled
    assert len(w) >= 40 and int(tlen.max()) == 33
    np.testing.assert_array_equal(got["n_good"].numpy(),
                                  np.asarray(ref["n_good"]))
    assert int(got["n_good"][32:].sum()) > 5
    for k in ("p_Gk", "q_kG", "v_k"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("L", [17, 33, 65])
def test_body_sends_the_tail_through_ekf_tail(L, monkeypatch):
    """The filter body built for a window of L - 1 clones calls
    ``ekf_tail`` (K5 on a CUDA tensor) once a frame with n = 6 (L - 1), the
    same at every window: no step is built with another tail."""
    cfg = _wide_cfg(tconfig, L)
    sim = simulate_sequence(_wide_cfg(jconfig, L), duration=2.5,
                            static_time=1.0, seed=3, meas_noise=0.0015,
                            imu_noise=True)
    _, state0, arrays = _feature_inputs((_wide_cfg(jconfig, L), cfg), sim)
    calls = []

    def counted(C, b, P, sig2):
        calls.append(tuple(C.shape))
        return ekf_tail(C, b, P, sig2)

    monkeypatch.setattr(pupd, "ekf_tail", counted)
    step = make_filter_step(cfg, "cpu", F64)     # the body at B = 1
    bundles = _port_bundles([x[:3] for x in arrays])
    state = state0
    for t in range(3):
        state, out = step(state, bundles.frame(t))
    n = 6 * (L - 1)
    assert calls == [(1, n, n)] * 3
    assert torch.isfinite(out["p_Gk"]).all()
    # the step picks no tail of its own
    import rvio_tpu_torch.runtime.step as step
    assert not hasattr(step, "cholesky_tail") and not hasattr(step, "NMAX")
