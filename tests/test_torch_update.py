"""Port MSCKF update and its kernels' plain versions against the JAX package.

- K2 plain vs ``lm_triangulate_pallas(interpret=True)``: ``ok`` identical,
  angles/depth at the atol of tests/test_ops.py::TestLmTriangulate (f64);
- K3 plain (f64 on f32 inputs) vs ``jac_project_pallas(interpret=True)``
  (f32) through the orthogonally invariant H^T H, H^T r, r^T r and
  ||Hf[:, rho]||, at the tolerances of tests/test_ops.py::
  TestJacProjectKernel, including the 1e-6 depth-guard case;
- K4 plain vs ``batched_quadform_pallas(interpret=True)`` at rtol 1e-9,
  including a NaN lane (f64);
- ``msckf_update`` vs the JAX one in f64 for both compressions and FEJ on
  and off: gate decisions identical, state and P within 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import rvio_tpu.filter.update as jupd
from rvio_tpu.ops.jac_project import jac_project_pallas
from rvio_tpu.ops.lm_triangulate import lm_triangulate_pallas
from rvio_tpu.ops.spd_solve import batched_quadform_pallas
from rvio_tpu.state import FilterState as JState
from rvio_tpu_torch.filter.update import UpdateBatch, msckf_update
from rvio_tpu_torch.ops.jac_project import (KERNEL_EPS, depth_guard,
                                            jac_project, jac_project_plain)
from rvio_tpu_torch.ops.lm_triangulate import EPS_DEPTH, lm_triangulate_plain
from rvio_tpu_torch.ops.spd_solve import batched_quadform_plain
from rvio_tpu_torch.state import state_from_numpy, state_to_numpy

torch.set_num_threads(1)


def _t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x)).to(dtype)


class TestLmPlain:
    # 3 iterations stop before convergence, so the lambda schedule shows
    @pytest.mark.parametrize("iters", [10, 3])
    def test_matches_pallas_interpret(self, iters):
        # the geometry of tests/test_ops.py::TestLmTriangulate
        rng = np.random.default_rng(4)
        F, L, sigma = 24, 15, 0.005
        Rc = np.stack([np.stack([
            Rotation.from_rotvec(rng.normal(size=3) * 0.05).as_matrix()
            for _ in range(L)]) for _ in range(F)])
        Rc[:, 0] = np.eye(3)
        tc = rng.normal(size=(F, L, 3)) * 0.1
        tc[:, 0] = 0
        pts = np.array([0.2, -0.1, 2.0]) + rng.normal(size=(F, 3)) * 0.3
        z = np.zeros((F, L, 2))
        for f in range(F):
            d = np.linalg.norm(pts[f])
            for m in range(L):
                h = Rc[f, m] @ pts[f] / d + tc[f, m] / d
                z[f, m] = h[:2] / h[2] + rng.normal(size=2) * 0.001
        tl = np.minimum(3 + rng.integers(0, L, size=F), L).astype(np.int32)
        z[3, 0] = [2000.0, 0.0]      # angle seed out of bounds -> not ok
        ref = lm_triangulate_pallas(jnp.asarray(z), jnp.asarray(Rc),
                                    jnp.asarray(tc), jnp.asarray(tl),
                                    sigma_im=sigma, iters=iters,
                                    interpret=True)
        got = lm_triangulate_plain(_t(z), _t(Rc), _t(tc), _t(tl, torch.int64),
                                   sigma_im=sigma, iters=iters)
        ok = np.asarray(ref[3])
        np.testing.assert_array_equal(got[3].numpy(), ok)
        assert not ok[3] and ok.sum() > F // 2
        for i, name in enumerate(("phi", "psi", "rho")):
            np.testing.assert_allclose(got[i].numpy()[ok],
                                       np.asarray(ref[i])[ok], atol=1e-12,
                                       err_msg=name)


class TestJacProjectPlain:
    """The cases of tests/test_ops.py::TestJacProjectKernel."""

    def _setup(self, F=12, L=15, M=14, seed=0, c0_mode="zero"):
        rng = np.random.default_rng(seed)
        Rrel = np.zeros((F, L, 3, 3))
        trel = rng.normal(size=(F, L, 3)) * 0.3
        for f in range(F):
            Rrel[f] = Rotation.random(L, rng).as_matrix()
            Rrel[f, 0] = np.eye(3)
            trel[f, 0] = 0
        R_bc = Rotation.random(1, rng).as_matrix()[0]
        t_bc = rng.normal(size=3) * 0.05
        R_cb, t_cb = R_bc.T, -R_bc.T @ t_bc
        Rc = np.einsum("ab,flbc,cd->flad", R_cb, Rrel, R_bc)
        tc = (np.einsum("ab,flbc,c->fla", R_cb, Rrel, t_bc)
              + np.einsum("ab,flb->fla", R_cb, trel) + t_cb)
        s = dict(z=rng.normal(size=(F, L, 2)) * 0.2, Rrel=Rrel, trel=trel,
                 Rc=Rc, tc=tc, R_bc=R_bc, t_bc=t_bc,
                 phi=rng.normal(size=F) * 0.5, psi=rng.normal(size=F) * 0.5,
                 rho=rng.uniform(0.2, 2.0, size=F),
                 t_eff=rng.integers(2, L + 1, size=F), F=F, L=L, M=M)
        s["c0"] = (np.zeros(F, np.int32) if c0_mode == "zero"
                   else rng.integers(0, M - 2, size=F).astype(np.int32))
        return s

    def _pallas(self, s):
        """The TPU kernel (interpreted) plus the JAX side's integration:
        masks and the one-hot shift to absolute clone columns."""
        f32 = jnp.float32
        L, M, F = s["L"], s["M"], s["F"]
        J = L - 1
        r, hxrel, hfn = jac_project_pallas(
            *(jnp.asarray(s[k], f32) for k in ("z", "Rc", "tc", "Rrel",
                                               "trel", "Rc", "tc", "phi",
                                               "psi", "rho")),
            jnp.asarray(s["t_eff"], jnp.int32),
            Rbc_t=tuple(tuple(float(v) for v in row) for row in s["R_bc"]),
            tbc_t=tuple(float(v) for v in s["t_bc"]), L=L, interpret=True)
        hfn = np.asarray(hfn)
        ncols = np.where(hfn < 1e-4, 2, 3)
        rows = np.arange(2 * L)
        m = ((rows[None] >= ncols[:, None])
             & (rows[None] < 2 * s["t_eff"][:, None]))
        oh = (s["c0"][:, None, None] + np.arange(J)[None, :, None]
              == np.arange(M)[None, None, :]).astype(np.float32)
        hx = np.einsum("frjc,fjm->frmc", np.asarray(hxrel).reshape(F, 2 * L, J, 6),
                       oh).reshape(F, 2 * L, 6 * M)
        return (np.where(m, np.asarray(r), 0.0),
                np.where(m[:, :, None], hx, 0.0), hfn)

    def _plain(self, s):
        """The plain version on the kernel's f32-rounded inputs, evaluated
        in f64, so the comparison sees only the f32 kernel's rounding (the
        budget test_ops's tolerances were set for): features near a depth
        plane amplify f32 rounding differences to ~1e-4 relative in hfn."""
        def t(k):
            return _t(np.asarray(s[k], np.float32))

        r, hx, hfn = jac_project_plain(
            *(t(k) for k in ("z", "Rc", "tc", "Rrel", "trel", "Rc", "tc",
                             "phi", "psi", "rho")),
            _t(s["t_eff"], torch.int64), _t(s["c0"], torch.int64),
            t("R_bc"), t("t_bc"), s["M"], eps=KERNEL_EPS)
        return r.numpy(), hx.numpy(), hfn.numpy()

    def _check(self, s):
        r_o, hx_o, hfn_o = self._pallas(s)
        r_k, hx_k, hfn_k = self._plain(s)
        np.testing.assert_allclose(hfn_k, hfn_o, rtol=1e-4, atol=1e-4)

        def invs(r, h):
            return (np.einsum("frc,frd->fcd", h, h),
                    np.einsum("frc,fr->fc", h, r),
                    np.einsum("fr,fr->f", r, r))

        for a, b in zip(invs(r_o, hx_o), invs(r_k, hx_k)):
            sc = max(np.abs(a).max(), 1.0)
            np.testing.assert_allclose(b / sc, a / sc, atol=1e-3)

    @pytest.mark.parametrize("F,seed,c0_mode", [(12, 0, "zero"),
                                                (12, 3, "rand"),
                                                (100, 5, "rand")])
    def test_matches_pallas_interpret(self, F, seed, c0_mode):
        self._check(self._setup(F=F, seed=seed, c0_mode=c0_mode))

    def test_degenerate_depth_clamps(self):
        """|h_z| = 1e-9 inside (1e-12, 1e-6): both clamp at 1e-6 and stay
        finite and equal."""
        s = self._setup(F=8, seed=7)
        tc = np.zeros_like(s["tc"])
        tc[:4, 1:, 2] = -(1.0 - 1e-9)
        s.update(phi=np.zeros(8), psi=np.zeros(8), rho=np.ones(8), tc=tc,
                 Rc=np.broadcast_to(np.eye(3), s["Rc"].shape).copy())
        r_k, hx_k, hfn_k = self._plain(s)
        assert np.isfinite(r_k).all() and np.isfinite(hx_k).all()
        assert np.abs(r_k).max() < 1e8
        self._check(s)

    @pytest.mark.parametrize("dtype,eps", [(torch.float32, KERNEL_EPS),
                                           (torch.float64, EPS_DEPTH)])
    def test_wrapper_guard_follows_dtype(self, dtype, eps):
        """On the CPU the wrapper runs the plain version with the kernel's
        guard in f32 and the oracle's in f64; the degenerate case tells
        the two guards apart."""
        s = self._setup(F=8, seed=7)
        tc = np.zeros_like(s["tc"])
        tc[:4, 1:, 2] = -(1.0 - 1e-9)
        s.update(phi=np.zeros(8), psi=np.zeros(8), rho=np.ones(8), tc=tc,
                 Rc=np.broadcast_to(np.eye(3), s["Rc"].shape).copy())
        args = (*(_t(s[k], dtype) for k in ("z", "Rc", "tc", "Rrel", "trel",
                                             "Rc", "tc", "phi", "psi", "rho")),
                _t(s["t_eff"], torch.int64), _t(s["c0"], torch.int64),
                _t(s["R_bc"], dtype), _t(s["t_bc"], dtype), s["M"])
        assert depth_guard(dtype) == eps
        got = jac_project(*args)
        for g, w in zip(got, jac_project_plain(*args, eps=eps)):
            assert torch.equal(g, w)
        other = jac_project_plain(*args, eps=EPS_DEPTH + KERNEL_EPS - eps)
        assert not torch.equal(got[0], other[0])


class TestQuadformPlain:
    @pytest.mark.parametrize("F,m,bad", [(37, 30, None), (8, 10, 0),
                                         (8, 10, "indefinite")])
    def test_matches_pallas_interpret(self, F, m, bad):
        rng = np.random.default_rng(5)
        A = rng.normal(size=(F, m, m))
        S = A @ np.transpose(A, (0, 2, 1)) + 1e-2 * np.eye(m)
        if bad == 0:
            S[0] = 0.0
        elif bad == "indefinite":
            S[2] = S[2] - 2 * np.abs(np.linalg.eigvalsh(S[2])).max() * np.eye(m)
        r = rng.normal(size=(F, m))
        ref = np.asarray(batched_quadform_pallas(jnp.asarray(S), jnp.asarray(r),
                                                 interpret=True))
        got = batched_quadform_plain(_t(S), _t(r)).numpy()
        nan = np.isnan(ref)
        np.testing.assert_array_equal(np.isnan(got), nan)
        assert nan.sum() == (0 if bad is None else 1)
        np.testing.assert_allclose(got[~nan], ref[~nan], rtol=1e-9)


# ---- msckf_update, f64, against the JAX package ----
M, L, F = 4, 5, 8
SIGMA = 0.002
R_BC = Rotation.from_rotvec([0.02, -0.03, 1.55]).as_matrix()
T_BC = np.array([-0.02, -0.065, 0.01])


def _skew(w):
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])


def _scene(seed, noise, p_scale=3e-3, M=M, L=L, F=F):
    """A window of M clone transitions and F features seen by all its
    frames (independent numpy geometry), as a dict of state arrays."""
    rng = np.random.default_rng(seed)
    qs, ps = [], []
    for _ in range(M):
        q = Rotation.from_rotvec(rng.normal(size=3) * 0.05).as_quat()
        qs.append(q * np.sign(q[3]))
        ps.append(rng.normal(size=3) * 0.2)
    A, b = [np.eye(3)], [np.zeros(3)]
    for q, p in zip(qs, ps):
        R = (np.eye(3) - 2 * q[3] * _skew(q[:3])
             + 2 * _skew(q[:3]) @ _skew(q[:3]))
        A.append(R @ A[-1])
        b.append(R @ (b[-1] - p))
    meas = np.zeros((F, L, 2))
    for f in range(F):
        dir0 = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2), 1.0])
        p_c0 = rng.uniform(3.0, 8.0) * dir0 / np.linalg.norm(dir0)
        p_b0 = R_BC @ p_c0 + T_BC
        for m in range(L):
            p_cm = R_BC.T @ (A[m] @ p_b0 + b[m] - T_BC)
            meas[f, m] = p_cm[:2] / p_cm[2] + noise * rng.normal(size=2)
    meas[1, 3] += [0.15, -0.2]                      # a gross outlier
    tlen = np.full(F, L, np.int32)
    tlen[5] = 3                                     # a short type-1 track
    typ2 = np.zeros(F, bool)
    typ2[6] = True                                  # a type-2 (half) track
    valid = np.ones(F, bool)
    valid[7] = False
    clones = np.concatenate([np.asarray(qs), np.asarray(ps)], axis=1)
    D = 24 + 6 * M
    G = rng.normal(size=(D, D)) * p_scale
    fej = clones.copy()
    fej[:, 4:] += rng.normal(size=(M, 3)) * 1e-3
    fej[:, :4] += rng.normal(size=(M, 4)) * 1e-4
    fej[:, :4] /= np.linalg.norm(fej[:, :4], axis=1, keepdims=True)
    g = np.array([0.02, -0.01, 1.0])
    state = dict(q_G=np.array([0.01, 0.02, -0.03, 1.0]) / np.linalg.norm(
                     [0.01, 0.02, -0.03, 1.0]),
                 p_G=rng.normal(size=3), g=g / np.linalg.norm(g),
                 q_R=np.array([0, 0, 0, 1.0]), p_R=np.zeros(3),
                 v_R=rng.normal(size=3), bg=np.zeros(3), ba=np.zeros(3),
                 clones=clones, P=G @ G.T + p_scale ** 2 * np.eye(D),
                 n_clones=np.int32(M), frame_idx=np.int32(10),
                 clones_fej=fej, sigma2_scale=np.float64(1.2))
    return state, (meas, tlen, typ2, valid)


@pytest.mark.parametrize("compression,fej,adaptive,sigma", [
    ("cholesky", False, True, SIGMA),
    ("qr", False, False, SIGMA),
    ("cholesky", True, True, SIGMA),
    ("qr", True, False, SIGMA),
    ("cholesky", False, True, 1e-5),     # mass rejection: the escape fires
])
def test_msckf_update_matches_jax_f64(compression, fej, adaptive, sigma):
    # a tight prior in the mass-rejection case, so S is sigma-dominated
    d, (meas, tlen, typ2, valid) = _scene(
        seed=26, noise=5e-4, p_scale=3e-3 if sigma == SIGMA else 1e-7)
    kw = dict(R_bc=R_BC, t_bc=T_BC, sigma_im=sigma, min_clone_states=2,
              compression=compression, fej=fej, adaptive_noise=adaptive)
    jst, jdiag = jupd.msckf_update(
        JState(**{k: jnp.asarray(v) for k, v in d.items()}),
        jupd.UpdateBatch(meas=jnp.asarray(meas), track_len=jnp.asarray(tlen),
                         is_type2=jnp.asarray(typ2), valid=jnp.asarray(valid)),
        **kw)
    pst, pdiag = msckf_update(
        state_from_numpy(d, "cpu", torch.float64),
        UpdateBatch(meas=_t(meas), track_len=_t(tlen, torch.int64),
                    is_type2=torch.tensor(typ2), valid=torch.tensor(valid)),
        **kw)
    passed = np.asarray(jdiag["passed"])
    np.testing.assert_array_equal(pdiag["passed"].numpy(), passed)
    assert bool(pdiag["did_update"]) == bool(jdiag["did_update"])
    if sigma == SIGMA:
        assert bool(jdiag["did_update"]) and not passed[1] and passed[0]
    else:
        assert not bool(jdiag["did_update"])
        assert float(jst.sigma2_scale) > d["sigma2_scale"]   # walked up
    for k in ("n_good", "n_usable", "tl_good_sum"):
        assert int(pdiag[k]) == int(jdiag[k]), k
    got = state_to_numpy(pst)
    for k, v in jst.__dict__.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=0, atol=1e-10,
                                   err_msg=k)
    ok = passed
    np.testing.assert_allclose(pdiag["landmarks"].numpy()[ok],
                               np.asarray(jdiag["landmarks"])[ok], atol=1e-10)
    D = np.asarray(jdiag["mahalanobis"])
    fin = np.isfinite(D)
    np.testing.assert_allclose(pdiag["mahalanobis"].numpy()[fin], D[fin],
                               rtol=1e-8)


def test_info_ridge_keeps_f32_cholesky_finite():
    """The cholesky compression's ridge: the JAX package's 1e-8 * trace,
    whose factor ``info_cholesky`` returns unchanged wherever it exists.  In
    f32 a C with two collinear dominant columns (rank-deficient, as three
    image-path features give) can lose more than that to rounding and the
    factorization fails; only then is the factor that of n * eps * trace."""
    from rvio_tpu_torch.ops.ekf_tail import info_cholesky
    old_fail = 0
    for seed in range(20):
        rng = np.random.default_rng(seed)
        A = rng.normal(size=(81, 84))
        A[:, 1] = 1.5 * A[:, 0]
        A[:, :2] *= 30.0
        for dtype in (torch.float64, torch.float32):
            C = torch.as_tensor(A.T @ A).to(dtype)
            eye = torch.eye(84, dtype=dtype)
            scale = torch.clamp(torch.trace(C), min=1.0)
            L_jax, info = torch.linalg.cholesky_ex(C + (1e-8 * scale) * eye)
            L, fallback = info_cholesky(C)
            assert bool(fallback) == bool(info != 0)
            assert torch.isfinite(L).all()
            if not fallback:
                assert torch.equal(L, L_jax)
            else:
                assert dtype == torch.float32
                old_fail += 1
                wide = 84 * torch.finfo(dtype).eps
                assert torch.equal(L, torch.linalg.cholesky(
                    C + (wide * scale) * eye))
    assert old_fail > 0


def _f32_update_pair(d, batch, compression):
    """The port's and the JAX package's msckf_update on the same f32
    inputs (the JAX oracle path), and the JAX f64 result."""
    meas, tlen, typ2, valid = batch
    kw = dict(R_bc=R_BC, t_bc=T_BC, sigma_im=SIGMA, min_clone_states=2,
              compression=compression, adaptive_noise=True)
    out = {}
    for name, jdt in (("jax32", jnp.float32), ("jax64", jnp.float64)):
        st = {k: (jnp.asarray(v, jdt) if np.asarray(v).dtype.kind == "f"
                  else jnp.asarray(v)) for k, v in d.items()}
        jst, jdiag = jupd.msckf_update(
            JState(**st), jupd.UpdateBatch(
                meas=jnp.asarray(meas, jdt), track_len=jnp.asarray(tlen),
                is_type2=jnp.asarray(typ2), valid=jnp.asarray(valid)),
            use_pallas=False, **kw)
        out[name] = ({k: np.asarray(v) for k, v in jst.__dict__.items()},
                     jdiag)
    pst, pdiag = msckf_update(
        state_from_numpy(d, "cpu", torch.float32),
        UpdateBatch(meas=_t(meas, torch.float32),
                    track_len=_t(tlen, torch.int64),
                    is_type2=torch.tensor(typ2), valid=torch.tensor(valid)),
        **kw)
    out["port32"] = state_to_numpy(pst), pdiag
    return out


# f32 against f32: both factor C + 1e-8 tr(C) I by LAPACK in another
# summation order; the readings were 1e-7 on the state and 1.5e-9 on P
F32_TOL_STATE, F32_TOL_P = 1e-6, 1e-8


@pytest.mark.parametrize("compression,seed", [("cholesky", 26),
                                              ("cholesky", 1), ("qr", 26)])
def test_msckf_update_f32_matches_jax_f32(compression, seed):
    """Ordinary frames in f32: the port's update is the JAX function's,
    with the JAX ridge (no fallback) and the same gate decisions."""
    d, batch = _scene(seed=seed, noise=5e-4)
    out = _f32_update_pair(d, batch, compression)
    (got, pdiag), (ref, jdiag) = out["port32"], out["jax32"]
    assert not bool(pdiag["ridge_fallback"])
    assert bool(pdiag["did_update"]) and bool(jdiag["did_update"])
    np.testing.assert_array_equal(pdiag["passed"].numpy(),
                                  np.asarray(jdiag["passed"]))
    for k, v in ref.items():
        tol = F32_TOL_P if k == "P" else F32_TOL_STATE
        np.testing.assert_allclose(got[k], v, rtol=0, atol=tol, err_msg=k)
