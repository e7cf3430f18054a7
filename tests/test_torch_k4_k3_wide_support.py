"""CPU tests of the facts the H100 designs of K4's wide instance and K3's
wide kernel rely on.

K4's wide instance (csrc/spd_solve.cu, ``quadform_wide_kernel``) is a
blocked Cholesky in panels of 32 columns with r carried as one more row
below S; K3's wide kernel (csrc/jac_project.cu, ``jac_project_wide_kernel``)
applies the three reflections in compact-WY form, Q^T c = c - V T^T V^T c.
Neither kernel runs here, so these tests hold numpy emulations of their
orders, in f64, against the plain versions and the JAX package:

- K4: the warp's register step on each 32 x 32 diagonal block with r's
  entries beside it, the panel solved a row at a time, the trailing update
  summed over the panel and r updated as the extra row, within 1e-12
  relative of ``batched_quadform_plain`` and of the JAX package's CPU gate
  (``cho_factor`` + ``cho_solve``), NaN in the indefinite lane in all
  three; the split of the trailing update (every entry of the lower
  triangle below the panel once: the next diagonal block by 2 x 2 tiles,
  the rest by 4 x 4, numbered with the kernel's f32 square root); the
  square storage's odd stride;
- K3: V, T (LAPACK's forward ``larft`` order), then each column in two
  passes (w = V^T c over the rows that hold c's entries, then c - V T^T w
  with the rank check and the residual mask), within 1e-12 of
  ``jac_project_plain`` and of the JAX package's ``_build_jacobians`` +
  ``_householder_project``, at t_eff = 2 and L, c0 at both ends of the
  window and a feature of rank two (Ncols = 2);
- the wrappers' dispatch by size (K3's narrow kernel up to L = 16, K4's
  wide instance from m = 64).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvio_tpu.filter.update import _build_jacobians, _householder_project
from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.ops.checks import jac_inputs, spd_systems
from rvio_tpu_torch.ops.jac_project import (KERNEL_EPS, jac_project_plain,
                                            kernel_route)
from rvio_tpu_torch.ops.spd_solve import batched_quadform_plain, instance

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "rvio_tpu_torch" / "csrc"


def _constant(source, name):
    text = (CSRC / source).read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, (source, name)
    return int(m.group(1))


PANEL = _constant("spd_solve.cu", "PB")       # the wide instance's panel


# ---- K4 ----

def _spd(rng, F, m, bad):
    S, r = spd_systems(rng, F, m)
    S[bad] -= 2 * np.abs(np.linalg.eigvalsh(S[bad])).max() * np.eye(m)
    return S, r


def _k4_panels(S, r):
    """K4's wide order in f64: per feature, the diagonal block of each panel
    factored by the warp step (column j of L from the pivot's reciprocal
    square root, y_j beside it, the block's columns right of j updated by
    column j), the rows below solved against it one column at a time, the
    trailing lower triangle and r less the panel's products."""
    F, m = r.shape
    D = np.empty(F)
    with np.errstate(invalid="ignore", divide="ignore"):
        for f in range(F):
            A = np.tril(S[f])
            y = r[f].copy()
            acc = 0.0
            lt = np.zeros((PANEL, PANEL))     # lt[j, k] = L[c0 + k, c0 + j]
            rinv = np.zeros(PANEL)

            def factor(c0):
                nonlocal acc
                n = min(PANEL, m - c0)
                x = np.eye(PANEL)
                x[:n, :n] = A[c0:c0 + n, c0:c0 + n]
                b = np.zeros(PANEL)
                b[:n] = y[c0:c0 + n]
                lanes = np.arange(PANEL)
                for j in range(n):
                    rs = 1.0 / np.sqrt(x[j, j])
                    l = np.where(lanes >= j, x[:, j] * rs, 0.0)
                    yj = b[j] * rs
                    acc += yj * yj
                    b -= l * yj
                    x[:, j + 1:] -= np.outer(l, l[j + 1:])
                    lt[j], rinv[j], y[c0 + j] = l, rs, yj

            factor(0)
            for c0 in range(0, m - PANEL, PANEL):
                b0 = c0 + PANEL
                X = A[b0:, c0:b0].copy()
                for j in range(PANEL):
                    X[:, j] *= rinv[j]
                    X[:, j + 1:] -= np.outer(X[:, j], lt[j, j + 1:])
                A[b0:, b0:] -= np.tril(X @ X.T)
                y[b0:] -= X @ y[c0:b0]
                factor(b0)
            D[f] = acc
    return D


def _jax_gate(S, r):
    """The JAX package's gate distance off the TPU (filter/update.py's
    ``mdist``, without its abs): cho_factor + cho_solve, NaN on a failed
    factorization."""
    def one(Sf, rf):
        sol = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(Sf, lower=True), rf)
        return rf @ sol
    return np.asarray(jax.vmap(one)(jnp.asarray(S), jnp.asarray(r)))


@pytest.mark.parametrize("m", [65, 66, 96, 97, 128, 129, 130, 340])
def test_panel_order_matches_plain_and_jax(m):
    """The panel order equals the plain version and the JAX package's CPU
    gate within 1e-12 relative in f64, and the indefinite lane is NaN in
    all three and only there."""
    F, bad = 4, 2
    S, r = _spd(np.random.default_rng(m), F, m, bad)
    got = _k4_panels(S, r)
    plain = batched_quadform_plain(torch.as_tensor(S),
                                   torch.as_tensor(r)).numpy()
    ref = _jax_gate(S, r)
    for want in (plain, ref):
        nan = np.isnan(want)
        assert np.flatnonzero(nan).tolist() == [bad]
        np.testing.assert_array_equal(np.isnan(got), nan)
        assert np.abs(got[~nan] - want[~nan]).max() <= (
            1e-12 * np.abs(want[~nan]).max())


def _tile(t):
    """tile_update's (ti, tk) of tile t: the f32 square root, then the
    integer corrections."""
    ti = int((np.sqrt(np.float32(8.0) * np.float32(t) + np.float32(1.0))
              - np.float32(1.0)) * np.float32(0.5))
    while ti * (ti + 1) // 2 > t:
        ti -= 1
    while (ti + 1) * (ti + 2) // 2 <= t:
        ti += 1
    return ti, t - ti * (ti + 1) // 2


@pytest.mark.parametrize("m", [65, 97, 130, 340, 1000])
def test_trailing_tiles_cover_the_triangle_once(m):
    """Each panel's trailing update touches every entry (i, k),
    b0 <= k <= i < m, of the lower triangle below it exactly once: the
    next diagonal block by 2 x 2 tiles (every warp, before warp 0 factors
    it), the rest by the 4 x 4 tiles past the block's (the panel warps),
    both numbered with the kernel's f32 square root."""
    for c0 in range(0, m - PANEL, PANEL):
        b0 = c0 + PANEL
        nr = m - b0
        count = np.zeros((nr, nr), np.int64)

        def cover(T, tiles, first=0):
            for t in range(first, tiles):
                ti, tk = _tile(t)
                assert 0 <= tk <= ti
                for p in range(T):
                    for q in range(T):
                        i, k = T * ti + p, T * tk + q
                        if i < nr and k <= i:
                            count[i, k] += 1

        nb2 = (min(PANEL, nr) + 1) // 2
        cover(2, nb2 * (nb2 + 1) // 2)
        block = count.copy()
        nt = (nr + 3) // 4
        nd4 = min(nt, PANEL // 4)
        cover(4, nt * (nt + 1) // 2, nd4 * (nd4 + 1) // 2)
        low = np.tril(np.ones((nr, nr), bool))
        assert (count[low] == 1).all() and (count[~low] == 0).all()
        nb = min(PANEL, nr)
        assert (block[:nb, :nb][low[:nb, :nb]] == 1).all()
        assert block[nb:].sum() == 0


@pytest.mark.parametrize("m", [66, 130, 224])
def test_square_stride_meets_every_bank(m):
    """S's square stride m | 1 is odd, so a column read over 32 lanes (32
    consecutive rows) touches each of the 32 shared-memory banks once."""
    ld = m | 1
    assert len({(i * ld) % 32 for i in range(32)}) == 32


# ---- K3 ----

def _safe(zv, eps):
    return np.where(np.abs(zv) < eps, np.where(zv < 0, -eps, eps), zv)


def _k3_wy(z, Rcl, tcl, Rrl, trl, Rcr, tcr, phi, psi, rho, t_eff, c0,
           R_bc, t_bc, M, eps=KERNEL_EPS):
    """K3's wide order in f64: Hf and the reflectors as the kernel's warp 0
    forms them, T from the betas and V^T V, then r and each pair of Hx
    columns in two passes: w = V^T c over the rows of measurements
    jj < i < t_eff (c's entries), then c - V T^T w on every row with the
    rank check and the residual mask."""
    F, L = z.shape[:2]
    R2, XC = 2 * L, 6 * M
    rows = np.arange(R2)
    r_out = np.zeros((F, R2))
    hx = np.zeros((F, R2, XC))
    hfn = np.zeros(F)
    for f in range(F):
        te, c0f = min(int(t_eff[f]), L), int(c0[f])
        sp, cp, ss, cs = (np.sin(phi[f]), np.cos(phi[f]), np.sin(psi[f]),
                          np.cos(psi[f]))
        epf = np.array([cp * ss, sp, cp * cs])
        Ja = np.array([[-sp * ss, cp * cs], [cp, 0.0], [-sp * cs, -cp * ss]])
        A = np.zeros((R2, 3))
        res = np.zeros(R2)
        left = np.zeros((R2, 3))
        for l in range(L):
            h = Rcl[f, l] @ epf + rho[f] * tcl[f, l]
            zi = 1.0 / _safe(h[2], eps)
            Hp = np.array([[zi, 0, -h[0] * zi * zi], [0, zi, -h[1] * zi * zi]])
            left[2 * l:2 * l + 2] = Hp @ R_bc.T @ Rrl[f, l]
            if l < te:
                A[2 * l:2 * l + 2, :2] = Hp @ Rcl[f, l] @ Ja
                if l > 0:
                    A[2 * l:2 * l + 2, 2] = Hp @ tcl[f, l]
                hr = Rcr[f, l] @ epf + rho[f] * tcr[f, l]
                res[2 * l:2 * l + 2] = z[f, l] - hr[:2] / _safe(hr[2], eps)
        hfn[f] = np.sqrt(np.sum(A[:, 2] ** 2))
        V = np.zeros((3, R2))
        beta = np.zeros(3)
        for k in range(3):
            x = np.where(rows >= k, A[:, k], 0.0)
            sxx = x @ x
            normx = np.sqrt(sxx)
            alpha = -normx if A[k, k] >= 0 else normx
            vnorm2 = 2.0 * (sxx - alpha * A[k, k])
            beta[k] = 2.0 / vnorm2 if vnorm2 > 1e-30 else 0.0
            V[k] = x
            V[k, k] -= alpha
            for c in range(k + 1, 3):
                A[:, c] -= beta[k] * V[k] * (x @ A[:, c] - alpha * A[k, c])
        g01, g02, g12 = V[0] @ V[1], V[0] @ V[2], V[1] @ V[2]
        t01 = -beta[0] * beta[1] * g01
        T = np.array([[beta[0], t01, -beta[2] * (beta[0] * g02 + t01 * g12)],
                      [0.0, beta[1], -beta[2] * beta[1] * g12],
                      [0.0, 0.0, beta[2]]])
        ncols = 2 if hfn[f] < 1e-4 else 3
        keep = (rows >= ncols) & (rows < 2 * te)
        r_out[f] = np.where(keep, res - V.T @ (T.T @ (V @ res)), 0.0)
        pb = R_bc @ epf + rho[f] * t_bc
        for oc in range(0, XC, 2):
            jj = oc // 6 - c0f
            assert (oc + 1) // 6 - c0f == jj      # a pair, one chain column
            if jj < 0 or jj > te - 2:
                continue                          # zeros, no work
            Rj, tj, Rp = Rrl[f, jj + 1], trl[f, jj + 1], Rrl[f, jj]
            w = pb + rho[f] * (Rj.T @ tj)
            dpx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                            [-w[1], w[0], 0]])
            for q in range(2):
                b = oc % 6 + q
                s3 = dpx @ Rj[b] if b < 3 else -rho[f] * Rp[b - 3]
                c = np.where(rows // 2 > jj, left @ s3, 0.0)
                on = (rows // 2 > jj) & (rows < 2 * te)
                wv = V[:, on] @ c[on]                         # pass 1
                hx[f, :, oc + q] = np.where(keep, c - V.T @ (T.T @ wv), 0.0)
    return r_out, hx, hfn


def _jax_oracle(arrays, M):
    """The JAX package's per-feature Jacobians and projection (f64), with
    the integration masks of its msckf_update."""
    (z, Rc, tc, Rrel, trel, Rc_res, tc_res, phi, psi, rho, t_eff, c0, R_bc,
     t_bc) = arrays
    L = z.shape[1]

    def one(z, phi, psi, rho, Rrel, trel, Rc, tc, c0, te, Rc_res, tc_res):
        r, Hf, Hx = _build_jacobians(z, phi, psi, rho, Rrel, trel, Rc, tc,
                                     c0, te, jnp.asarray(R_bc),
                                     jnp.asarray(t_bc), M, Rc_res, tc_res)
        _, Hx_p, r_p = _householder_project(Hf, Hx, r)
        hfn = jnp.linalg.norm(Hf[:, 2])
        rows = jnp.arange(2 * L)
        keep = (rows >= jnp.where(hfn < 1e-4, 2, 3)) & (rows < 2 * te)
        return (jnp.where(keep, r_p, 0.0),
                jnp.where(keep[:, None], Hx_p, 0.0), hfn)

    out = jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in (
        z, phi, psi, rho, Rrel, trel, Rc, tc, c0, t_eff, Rc_res, tc_res)))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("L", [17, 33, 65, 100])
def test_compact_wy_order_matches_plain_and_jax(L):
    """The compact-WY order equals jac_project_plain and the JAX package's
    projection within 1e-12 in f64, for t_eff = 2 and t_eff = L, c0 at 0
    and at M - t_eff + 1 (M = L - 1 clones), and a feature seen from one
    camera centre (||Hf[:, rho]|| = 0: Ncols = 2)."""
    M = L - 1
    t_eff = np.array([2, L, 2, L, L, L])
    c0 = np.array([0, 0, M - 1, M - L + 1, 0, 0]).clip(0)
    inputs = jac_inputs(RVIOConfig(), np.random.default_rng(L), 6, L, M,
                        t_eff, c0)
    inputs[2] = inputs[2].copy()
    inputs[2][5] = 0.0                     # tc = 0: a rank-two feature
    *arrays, _ = inputs
    got = _k3_wy(*arrays, M)
    t = [torch.as_tensor(np.asarray(x)) for x in arrays]
    plain = jac_project_plain(*t[:10], t[10], t[11], t[12], t[13], M,
                              eps=KERNEL_EPS)
    assert got[2][5] < 1e-4 <= got[2][:5].min()
    assert np.abs(got[1]).max() > 0
    for g, w in zip(got, plain):
        assert np.abs(g - w.numpy()).max() <= 1e-12
    for g, w in zip(got, _jax_oracle(arrays, M)):
        assert np.abs(g - w).max() <= 1e-12


def test_wy_form_is_the_sequential_reflections():
    """Q^T = H_2 H_1 H_0 = I - V T^T V^T with T from the betas and V^T V,
    for seeded reflectors (rows below k zero in v_k) and zero betas."""
    rng = np.random.default_rng(5)
    for betas in ([0.3, 0.7, 1.1], [0.0, 0.5, 0.0]):
        V = rng.normal(size=(3, 20))
        for k in range(3):
            V[k, :k] = 0.0
        b = np.asarray(betas)
        H = [np.eye(20) - b[k] * np.outer(V[k], V[k]) for k in range(3)]
        g01, g02, g12 = V[0] @ V[1], V[0] @ V[2], V[1] @ V[2]
        t01 = -b[0] * b[1] * g01
        T = np.array([[b[0], t01, -b[2] * (b[0] * g02 + t01 * g12)],
                      [0.0, b[1], -b[2] * b[1] * g12], [0.0, 0.0, b[2]]])
        np.testing.assert_allclose(np.eye(20) - V.T @ T.T @ V,
                                   H[2] @ H[1] @ H[0], atol=1e-13)


@pytest.mark.parametrize("kernel, size, want", [
    ("jac_project", 2, "narrow"), ("jac_project", 16, "narrow"),
    ("jac_project", 17, "wide"), ("jac_project", 65, "wide"),
    ("batched_quadform", 1, "narrow"), ("batched_quadform", 63, "narrow"),
    ("batched_quadform", 64, "wide"), ("batched_quadform", 130, "wide")])
def test_dispatch_routes(kernel, size, want):
    """The wrappers' dispatch, the one place that picks a kernel by size
    (the C entries take the route they are given; chip_smoke.py names the
    dispatched route by it): K3's narrow kernel up to L = 16, K4's wide
    instance from m = 64."""
    route = (kernel_route if kernel == "jac_project" else instance)(size)
    assert route == want
