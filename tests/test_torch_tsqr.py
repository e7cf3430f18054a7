"""The port's ``_cholqr2`` and ``tsqr_compress`` against the JAX package
(f64, CPU), as tests/test_update.py pins the JAX functions:

- ``_cholqr2`` on one block with dead columns: R and Q^T r against JAX's
  (R is the unique upper factor with a positive diagonal) at 1e-10 of
  their largest entry;
- exact information: R^T R = H^T H and R^T (Q^T r) = H^T r at 1e-10 of
  the largest entry, for both block methods, on tests/test_update.py's
  tall ill-conditioned stack with rejected rows and dead clone columns,
  and against JAX's tree;
- a column dead in one block and live in another contributes nothing
  from the dead block;
- the tree equals one direct thin QR in information;
- an update whose stacked shards go through a cholqr2 tree (96-row
  blocks) equals the Householder update (one ``torch.linalg.qr``) and
  JAX's at 1e-8.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rvio_tpu.filter.update as jupd
import rvio_tpu_torch.filter.update as tupd
from rvio_tpu.state import FilterState as JState
from rvio_tpu_torch.filter.update import (UpdateBatch, _cholqr2,
                                          merge_partials, msckf_update,
                                          tsqr_compress, update_partials,
                                          update_tail)
from rvio_tpu_torch.state import state_from_numpy, state_to_numpy
from test_torch_update import R_BC, SIGMA, T_BC, _scene

torch.set_num_threads(1)
F64 = torch.float64
C = 84
METHODS = ("householder", "cholqr2")


def _rel(a, b):
    """Largest gap over the largest entry of ``b``."""
    return float(np.abs(a - b).max() / np.abs(b).max())


def _info(R, rn):
    R, rn = np.asarray(R), np.asarray(rn)
    return R.T @ R, R.T @ rn


def _stack(seed, rows, scale_col0=True):
    """tests/test_update.py's stack: rejected-feature zero rows, dead
    (invalid-clone) columns, an ill-conditioned live column."""
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(rows, C))
    H[rng.uniform(size=rows) < 0.5] = 0.0
    H[:, [78, 79, 80, 81, 82, 83]] = 0.0
    if scale_col0:
        H[:, 0] *= 1e-4
    r = rng.normal(size=rows)
    r[(H == 0).all(axis=1)] = 0.0
    return H, r


def test_cholqr2_block_matches_jax():
    H, r = _stack(31, 700, scale_col0=False)
    R, rn = _cholqr2(torch.as_tensor(H), torch.as_tensor(r))
    jR, jrn = jupd._cholqr2(jnp.asarray(H), jnp.asarray(r))
    assert _rel(R.numpy(), np.asarray(jR)) < 1e-10
    assert _rel(rn.numpy(), np.asarray(jrn)) < 1e-10
    # dead columns leave zero rows, as Householder's
    assert not R.numpy()[78:].any() and not rn.numpy()[78:].any()


@pytest.mark.parametrize("method", METHODS)
def test_tsqr_exact_information(method):
    H, r = _stack(29, 12000)
    R, rn = tsqr_compress(torch.as_tensor(H), torch.as_tensor(r),
                          method=method)
    assert R.shape == (C, C)
    G, g = _info(R.numpy(), rn.numpy())
    assert _rel(G, H.T @ H) < 1e-10
    assert _rel(g, H.T @ r) < 1e-10
    jG, jg = _info(*jupd.tsqr_compress(jnp.asarray(H), jnp.asarray(r),
                                       method=method))
    assert _rel(G, jG) < 1e-10 and _rel(g, jg) < 1e-10


@pytest.mark.parametrize("method", METHODS)
def test_dead_in_one_block_live_in_another(method):
    """Column 5 is zero in the first block only: the stripped completion
    row leaves its information to the second block."""
    H, r = _stack(33, 1344, scale_col0=False)
    H[:672, 5] = 0.0
    R, rn = tsqr_compress(torch.as_tensor(H), torch.as_tensor(r),
                          block_rows=672, method=method)
    G, g = _info(R.numpy(), rn.numpy())
    assert _rel(G, H.T @ H) < 1e-10 and _rel(g, H.T @ r) < 1e-10


def test_tsqr_equivalent_to_direct_qr():
    H, r = _stack(28, 3000, scale_col0=False)
    R, rn = tsqr_compress(torch.as_tensor(H), torch.as_tensor(r))
    Q, Rd = torch.linalg.qr(torch.as_tensor(H))
    G, g = _info(R.numpy(), rn.numpy())
    Gd, gd = _info(Rd.numpy(), (Q.T @ torch.as_tensor(r)).numpy())
    assert _rel(G, Gd) < 1e-10 and _rel(g, gd) < 1e-10
    jG, jg = _info(*jupd.tsqr_compress(jnp.asarray(H), jnp.asarray(r)))
    assert _rel(G, jG) < 1e-10 and _rel(g, jg) < 1e-10


def test_batched_blocks_are_single_blocks():
    """Leading axes are a batch of blocks: each entry equals its own
    call (R bitwise; Q^T r from a batched product, to its rounding)."""
    Hs, rs = zip(*(_stack(s, 900, scale_col0=False) for s in (40, 41)))
    for method in METHODS:
        R, rn = tsqr_compress(torch.as_tensor(np.stack(Hs)),
                              torch.as_tensor(np.stack(rs)), block_rows=300,
                              method=method)
        for i in range(2):
            Ri, rni = tsqr_compress(torch.as_tensor(Hs[i]),
                                    torch.as_tensor(rs[i]), block_rows=300,
                                    method=method)
            assert torch.equal(R[i], Ri)
            assert _rel(rn[i].numpy(), rni.numpy()) < 1e-13


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown method"):
        tsqr_compress(torch.zeros(4, 2, dtype=F64), torch.zeros(4, dtype=F64),
                      method="givens")


def test_cholqr2_update_matches_householder(monkeypatch):
    """The update with its lanes in four shards whose stacked R factors
    reduce through a cholqr2 tree of 96-row blocks, against the one-QR
    update and JAX's, at 1e-8."""
    d, (meas, tlen, typ2, valid) = _scene(seed=30, noise=5e-4)
    kw = dict(R_bc=R_BC, t_bc=T_BC, sigma_im=SIGMA, compression="qr")
    tail_kw = dict(min_clone_states=2)
    state = state_from_numpy(d, "cpu", F64)
    batch = UpdateBatch(meas=torch.as_tensor(meas),
                        track_len=torch.as_tensor(tlen).long(),
                        is_type2=torch.as_tensor(typ2),
                        valid=torch.as_tensor(valid))
    ref, rdiag = msckf_update(state, batch, **kw, **tail_kw)
    jst, jdiag = jupd.msckf_update(
        JState(**{k: jnp.asarray(v) for k, v in d.items()}),
        jupd.UpdateBatch(meas=jnp.asarray(meas), track_len=jnp.asarray(tlen),
                         is_type2=jnp.asarray(typ2), valid=jnp.asarray(valid)),
        R_bc=R_BC, t_bc=T_BC, sigma_im=SIGMA, min_clone_states=2,
        compression="qr")
    monkeypatch.setattr(tupd, "tsqr_compress", functools.partial(
        tsqr_compress, block_rows=96, method="cholqr2"))
    sb = tupd.add_segment_axis(state)
    shards = [update_partials(sb, tupd.add_segment_axis(UpdateBatch(
        **{k: v[i:i + 2] for k, v in vars(batch).items()})), **kw)
        for i in range(0, 8, 2)]
    got, diag = update_tail(sb, merge_partials(shards), compression="qr",
                            **tail_kw)
    got = state_to_numpy(tupd.drop_segment_axis(got))
    assert bool(diag["did_update"][0]) and bool(rdiag["did_update"])
    assert bool(jdiag["did_update"])
    want = state_to_numpy(ref)
    for k in ("q_G", "p_G", "v_R", "clones", "P"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-8,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], np.asarray(getattr(jst, k)),
                                   rtol=0, atol=1e-8, err_msg=k)
