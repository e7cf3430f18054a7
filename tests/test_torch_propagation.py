"""Port IMU propagation against the JAX package.

- ``propagate`` (CPU: K1's plain version) against JAX
  ``_propagate_sequential``, f64, 1e-12;
- K1's plain version in f32 against the Pallas kernel in interpret mode,
  on the case of tests/test_ops.py::TestPropagateBlockKernel (a
  small-angle sample and padding), at that test's 1e-6;
- the rule K1's CUDA kernel takes its trip count from: dt = 0 samples
  after the last valid one are a bitwise identity on every output (f32
  and f64), while a dt = 0 sample at the start is not;
- the bytes and operations ops/checks.py counts for K1's and K4's
  roofline bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from rvio_tpu.config import RVIOConfig
from rvio_tpu.core.quaternion import quat_to_rot as j_quat_to_rot
from rvio_tpu.filter.propagation import ImuBlock as JImuBlock
from rvio_tpu.filter.propagation import _propagate_sequential
from rvio_tpu.ops.propagate_block import propagate_block_pallas
from rvio_tpu.state import FilterState as JState
from rvio_tpu.state import make_initial_state as j_initial
from rvio_tpu_torch.config import RVIOConfig as PortConfig
from rvio_tpu_torch.filter.propagation import make_imu_block, propagate
from rvio_tpu_torch.ops.propagate_block import propagate_block_plain
from rvio_tpu_torch.state import state_from_numpy, state_to_numpy

torch.set_num_threads(1)
CFG = RVIOConfig()
CFG_PORT = PortConfig()
KW = dict(gravity=CFG.imu.gravity, small_angle=CFG.imu.small_angle,
          sigma_g=CFG.imu.sigma_g, sigma_wg=CFG.imu.sigma_wg,
          sigma_a=CFG.imu.sigma_a, sigma_wa=CFG.imu.sigma_wa)


def _case(seed=0, n_valid=11):
    """The state and IMU block of TestPropagateBlockKernel (numpy)."""
    rng = np.random.default_rng(seed)
    M, K = CFG.window_size, CFG.tpu.imu_block
    st = j_initial(M, jnp.float64)
    A = rng.normal(size=(24 + 6 * M, 24 + 6 * M)) * 0.01
    P = A @ A.T + np.eye(24 + 6 * M) * 1e-4
    d = {k: np.asarray(v) for k, v in st.__dict__.items()}
    q_R = Rotation.random(1, rng).as_quat()[0]
    d.update(q_R=q_R * np.sign(q_R[3]),             # canonical: w >= 0
             p_R=rng.normal(size=3), v_R=rng.normal(size=3),
             g=np.array([0.05, -0.02, 0.998]),
             bg=rng.normal(size=3) * 0.01, ba=rng.normal(size=3) * 0.05, P=P)
    w = rng.normal(size=(K, 3)) * 0.4
    w[3] = 1e-8                                  # small-angle sample
    a = rng.normal(size=(K, 3)) * 2.0 + [0, 0, 9.8]
    dts = np.full(K, 0.005)
    return d, w[:n_valid], a[:n_valid], dts[:n_valid]


@pytest.mark.parametrize("n_valid", [11, 16, 0])
def test_propagate_matches_sequential_f64(n_valid):
    d, w, a, dts = _case(n_valid=n_valid)
    K = CFG.tpu.imu_block
    pad = K - n_valid
    jimu = JImuBlock(w=jnp.asarray(np.pad(w, ((0, pad), (0, 0)))),
                     a=jnp.asarray(np.pad(a, ((0, pad), (0, 0)))),
                     dt=jnp.asarray(np.pad(dts, (0, pad))),
                     valid=jnp.asarray(np.arange(K) < n_valid))
    ref = _propagate_sequential(JState(**{k: jnp.asarray(v)
                                          for k, v in d.items()}), jimu, **KW)
    port = propagate(state_from_numpy(d, "cpu", torch.float64),
                     make_imu_block(w, a, dts, K, torch.float64, "cpu"), **KW)
    got = state_to_numpy(port)
    for k, v in ref.__dict__.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=0, atol=1e-12,
                                   err_msg=k)


def test_plain_k1_matches_pallas_interpret_f32():
    d, w, a, dts = _case()
    K = CFG.tpu.imu_block
    f32 = np.float32
    wp = np.pad(w, ((0, K - len(w)), (0, 0))).astype(f32)
    ap = np.pad(a, ((0, K - len(a)), (0, 0))).astype(f32)
    dte = np.pad(dts, (0, K - len(dts))).astype(f32)   # padding: dt = 0
    R0 = np.asarray(j_quat_to_rot(jnp.asarray(d["q_R"], jnp.float32)))
    vecs = [d[k].astype(f32) for k in ("v_R", "g", "bg", "ba")]
    P0 = d["P"][:24, :24].astype(f32)
    sig = ((CFG.imu.sigma_g ** 2,) * 3 + (CFG.imu.sigma_wg ** 2,) * 3
           + (CFG.imu.sigma_a ** 2,) * 3 + (CFG.imu.sigma_wa ** 2,) * 3)
    ref = propagate_block_pallas(
        jnp.asarray(wp), jnp.asarray(ap), jnp.asarray(dte), jnp.asarray(R0),
        *(jnp.asarray(v) for v in vecs), jnp.asarray(P0),
        gravity=CFG.imu.gravity, small_angle=CFG.imu.small_angle, sig=sig,
        interpret=True)
    got = propagate_block_plain(
        *(torch.tensor(x)[None] for x in (wp, ap, dte, R0, *vecs, P0)),
        **KW)
    Rk, pk, vk, P24, Psi = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(got[0][0].numpy(), Rk, atol=1e-6)
    np.testing.assert_allclose(got[1][0].numpy(), pk, atol=1e-6)
    np.testing.assert_allclose(got[2][0].numpy(), vk, atol=1e-6)
    s = np.abs(P24).max()
    np.testing.assert_allclose(got[3][0].numpy() / s, P24 / s, atol=1e-6)
    np.testing.assert_allclose(got[4][0].numpy(), Psi, atol=1e-6)


def _block(n_valid, dtype, K=16, seed=3):
    """One stream's K-sample block with n_valid samples of dt > 0 and dt = 0
    padding, R0 != I, as K1's plain version takes it."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(24, 24)) * 0.01
    R0 = Rotation.from_rotvec(rng.normal(size=3)).as_matrix()
    w = rng.normal(size=(K, 3)) * 0.4
    w[2] = 1e-8                                  # small-angle sample
    a = rng.normal(size=(K, 3)) * 2.0 + [0, 0, 9.8]
    dte = np.where(np.arange(K) < n_valid, 0.005, 0.0)
    g = np.array([0.05, -0.02, 0.998])
    arrays = (w, a, dte, R0, rng.normal(size=3), g / np.linalg.norm(g),
              rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.05,
              A @ A.T + np.eye(24) * 1e-4)
    return [torch.tensor(x, dtype=dtype)[None] for x in arrays]


def _cut(args, k):
    w, a, dte, *rest = args
    return [w[:, :k], a[:, :k], dte[:, :k], *rest]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_valid", [0, 1, 5, 11, 16])
def test_trailing_padding_is_a_bitwise_identity(n_valid, dtype):
    """K1's kernel runs max(last sample with dt > 0, 0) + 1 samples: the
    plain version over 16 samples equals, bitwise on all five outputs, the
    plain version cut there (with no valid sample, one step still runs)."""
    args = _block(n_valid, dtype)
    full = propagate_block_plain(*args, **KW)
    cut = propagate_block_plain(*_cut(args, max(n_valid, 1)), **KW)
    for x, y in zip(full, cut):
        assert torch.equal(x, y)


def test_leading_zero_dt_step_is_not_an_identity():
    """Why only trailing samples may be dropped: a dt = 0 step at the start
    of a frame with R0 != I sets vk = R0 vR (vk was vR), and its rotated
    vk and gk enter the next sample's Phi, so the covariance differs from
    the block without it."""
    args = _block(4, torch.float64)
    R0, vR = args[3], args[4]
    _, _, vk, _, _ = propagate_block_plain(*_cut(_block(0, torch.float64), 1),
                                           **KW)
    assert torch.allclose(vk, (R0 @ vR[..., None])[..., 0], rtol=0,
                          atol=1e-15)
    assert float((vk - vR).abs().max()) > 0.1
    # dt = 0, then the block's four valid samples, against those four alone
    lead = [torch.cat([torch.zeros_like(x[:, :1]), x[:, :4]], dim=1)
            for x in args[:3]]
    with_lead = propagate_block_plain(*lead, *args[3:], **KW)
    without = propagate_block_plain(*_cut(args, 4), **KW)
    for x, y in zip(with_lead[:3], without[:3]):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-14)
    assert float((with_lead[3] - without[3]).abs().max()) > 1e-9


def test_k1_k4_bounds_pinned():
    """The work the roofline bounds of K1 and K4 count (ops/checks.py) is a
    property of the function, not of a kernel's design: 11 valid samples
    of 12,412 operations each, and the bytes each call must move."""
    from rvio_tpu_torch.ops import checks
    assert checks.propagate_flops(11) == 136532
    k1 = checks._propagate_case(CFG_PORT, "cpu", np.random.default_rng(0))
    assert (k1.flops, k1.bytes_read, k1.bytes_written) == (136532, 2716, 4668)
    k4 = checks._quadform_case(CFG_PORT, "cpu", np.random.default_rng(0))
    assert (k4.flops, k4.bytes_read, k4.bytes_written) == (1041500, 198000,
                                                           400)
