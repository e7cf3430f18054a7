"""The port end to end on the CPU, against the JAX package.

- ``SequenceDriver`` in f64 on a short sequence at a small config against
  the JAX driver: with ``parallel_propagation=False`` both run the same
  sequential recursion and trajectories agree to 1e-8 m; with the default
  config both evaluate propagation and the window chain as parallel
  prefixes (two tree orders of one prefix), and the stated bound is
  1e-12 m (the gap reached: 4.4e-15 m);
- an ATE bound on the port alone, as tests/test_e2e_synthetic.py has;
- import hygiene: the port and chip_smoke.py import neither jax nor
  rvio_tpu, and the entry points refuse a missing device.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvio_tpu import config as jconfig
from rvio_tpu.dataio.synthetic import simulate_sequence
from rvio_tpu.runtime.driver import SequenceDriver as JaxDriver
from rvio_tpu.runtime.driver import batches_from_sim as jax_batches
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.dataio import synthetic as tsynthetic
from rvio_tpu_torch.eval.ate import ate_rmse
from rvio_tpu_torch.runtime import SequenceDriver, batches_from_sim

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _cfg(mod, **tpu):
    return mod.RVIOConfig(
        imu=mod.ImuConfig(rate_hz=100.0), camera=mod.CameraConfig(fps=10.0),
        tracker=mod.TrackerConfig(num_features=16, max_tracking_length=8),
        tpu=mod.TpuConfig(imu_block=16, **tpu))


@pytest.mark.parametrize("parallel,compression,tol", [
    (False, "qr", 1e-8), (True, "cholesky", 1e-12)])
def test_driver_matches_jax_f64(parallel, compression, tol):
    kw = dict(parallel_propagation=parallel, compression=compression)
    jcfg, tcfg = _cfg(jconfig, **kw), _cfg(tconfig, **kw)
    sim = simulate_sequence(jcfg, duration=6.0, static_time=1.2, seed=11,
                            meas_noise=0.0015, imu_noise=True)
    ref = JaxDriver(jcfg, dtype=jnp.float64).run(
        sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t, jax_batches(sim))
    got = SequenceDriver(tcfg, dtype=torch.float64, device="cpu").run(
        sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t, batches_from_sim(sim))
    assert len(got.timestamps) == len(ref.timestamps) > 30
    np.testing.assert_array_equal(got.timestamps, ref.timestamps)
    np.testing.assert_array_equal(got.n_good, ref.n_good)
    assert got.n_good[10:].mean() > 3
    np.testing.assert_allclose(got.positions, ref.positions, rtol=0, atol=tol)
    np.testing.assert_allclose(got.quaternions, ref.quaternions, rtol=0,
                               atol=tol)


def test_simulator_copy_matches():
    """The port's copy of the simulator gives the JAX package's sequence."""
    kw = dict(duration=3.0, static_time=1.0, seed=5, meas_noise=0.001,
              imu_noise=True)
    a = simulate_sequence(_cfg(jconfig), **kw)
    b = tsynthetic.simulate_sequence(_cfg(tconfig), **kw)
    for k in ("imu_w", "imu_a", "feat_meas", "feat_len", "gt_p"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


def test_ate_bound_noise_free():
    """The bounds of tests/test_e2e_synthetic.py on the port (f64)."""
    cfg = tconfig.RVIOConfig(
        imu=tconfig.ImuConfig(rate_hz=100.0),
        camera=tconfig.CameraConfig(fps=10.0),
        tracker=tconfig.TrackerConfig(num_features=40, max_tracking_length=8,
                                      min_tracking_length=3),
        tpu=tconfig.TpuConfig(imu_block=16, compression="qr"))
    sim = tsynthetic.simulate_sequence(cfg, duration=14.0, static_time=1.2,
                                       seed=3, n_landmarks=500, meas_noise=0.0)
    res = SequenceDriver(cfg, dtype=torch.float64, device="cpu").run(
        sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t, batches_from_sim(sim),
        collect_landmarks=True)
    gt = sim.gt_p[np.searchsorted(sim.frame_t, res.timestamps)]
    assert len(res.timestamps) > 80 and res.n_good[20:].mean() > 3
    assert ate_rmse(res.positions, gt) < 0.12
    tail = slice(len(res.positions) // 2, None)
    assert ate_rmse(res.positions[tail], gt[tail]) < 0.08
    assert res.landmarks is not None and len(res.landmarks) > 50


_PORT_FILES = sorted((ROOT / "rvio_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_port_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|rvio_tpu)(\.|\s|$)", re.M)
    bad = [str(p) for p in _PORT_FILES if pat.search(p.read_text())]
    assert not bad, bad


def test_port_import_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import rvio_tpu_torch\n"
        "for m in pkgutil.walk_packages(rvio_tpu_torch.__path__, "
        "'rvio_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'rvio_tpu' or k.startswith('rvio_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len([k for k in sys.modules "
        "if k.startswith('rvio_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_entry_point_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SequenceDriver(_cfg(tconfig))


@pytest.mark.parametrize("build", ["gate", "initial_state", "static_init",
                                   "imu_block", "tracker", "image_driver",
                                   "image_pipeline", "online_driver",
                                   "euroc_scan", "euroc_per_frame",
                                   "batched_scan", "masked_scan",
                                   "segments_warm", "warm_init",
                                   "synthetic_sweep", "euroc_sweep"])
def test_public_builders_default_to_cuda(build):
    """Every public function that makes tensors means CUDA by default and
    raises without it, as SequenceDriver does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from rvio_tpu_torch.filter.propagation import make_imu_block
    from rvio_tpu_torch.frontend import make_tracker
    from rvio_tpu_torch.runtime import (ImagePipeline, InitializationGate,
                                        OnlineDriver, run_euroc_sequence,
                                        run_euroc_sequence_scan,
                                        run_rendered_sequence_scan)
    from rvio_tpu_torch.parallel import (make_masked_segment_scan,
                                         run_segments_warm, warm_initialize)
    from rvio_tpu_torch.eval.sweep import run_euroc_sweep, run_synthetic_sweep
    from rvio_tpu_torch.runtime import make_batched_sequence_scan
    from rvio_tpu_torch.state import make_initial_state, static_initialize
    z3 = np.zeros((4, 3))
    calls = {
        "gate": lambda: InitializationGate(_cfg(tconfig)),
        "initial_state": lambda: make_initial_state(4),
        "static_init": lambda: static_initialize(
            np.zeros(3), np.array([0, 0, 9.8]), 10, gravity=9.8,
            imu_rate=100.0, sigma_a=0.1, sigma_wg=0.1, sigma_wa=0.1,
            enable_alignment=True, max_clones=4),
        "imu_block": lambda: make_imu_block(z3, z3, np.zeros(4), 8),
        "tracker": lambda: make_tracker(_image_cfg()),
        "image_driver": lambda: run_rendered_sequence_scan(
            _image_cfg(), tsynthetic.simulate_sequence(
                _image_cfg(), duration=1.0, static_time=0.5, seed=1)),
        "image_pipeline": lambda: ImagePipeline(_image_cfg()),
        "online_driver": lambda: OnlineDriver(_image_cfg()),
        # the device is resolved before the sequence is read
        "euroc_scan": lambda: run_euroc_sequence_scan(_image_cfg(), None),
        "euroc_per_frame": lambda: run_euroc_sequence(_image_cfg(), None),
        "batched_scan": lambda: make_batched_sequence_scan(_cfg(tconfig)),
        "masked_scan": lambda: make_masked_segment_scan(_cfg(tconfig)),
        # the device is resolved before the state and bundles are read
        "segments_warm": lambda: run_segments_warm(_cfg(tconfig), None,
                                                   None, 4, 10),
        "warm_init": lambda: warm_initialize(_cfg(tconfig),
                                             np.array([0, 0, 9.8])),
        "synthetic_sweep": lambda: run_synthetic_sweep(_cfg(tconfig),
                                                       seeds=(0,)),
        # the device is resolved before any folder is read
        "euroc_sweep": lambda: run_euroc_sweep(_cfg(tconfig), ["missing"]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[build]()


def _image_cfg():
    return tconfig.RVIOConfig()


def test_wrappers_refuse_other_devices():
    from rvio_tpu_torch.ops.ekf_tail import ekf_tail
    from rvio_tpu_torch.ops.spd_solve import batched_quadform
    S = torch.empty(2, 3, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        batched_quadform(S, torch.empty(2, 3, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        ekf_tail(S, torch.empty(2, 3, device="meta"),
                 torch.empty(2, 27, 27, device="meta"),
                 torch.empty(2, device="meta"))
