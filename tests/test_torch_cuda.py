"""The port's CUDA kernels on the card (marked ``gpu``; they skip without one).

Run on a machine with a CUDA card (``--noconftest`` where jax, which
tests/conftest.py imports, is not installed):

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest

Each kernel is held against its plain PyTorch version on the same inputs
at the filter's operating point (rvio_tpu_torch/ops/checks.py states the
tolerances); SequenceDriver's main path must launch every kernel once per
frame and stay close to the CPU plain path.  Whether a card is present is
decided in the fixture, so every process collects the same tests.
"""

import numpy as np
import pytest
import torch

KERNEL_NAMES = ["propagate_block", "lm_triangulate", "jac_project",
                "batched_quadform"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_matches_plain(cuda, name):
    from rvio_tpu_torch.ops.checks import kernel_checks
    chk = {c.name: c for c in kernel_checks(cuda)}[name]
    before = chk.kernel.launches
    chk.check()
    torch.cuda.synchronize()
    assert chk.kernel.launches == before + 1


@pytest.mark.gpu
def test_kernels_refuse_f64(cuda):
    from rvio_tpu_torch.ops.spd_solve import batched_quadform
    S = torch.eye(4, dtype=torch.float64, device=cuda)[None]
    with pytest.raises(TypeError):
        batched_quadform(S, torch.ones(1, 4, dtype=torch.float64, device=cuda))


@pytest.mark.gpu
def test_driver_launches_every_kernel(cuda):
    from rvio_tpu_torch.config import (CameraConfig, ImuConfig, RVIOConfig,
                                       TpuConfig, TrackerConfig)
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.ops import (jac_project, lm_triangulate,
                                    propagate_block, spd_solve)
    from rvio_tpu_torch.runtime import SequenceDriver, batches_from_sim
    wrappers = [propagate_block.propagate_block, lm_triangulate.lm_triangulate,
                jac_project.jac_project, spd_solve.batched_quadform]
    cfg = RVIOConfig(imu=ImuConfig(rate_hz=100.0), camera=CameraConfig(fps=10.0),
                     tracker=TrackerConfig(num_features=16,
                                           max_tracking_length=8),
                     tpu=TpuConfig(imu_block=16))
    sim = simulate_sequence(cfg, duration=6.0, static_time=1.2, seed=11,
                            meas_noise=0.0015, imu_noise=True)
    args = (sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t, batches_from_sim(sim))
    for w in wrappers:
        w.launches = 0
    gpu = SequenceDriver(cfg, device=cuda).run(*args)
    n = len(gpu.timestamps)
    assert [w.launches for w in wrappers] == [n] * 4
    cpu = SequenceDriver(cfg, device="cpu").run(*args)
    np.testing.assert_allclose(gpu.positions, cpu.positions, atol=1e-4)
