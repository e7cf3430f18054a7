"""The frozen counting functions (counts.py) against the port's
ops/checks.py at every cell's shapes."""

import numpy as np
import pytest
import torch

from benchmark import counts, harness
from rvio_tpu_torch.ops import checks

SPEC = harness.load_spec()


def _configs():
    import rvio_tpu_torch.config as port_config
    return [(c["name"], harness.build_config(
        harness.read_json("configs", c["name"]), port_config))
        for c in SPEC["configs"]]


@pytest.mark.parametrize("name,cfg", _configs(), ids=lambda x: str(x)[:20])
def test_ekf_tail_counts(name, cfg):
    M = cfg.window_size
    n, D = 6 * M, 24 + 6 * M
    assert counts.ekf_tail_flops(n, D) == checks.ekf_tail_flops(n, D, False)
    assert counts.ekf_tail_flops(n, D, True) == checks.ekf_tail_flops(n, D,
                                                                       True)
    assert counts.ekf_tail_bytes(n, D) == sum(checks.ekf_tail_bytes(n, D))
    for B in (1, 4, 16):
        assert counts.launch_counts("K5", cfg, B) == (
            B * checks.ekf_tail_flops(n, D, False),
            B * sum(checks.ekf_tail_bytes(n, D)))


@pytest.mark.parametrize("name,cfg", _configs(), ids=lambda x: str(x)[:20])
def test_image_kernel_counts(name, cfg):
    H, W = cfg.camera.height, cfg.camera.width
    img = torch.rand(H, W, generator=torch.Generator().manual_seed(0)) * 255
    luts = checks.clahe_luts_case("cpu", img)
    apply = checks.clahe_apply_case(
        "cpu", img, torch.zeros(25, 256), 5)
    shi = checks.shi_case("cpu", img)
    nms = checks.shi_nms_case("cpu", img)
    for k, case in (("K10", luts), ("K11", apply), ("K12", shi),
                    ("K13", nms)):
        for B in (1, 4):
            ops, nbytes = counts.launch_counts(k, cfg, B)
            assert ops == B * case.flops, k
            assert nbytes == B * (case.bytes_read + case.bytes_written), k


def test_peaks_and_uncounted_kernels():
    cfg = _configs()[0][1]
    assert counts.PEAK_FLOPS == 67e12 and counts.PEAK_BYTES == 3.35e12
    for k in ("K1", "K2", "K3", "K4", "K6", "K7", "K8", "K9"):
        assert counts.launch_counts(k, cfg, 4) is None
    assert counts.least_seconds(67e12, 0) == 1.0
    assert np.isclose(counts.least_seconds(0, 3.35e12), 1.0)
