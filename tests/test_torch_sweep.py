"""The port's sweep (rvio_tpu_torch/eval/sweep.py) against the JAX
package's, f64 on the CPU.

- tests/test_parallel.py::TestSweep on the port;
- one seed's row against JAX's row: frames and the mean good-feature
  count equal, ATE and RPE within 1e-8 m (the two filters agree to about
  1e-14 m on this path, tests/test_torch_e2e.py);
- ``format_table`` string-equal to the JAX function's on the same rows,
  a NaN ATE among them;
- ``python -m rvio_tpu_torch.run --sweep 1 --device cpu`` prints the table.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvio_tpu import config as jconfig
from rvio_tpu.eval import sweep as jsweep
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.eval import sweep

torch.set_num_threads(1)


def small_cfg(mod):
    """tests/test_parallel.py's ``small_cfg`` from either package."""
    return mod.RVIOConfig(
        imu=mod.ImuConfig(rate_hz=100.0), camera=mod.CameraConfig(fps=10.0),
        tracker=mod.TrackerConfig(num_features=24, max_tracking_length=6,
                                  min_tracking_length=3),
        tpu=mod.TpuConfig(imu_block=16))


def test_synthetic_sweep_runs():
    rows = sweep.run_synthetic_sweep(small_cfg(tconfig), seeds=(0,),
                                     duration=10.0, dtype=torch.float64,
                                     noise=False, device="cpu")
    assert len(rows) == 1
    assert rows[0].frames > 40
    assert rows[0].ate_m < 0.3
    table = sweep.format_table(rows)
    assert "synthetic_seed0" in table and "mean" in table


def test_rows_match_jax():
    kw = dict(seeds=(3,), duration=8.0, noise=True)
    ref = jsweep.run_synthetic_sweep(small_cfg(jconfig), dtype=jnp.float64,
                                     **kw)
    got = sweep.run_synthetic_sweep(small_cfg(tconfig), dtype=torch.float64,
                                    device="cpu", **kw)
    assert len(got) == len(ref) == 1
    g, r = got[0], ref[0]
    assert (g.name, g.frames, g.n_good_mean) == (r.name, r.frames,
                                                 r.n_good_mean)
    assert g.frames > 30 and np.isfinite(g.ate_m)
    assert abs(g.ate_m - r.ate_m) < 1e-8 and abs(g.rpe_m - r.rpe_m) < 1e-8


@pytest.mark.parametrize("rows", [
    [("synthetic_seed0", 301, 0.0123, 0.0045, 812.25, 17.5),
     ("V1_01_easy", 2911, float("nan"), float("nan"), 95.0, 0.0),
     ("MH_01_easy_with_a_long_name", 3640, 1.25, 0.5, 1e4 / 3, 123.456)],
    []])
def test_format_table_matches_jax(rows):
    """Rows with a NaN ATE (left out of the mean) and a long name; no rows
    (the header alone)."""
    assert sweep.format_table([sweep.SweepRow(*r) for r in rows]) == \
        jsweep.format_table([jsweep.SweepRow(*r) for r in rows])


def test_cli_sweep_prints_table(tmp_path, capsys):
    from rvio_tpu_torch.run import main
    cfg_path = tmp_path / "small.yaml"
    cfg_path.write_text(
        "imu: {rate_hz: 100.0}\ncamera: {fps: 10.0}\n"
        "tracker: {num_features: 24, max_tracking_length: 6, "
        "min_tracking_length: 3}\ntpu: {imu_block: 16}\n")
    assert main(["--sweep", "1", "--device", "cpu", "--config",
                 str(cfg_path), "--output", str(tmp_path / "out")]) == 0
    printed = capsys.readouterr().out
    head, *lines = printed.strip().splitlines()[-3:]
    assert head.split() == ["sequence", "frames", "ATE[m]", "RPE[m]", "fps",
                            "feat"]
    assert lines[0].startswith("synthetic_seed0") and \
        lines[1].startswith("mean")
    assert int(lines[0].split()[1]) > 100
