#!/usr/bin/env python3
"""The warm segment split of tests/test_handoff.py's slow case, on any
device and dtype.

    python3 scripts/warm_split.py [--device cpu|cuda] [--dtype float32|float64]
        [--threads 4]

The small config (24 features, 6-frame tracks, 10 Hz camera, 100 Hz IMU)
on a 300 s synthetic drive of seed 5 through the unsplit sequence scan
and through ``run_segments_warm`` (8 segments, a warm-up of 150 frames);
prints each run's seconds and the test's gates: split ATE within 0.05 m
of the unsplit ATE, the largest split-vs-unsplit deviation under 0.6 m,
every segment's mean n_good over 3, and the repaired segments.  Exits 1
if a gate fails.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--threads", type=int, default=4)
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    from rvio_tpu_torch import config as tconfig
    from rvio_tpu_torch.bench import feature_bundles
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.eval.ate import ate_rmse
    from rvio_tpu_torch.parallel import run_segments_warm
    from rvio_tpu_torch.runtime import make_sequence_scan
    dtype = getattr(torch, a.dtype)
    cfg = tconfig.RVIOConfig(
        imu=tconfig.ImuConfig(rate_hz=100.0),
        camera=tconfig.CameraConfig(fps=10.0),
        tracker=tconfig.TrackerConfig(num_features=24, max_tracking_length=6,
                                      min_tracking_length=3),
        tpu=tconfig.TpuConfig(imu_block=16))
    sim = simulate_sequence(cfg, duration=300.0, static_time=1.0, seed=5,
                            meas_noise=5e-4, imu_noise=True)
    state0, bundles, idx0 = feature_bundles(cfg, sim, a.device, dtype)
    gt = sim.gt_p[idx0:]
    t0 = time.perf_counter()
    _, out = make_sequence_scan(cfg, a.device, dtype)(state0, bundles)
    full = out["p_Gk"].double().cpu().numpy()
    t_full = time.perf_counter() - t0
    t0 = time.perf_counter()
    stitched, outs, info = run_segments_warm(cfg, state0, bundles, 8, 150,
                                             device=a.device)
    t_split = time.perf_counter() - t0
    ate_full, ate_split = ate_rmse(full, gt), ate_rmse(stitched, gt)
    dev_max = float(np.linalg.norm(stitched - full, axis=1).max())
    ng, ok = outs["n_good"].cpu().numpy(), outs["ok"].cpu().numpy()
    ng_mean = [float(ng[s][ok[s]].mean()) for s in range(ng.shape[0])]
    print(f"{a.device} {a.dtype}: {len(gt)} frames; unsplit {t_full:.1f} s, "
          f"ATE {ate_full:.4f} m; split {t_split:.1f} s, ATE "
          f"{ate_split:.4f} m (limit {ate_full + 0.05:.4f}); largest "
          f"deviation {dev_max:.4f} m (limit 0.6); n_good a segment "
          f"{[round(x, 2) for x in ng_mean]} (limit 3); repaired "
          f"{info['repaired_segments']}")
    ok_all = (ate_split <= ate_full + 0.05 and dev_max < 0.6
              and min(ng_mean) > 3.0)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
