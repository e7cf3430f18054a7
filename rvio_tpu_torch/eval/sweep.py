"""Multi-sequence accuracy/throughput sweep.

Port of rvio_tpu/eval/sweep.py.  The reference's de-facto benchmark is
the 11-sequence EuRoC ATE sweep run by hand (reference: README.md:70-86).
This harness runs the equivalent: a set of sequences (synthetic seeds
and/or EuRoC directories) through the filter, each one's ATE/RPE, and the
table.  ``SweepRow`` and ``format_table`` are copies; the runners drive
the port's ``SequenceDriver`` and ``run_euroc_sequence``, on the CUDA
device unless ``device`` says otherwise.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class SweepRow:
    name: str
    frames: int
    ate_m: float
    rpe_m: float
    fps: float
    n_good_mean: float


def run_synthetic_sweep(cfg, seeds=(0, 1, 2, 3, 4), duration: float = 30.0,
                        dtype=None, noise: bool = True,
                        progress: bool = False, device=None
                        ) -> List[SweepRow]:
    """One row a seed: the simulator's sequence with the JAX function's
    arguments (rvio_tpu/eval/sweep.py:28-60) through ``SequenceDriver``
    in ``dtype`` (default f32) on ``device`` (default the CUDA device);
    fps is frames over the run's wall, which ends in
    ``SequenceDriver.run``'s readback."""
    import torch

    from rvio_tpu_torch.dataio.synthetic import simulate_sequence
    from rvio_tpu_torch.eval.ate import ate_rmse, rpe_rmse
    from rvio_tpu_torch.runtime.driver import SequenceDriver, batches_from_sim

    dtype = dtype or torch.float32
    driver = SequenceDriver(cfg, dtype=dtype, device=device)
    rows = []
    for seed in seeds:
        sim = simulate_sequence(cfg, duration=duration, static_time=1.5,
                                ramp_time=3.0, seed=seed, n_landmarks=1500,
                                motion_scale=0.8,
                                meas_noise=0.001 if noise else 0.0,
                                imu_noise=noise)
        t0 = time.perf_counter()
        res = driver.run(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t,
                         batches_from_sim(sim))
        wall = time.perf_counter() - t0
        idx = np.searchsorted(sim.frame_t, res.timestamps)
        ate = ate_rmse(res.positions, sim.gt_p[idx])
        rpe = rpe_rmse(res.positions, sim.gt_p[idx])
        rows.append(SweepRow(f"synthetic_seed{seed}", len(res.timestamps),
                             ate, rpe, len(res.timestamps) / wall,
                             float(res.n_good.mean())))
        if progress:
            print(f"{rows[-1].name}: ATE {ate*100:.1f} cm, "
                  f"{rows[-1].fps:.0f} fps")
    return rows


def run_euroc_sweep(cfg, sequence_dirs: List[str],
                    skips: Optional[List[float]] = None, dtype=None,
                    progress: bool = False, device=None) -> List[SweepRow]:
    """One row a EuRoC folder (rvio_tpu/eval/sweep.py:63-89): the
    per-frame replay ``run_euroc_sequence`` on ``device``, ATE and RPE
    against the ground truth matched by ``match_nearest`` (NaN where
    fewer than three frames match); ``progress`` prints each row."""
    import torch

    from rvio_tpu_torch.dataio.euroc import load_euroc
    from rvio_tpu_torch.device import resolve_device
    from rvio_tpu_torch.eval.ate import ate_rmse, match_nearest, rpe_rmse
    from rvio_tpu_torch.runtime.image_driver import run_euroc_sequence

    device = resolve_device(device)    # before any folder is read
    dtype = dtype or torch.float32
    skips = skips or [0.0] * len(sequence_dirs)
    rows = []
    for d, skip in zip(sequence_dirs, skips):
        seq = load_euroc(d, skip_s=skip)
        t0 = time.perf_counter()
        res = run_euroc_sequence(cfg, seq, dtype=dtype, device=device)
        wall = time.perf_counter() - t0
        ate = rpe = float("nan")
        if seq.gt_p is not None:
            gi, ok = match_nearest(seq.gt_t, res.timestamps)
            if ok.sum() >= 3:
                ate = ate_rmse(res.positions[ok], seq.gt_p[gi][ok])
                rpe = rpe_rmse(res.positions[ok], seq.gt_p[gi][ok])
        rows.append(SweepRow(d.rstrip("/").split("/")[-1],
                             len(res.timestamps), ate, rpe,
                             len(res.timestamps) / wall,
                             float(res.n_good.mean())))
        if progress:
            print(f"{rows[-1].name}: ATE {ate*100:.1f} cm, "
                  f"{rows[-1].fps:.0f} fps")
    return rows


def format_table(rows: List[SweepRow]) -> str:
    out = [f"{'sequence':24s} {'frames':>7s} {'ATE[m]':>8s} {'RPE[m]':>8s} "
           f"{'fps':>8s} {'feat':>6s}"]
    for r in rows:
        out.append(f"{r.name:24s} {r.frames:7d} {r.ate_m:8.3f} {r.rpe_m:8.3f} "
                   f"{r.fps:8.1f} {r.n_good_mean:6.1f}")
    if rows:
        ates = [r.ate_m for r in rows if np.isfinite(r.ate_m)]
        out.append(f"{'mean':24s} {'':7s} {np.mean(ates):8.3f}")
    return "\n".join(out)
