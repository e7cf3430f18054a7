#!/usr/bin/env python3
"""Each CUDA kernel against its plain version over several input seeds.

    python3 scripts/kernel_margins.py [--seeds 10]

Runs the checks of ``rvio_tpu_torch/ops/checks.py`` (the ones chip_smoke.py
runs with seed 0, and K5 on the inputs that take the wider ridge) for seeds
0 .. N-1 on the CUDA card and prints one line per kernel and seed: the
compared error, what the check counted (for subpix_refine the worst corner,
its determinant and condition number; for K5 P_new's error scaled by its
diagonal), then per kernel the largest error over the seeds beside its
tolerance.  A check over its tolerance is printed as such and the script
exits 1 at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_margins: needs a CUDA device", file=sys.stderr)
        return 1
    from rvio_tpu_torch.ops import _lib
    from rvio_tpu_torch.ops.checks import (EKF_TAIL_FALLBACK_SCALED_TOL,
                                           EKF_TAIL_FALLBACK_TOL,
                                           ekf_tail_case,
                                           ekf_tail_fallback_inputs,
                                           kernel_checks)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    _lib.build()
    dev = torch.device("cuda", 0)
    worst, worst_scaled, tolerance, failed = {}, {}, {}, 0
    for seed in range(args.seeds):
        wider = ekf_tail_case(
            dev, *ekf_tail_fallback_inputs(np.random.default_rng(seed)),
            tol=EKF_TAIL_FALLBACK_TOL, what="wider ridge",
            scaled_tol=EKF_TAIL_FALLBACK_SCALED_TOL)
        wider = dataclasses.replace(wider, name="ekf_tail (wider ridge)")
        for chk in kernel_checks(dev, seed=seed) + [wider]:
            tolerance[chk.name] = chk.tolerance
            try:
                err = chk.check()
            except AssertionError as e:
                print(f"seed {seed} {chk.name}: FAILED {e}", flush=True)
                failed += 1
                continue
            worst[chk.name] = max(worst.get(chk.name, 0.0), err)
            scaled = chk.info.get("P_new scaled by its diagonal")
            if scaled is not None:
                worst_scaled[chk.name] = max(worst_scaled.get(chk.name, 0.0),
                                             float(scaled))
            print(f"seed {seed} {chk.name}: err {err:.3e} {chk.info}",
                  flush=True)
    for name, err in worst.items():
        scaled = (f", P_new scaled by its diagonal {worst_scaled[name]:.3e}"
                  if name in worst_scaled else "")
        print(f"{name}: largest error {err:.3e}{scaled} over {args.seeds} "
              f"seeds (tolerance: {tolerance[name]})")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
