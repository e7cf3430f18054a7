#!/usr/bin/env python3
"""Each CUDA kernel against its plain version over several input seeds.

    python3 scripts/kernel_margins.py [--seeds 10]

Runs the checks of ``rvio_tpu_torch/ops/checks.py`` (the ones chip_smoke.py
runs with seed 0) for seeds 0 .. N-1 on the CUDA card and prints one line
per kernel and seed: the compared error, what the check counted (for
subpix_refine the worst corner, its determinant and condition number), then
per kernel the largest error over the seeds beside its tolerance.  A check
over its tolerance is printed as such and the script exits 1 at the end.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

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
    from rvio_tpu_torch.ops.checks import kernel_checks

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    _lib.build()
    dev = torch.device("cuda", 0)
    worst, tolerance, failed = {}, {}, 0
    for seed in range(args.seeds):
        for chk in kernel_checks(dev, seed=seed):
            tolerance[chk.name] = chk.tolerance
            try:
                err = chk.check()
            except AssertionError as e:
                print(f"seed {seed} {chk.name}: FAILED {e}", flush=True)
                failed += 1
                continue
            worst[chk.name] = max(worst.get(chk.name, 0.0), err)
            print(f"seed {seed} {chk.name}: err {err:.3e} {chk.info}",
                  flush=True)
    for name, err in worst.items():
        print(f"{name}: largest error {err:.3e} over {args.seeds} seeds "
              f"(tolerance: {tolerance[name]})")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
