"""Offline trajectory evaluation CLI (evo-style).

A copy of rvio_tpu/eval/__main__.py (numpy and the standard library only).

The reference's validation loop writes TUM files and evaluates them with
external tools (reference: README.md + System.cc:371-374, "use evo /
rpg_trajectory_evaluation").  This makes the same evaluation a built-in:

    python -m rvio_tpu_torch.eval est.tum gt.tum [--scale] [--rpe-delta N]

Estimate timestamps are matched to the nearest ground-truth timestamps
(0.02 s default tolerance), then SE(3) (or Sim(3) with --scale) Umeyama
alignment + ATE RMSE, plus RPE over a fixed frame delta.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from rvio_tpu_torch.dataio.tum import read_tum
from rvio_tpu_torch.eval.ate import ate_rmse, rpe_rmse


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m rvio_tpu_torch.eval",
        description="ATE/RPE between two TUM trajectory files")
    ap.add_argument("est", help="estimated trajectory (TUM format)")
    ap.add_argument("gt", help="ground-truth trajectory (TUM format)")
    ap.add_argument("--scale", action="store_true",
                    help="Sim(3) alignment (monocular scale ambiguity)")
    ap.add_argument("--rpe-delta", type=int, default=20,
                    help="RPE frame delta (default 20 = 1 s at 20 Hz)")
    ap.add_argument("--max-dt", type=float, default=0.02,
                    help="max est-to-gt timestamp distance [s]")
    args = ap.parse_args(argv)

    et, ep, _eq = read_tum(args.est)
    gt_t, gp, _gq = read_tum(args.gt)
    gi = np.clip(np.searchsorted(gt_t, et), 1, len(gt_t) - 1)
    gi = np.where(np.abs(gt_t[gi - 1] - et) < np.abs(gt_t[gi] - et),
                  gi - 1, gi)
    ok = np.abs(gt_t[gi] - et) <= args.max_dt
    if ok.sum() < 3:
        print(f"only {int(ok.sum())} matched poses (tolerance "
              f"{args.max_dt}s) — cannot evaluate", file=sys.stderr)
        return 1
    e = ep[ok]
    g = gp[gi[ok]]
    ate = ate_rmse(e, g, with_scale=args.scale)
    rpe = rpe_rmse(e, g, delta=args.rpe_delta)
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    print(f"matched {int(ok.sum())}/{len(et)} poses, span {span:.2f} m")
    print(f"ATE RMSE: {ate:.4f} m"
          + (" (Sim3-aligned)" if args.scale else " (SE3-aligned)"))
    print(f"RPE RMSE (delta={args.rpe_delta}): {rpe:.4f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
