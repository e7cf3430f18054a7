#!/usr/bin/env python3
"""How far K5's P_new parts from f64 in each order of the Joseph form.

    python3 scripts/joseph_order.py [--seeds 97 98 99] [--clones 14 16]
        [--device cuda|cpu]

For each seed and each window of ``--clones`` clones (n = 6 x clones; 14
is ``RVIOConfig()``'s n = 84, which the narrow kernel csrc/ekf_tail.cu
takes, 16 the wide route's n = 96) it builds the seeded stack of
tests/test_ops.py (ops/checks.py ``ekf_tail_stack``, 3840 rows) and reads
P_new against the chain's order in f64 (ops/checks.py ``joseph_p_new``),
scaled entry by entry by sqrt(P_ii P_jj) (``scaled_cov_err``):

- ``chain_f32``: the chain's order emulated in f32 on the CPU (I - K Hn
  formed first, S symmetrized; what ``cholesky_tail``, both routes of K5
  and the TPU kernel take);
- ``narrow_f32``: the narrow kernel's earlier order emulated in f32 on
  the CPU (A P = P - G P[24:, :], then (A P) - (A P)[:, 24:] G^T; S's
  lower triangle unsymmetrized);
- ``kernel``: ``ekf_tail`` on ``--device`` (default: the card where there
  is one), which takes the narrow kernel at n <= 92 and the wide route
  above.

Prints one JSON object a line, then a line with the card's name and power
limit where it ran on the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rvio_tpu_torch.ops.checks import (ekf_tail_stack, joseph_p_new,  # noqa: E402
                                       scaled_cov_err)
from rvio_tpu_torch.ops.ekf_tail import NMAX, ekf_tail  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[97, 98, 99])
    ap.add_argument("--clones", type=int, nargs="+", default=[14, 16])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    dev = torch.device(args.device or
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    for M in args.clones:
        for seed in args.seeds:
            C, b, P, sig2 = (torch.as_tensor(np.asarray(x)) for x in
                             ekf_tail_stack(np.random.default_rng(seed), M,
                                            3840))
            ref = joseph_p_new(*(x.double() for x in (C, b, P, sig2)),
                               True).numpy()

            def err(x):
                return scaled_cov_err(x.double().cpu().numpy(), ref)

            _, P_new, _ = ekf_tail(*(x[None].to(dev) for x in
                                     (C, b, P, sig2)))
            print(json.dumps(dict(
                n=6 * M, seed=seed, device=str(dev),
                kernel_route="narrow" if 6 * M <= NMAX else "wide",
                chain_f32=err(joseph_p_new(C, b, P, sig2, True)),
                narrow_f32=err(joseph_p_new(C, b, P, sig2, False)),
                kernel=err(P_new[0]))), flush=True)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
