"""The readings the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 -m benchmark.calibrate --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--control K]

For each seed, in one process: the cell's set-up and a window of
``--seconds``, then every number the cell compares, of the program
against the reference (the lower readings); on the first K seeds also of
the control against the reference: the reference itself with TF32
products, the step below the configuration's float32 (the upper
readings).  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import harness
from benchmark.drivers import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    for i, seed in enumerate(a.seeds):
        t0 = time.perf_counter()
        run = harness.make_run(a.workload, seed, a.seconds, False, "cuda")
        drv = harness.driver(run.traffic["driver"])
        state = drv.setup(run)
        out = drv.window(run, state)
        prog = drv.outputs(out)
        if "scan" in state:
            for k in ("scan", "states", "bundles"):
                state.pop(k)
        common.free_device(run.device)
        t1 = time.perf_counter()
        ref = drv.reference(run, state)
        t2 = time.perf_counter()
        line = {"seed": seed, "program": drv.judge(run, prog, ref),
                "reference_s": t2 - t1, "run_s": t1 - t0}
        if i < a.control:
            ctl = drv.reference(run, state, tf32=True)
            line["control"] = drv.judge(run, drv.answers(ctl), ref)
            line["control_s"] = time.perf_counter() - t2
        print(json.dumps(line), flush=True)
        del state, out, prog, ref
        common.free_device(run.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
