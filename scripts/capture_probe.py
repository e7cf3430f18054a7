#!/usr/bin/env python3
"""Which linear-algebra calls of the filter's update can be captured into a
CUDA graph, at the feature path's shapes on the card.

Each case runs in a child process of its own, because a call that refuses
capture may abort the process (that is how a graphed QR scan failed).  A
child builds its inputs from a seed, runs the call eagerly, captures it
into a CUDA graph (``capture_error_mode="global"``, on a side stream, as
runtime/graph.py captures a frame), replays the graph and compares the
replay's outputs with the eager ones.  The parent prints one line a case
and one JSON object: the child's return code, whether capture and replay
worked, and the largest difference relative to the largest output.

    python3 scripts/capture_probe.py [--jobs 4] [--out probe.json]

Needs a CUDA device.  The cases: the library calls of the QR route and
the unfused Cholesky chain (``torch.cholesky_solve``, which the EKF
correction used to make, one ``torch.linalg.qr`` of the masked stack,
``torch.linalg.cholesky_ex``), and the port's own forms (its
``cholesky_solve`` by two ``solve_triangular``s, the CholeskyQR2 TSQR tree
that reduces feature shards, the EKF correction, the chain at n = 96 and
114).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (the inputs' code, the call's code), run at each batch B of BATCHES
_SPD = ("g = torch.randn(B, n, n + 8, generator=gen) / (n + 8) ** 0.5\n"
        "S = (g @ g.transpose(-1, -2) + 0.1 * torch.eye(n)).cuda()\n")
_STACK = ("A = torch.randn(B, 3000, 84, generator=gen)\n"
          "A[:, 1500:] = 0\n"
          "A = A.cuda(); r = torch.randn(B, 3000, generator=gen).cuda()\n")
_TAIL = ("C = (lambda h: h.transpose(-1, -2) @ h)(torch.randn(B, 2 * n, n, "
         "generator=gen)).cuda()\n"
         "b = torch.randn(B, n, generator=gen).cuda()\n"
         "g = torch.randn(B, 24 + n, 24 + n, generator=gen) * 0.05\n"
         "P = (g @ g.transpose(-1, -2) + 1e-4 * torch.eye(24 + n)).cuda()\n"
         "s2 = torch.full((B,), 2.3e-6).cuda()\n")
CASES = {
    "torch.cholesky_solve": (
        "n = 84\n" + _SPD + "L = torch.linalg.cholesky(S)\n"
        "X = torch.randn(B, n, 108, generator=gen).cuda()\n",
        "torch.cholesky_solve(X, L)"),
    "torch.linalg.qr": (_STACK, "torch.linalg.qr(A, mode='reduced')"),
    "torch.linalg.cholesky_ex": ("n = 84\n" + _SPD,
                                 "torch.linalg.cholesky_ex(S)[0]"),
    "ekf_tail.cholesky_solve (two solve_triangular)": (
        "n = 84\n" + _SPD + "L = torch.linalg.cholesky(S)\n"
        "X = torch.randn(B, n, 108, generator=gen).cuda()\n",
        "ekf_tail.cholesky_solve(L, X)"),
    "update.tsqr_compress(method='cholqr2')": (
        _STACK, "update.tsqr_compress(A, r, method='cholqr2')"),
    "ekf_tail.ekf_correction": (
        "n = 84\n" + _TAIL + "R = torch.linalg.cholesky(C).transpose(-1, -2)"
        "\n", "ekf_tail.ekf_correction(P, R, b, s2)"),
    "ekf_tail.cholesky_tail n=96": ("n = 96\n" + _TAIL,
                                    "ekf_tail.cholesky_tail(C, b, P, s2)"),
    "ekf_tail.cholesky_tail n=114": ("n = 114\n" + _TAIL,
                                     "ekf_tail.cholesky_tail(C, b, P, s2)"),
}
BATCHES = (1, 4)

CHILD = r'''
import json, sys, torch
from rvio_tpu_torch.filter import update
from rvio_tpu_torch.ops import ekf_tail
B = {B}
gen = torch.Generator().manual_seed(0)
{inputs}
def call():
    out = {call}
    return out if isinstance(out, tuple) else (out,)
eager = call()
torch.cuda.synchronize()
side = torch.cuda.Stream()
side.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(side):
    call()
torch.cuda.current_stream().wait_stream(side)
graph = torch.cuda.CUDAGraph()
with torch.cuda.graph(graph, capture_error_mode="global"):
    outs = call()
graph.replay()
torch.cuda.synchronize()
err = max(float(((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1e-30)))
          for a, b in zip(outs, eager))
print(json.dumps({{"captured": True, "rel_err": err}}))
'''


def run_case(name: str, B: int) -> dict:
    inputs, call = CASES[name]
    code = CHILD.format(B=B, inputs=inputs, call=call)
    env = dict(os.environ, PYTHONPATH=ROOT)
    try:
        p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        return {"case": name, "B": B, "rc": None, "captured": False,
                "error": "timed out after 300 s"}
    rec = {"case": name, "B": B, "rc": p.returncode, "captured": False}
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    if p.returncode == 0 and lines:
        rec.update(json.loads(lines[-1]))
    else:
        err = [ln for ln in p.stderr.strip().splitlines() if ln.strip()]
        rec["error"] = " | ".join(err[-3:])[-600:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("capture_probe: needs a CUDA device", file=sys.stderr)
        return 1
    jobs = [(name, B) for name in CASES for B in BATCHES]
    with ThreadPoolExecutor(args.jobs) as pool:
        recs = list(pool.map(lambda j: run_case(*j), jobs))
    for r in recs:
        state = (f"captured, replay within {r['rel_err']:.3e} of eager"
                 if r["captured"] else f"REFUSED (rc {r['rc']}): "
                 f"{r.get('error', '')}")
        print(f"{r['case']} at B = {r['B']}: {state}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "cases": recs}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
