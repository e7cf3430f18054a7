#!/usr/bin/env python3
"""Where the time of K5 (csrc/ekf_tail.cu) goes, phase by phase, on the card.

    python3 scripts/ekf_tail_phases.py [--source FILE] [--reps 50]

Builds a throwaway copy of the kernel's source (into the git-ignored
``rvio_tpu_torch/build/phases/``) with a ``clock64()`` stamp at the start
of each phase: thread 0 of the first CTA writes it after a barrier, so a
phase's cycles are those of the whole CTA (for the cluster design, of the
cluster's first CTA, whose peers run the same phases in step).  The
shipped source marks its phases with ``// phase: <name>`` comments, where
the copy inserts the stamps; a source without such comments is taken to
be the first design (one block of 512 threads, in the repository up to
commit b626852), whose phase boundaries the script knows.  The copy
runs on the seeded stack of ops/checks.py (n = 84, D = 108, one system)
and must give the unstamped copy's result bitwise; the script prints the
card, the source's own device time (an unstamped copy built beside it, a
CUDA graph of 200 launches) and its error against the plain version, the
stamped copy's time, and each phase's mean cycles over ``--reps``
launches, its share, and that share of the unstamped device time.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STAMP = ("__syncthreads(); if (threadIdx.x == 0 && blockIdx.x == 0) "
         "rvio_st[{k}] = clock64();")

# The first design's phase boundaries: a stamp after each anchor.
FIRST_DESIGN = [
    ("  const float s2 = sig2[e];\n", "start"),
    ("  load_ridged(Lc, nP, Ce, n, INFO_RIDGE * scale);\n", "load C, P, b"),
    ("  if (tid == 0) fallback[e] = fb;\n", "factor C"),
    ("      st4(&Q[i * DP + c], s);\n    }\n    __syncthreads();\n",
     "Q = Lc^T P[24:, :]"),
    ("        st4(&R1[i * nP + k], s);\n      }\n    }\n    __syncthreads();\n",
     "rn || S = Q Lc"),
    ("        R1[i * nP + k] += s2;\n      }\n    }\n    __syncthreads();\n",
     "symmetrize S"),
    ("    ok = cholesky_inplace(R1, n, nP, xbuf);\n", "factor S"),
    ("  solve_inplace(R1, n, nP, Q, DP, DP, xbuf, rd, false);\n", "solve Ls^-1"),
    ("  solve_inplace(R1, n, nP, Q, DP, DP, xbuf, rd, true);\n", "solve Ls^-T"),
    ("    st4(&Gt[i * DP + c], s);\n  }\n  __syncthreads();\n", "dx, G^T"),
    ("acc[a][2], acc[a][3]));\n  }\n  __syncthreads();\n", "A P"),
    ("acc[a][3] + s2 * kk[a][3]));\n  }\n  __syncthreads();\n", "X"),
    ("    Pne[idx] = 0.5f * (Pm[i * DP + k] + Pm[k * DP + i]);\n  }\n", "store"),
]
# A source with phase comments: the last phase ends with the kernel, whose
# closing brace comes before `configure` (csrc/ekf_tail.cu since the batch
# axis) or, in earlier designs, is the last before the anonymous
# namespace's.
KERNEL_ENDS = ("}\n\n// Sets the kernel's dynamic shared memory limit",
               "}\n\n}  // namespace")


def instrument(src: str):
    """(instrumented source, phase names): names[k] is the phase that ends
    at stamp k + 1."""
    marks = list(re.finditer(r"^ *// phase: ([^.\n]*)", src, flags=re.M))
    if marks:
        names, out, pos = [], [], 0
        for k, m in enumerate(marks):
            out += [src[pos:m.start()], STAMP.format(k=k) + "\n"]
            pos = m.start()
            names.append(m.group(1).strip())
        out.append(src[pos:])
        src = "".join(out)
        end = next(e for e in KERNEL_ENDS if e in src)
        i = src.rindex(end)
        src = src[:i] + STAMP.format(k=len(marks)) + "\n" + src[i:]
    else:
        names = []
        for k, (anchor, name) in enumerate(FIRST_DESIGN):
            i = src.index(anchor) + len(anchor)
            stamp = STAMP.format(k=k)
            if k == 0:
                stamp = stamp.replace("__syncthreads(); ", "")
            src = src[:i] + stamp + "\n" + src[i:]
            if k:
                names.append(name)
    src = src.replace("bool* __restrict__ fallback, int n) {",
                      "bool* __restrict__ fallback, int n, "
                      "long long* rvio_st) {", 1)
    i = src.rindex("fallback, n);")
    src = src[:i] + "fallback, n, rvio_st);" + src[i + len("fallback, n);"):]
    src = src.replace("int B, int n, cudaStream_t stream) {",
                      "int B, int n, cudaStream_t stream, "
                      "long long* rvio_st) {", 1)
    return src, names


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=str(ROOT / "rvio_tpu_torch" / "csrc"
                                            / "ekf_tail.cu"))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ekf_tail_phases: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import device_ms
    from rvio_tpu_torch.ops import _lib
    from rvio_tpu_torch.ops.checks import kernel_checks

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    source = Path(args.source)
    text = source.read_text()
    header = source.parent / _lib.HEADER
    out = _lib.BUILD / "phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / _lib.HEADER).write_text(header.read_text())

    def build(name, code, stamps):
        cu = out / f"{name}.cu"
        cu.write_text(code)
        so = out / f"lib{name}.so"
        subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(so),
                        str(cu)], check=True, capture_output=True, text=True)
        fn = ctypes.CDLL(str(so)).rvio_ekf_tail
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + \
            [ctypes.c_void_p] * (2 if stamps else 1)
        fn.restype = ctypes.c_int
        return fn

    stamped, names = instrument(text)
    fn_plain = build("ekf_tail_copy", text, False)
    fn_stamp = build("ekf_tail_stamped", stamped, True)

    dev = torch.device("cuda", 0)
    chk = kernel_checks(dev)[-1]               # the seeded stack
    C, b, P, s2 = chk.args
    B, n = C.shape[0], C.shape[-1]
    D = 24 + n
    outs = {k: (torch.empty(B, D, device=dev),
                torch.empty(B, D, D, device=dev),
                torch.empty(B, dtype=torch.bool, device=dev))
            for k in ("copy", "stamped")}
    st = torch.zeros(len(names) + 1, dtype=torch.int64, device=dev)

    def launcher(fn, key, extra):
        def run():
            err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in
                       (C, b, P, s2, *outs[key])), B, n,
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
                     *extra)
            if err:
                raise RuntimeError(f"{key} launch failed ({err})")
        return run

    run_copy = launcher(fn_plain, "copy", ())
    run = launcher(fn_stamp, "stamped", (ctypes.c_void_p(st.data_ptr()),))
    run_copy()
    run()
    torch.cuda.synchronize()
    err = chk.compare(outs["copy"], chk.run_plain())
    same = all(torch.equal(x, y) for x, y in zip(outs["copy"],
                                                  outs["stamped"]))
    t_ship = device_ms(run_copy, 200)
    t_inst = device_ms(run, 200)
    acc = np.zeros(len(names) + 1)
    for _ in range(args.reps):
        run()
        torch.cuda.synchronize()
        acc += st.cpu().numpy()
    s = acc / args.reps
    total = s[-1] - s[0]
    print(f"card: {smi}")
    print(f"source {source}: {t_ship * 1e3:.2f} us a launch (error against "
          f"the plain version {err:.3e}; {chk.tolerance}), stamped copy "
          f"{t_inst * 1e3:.2f} us (result "
          f"{'bitwise the unstamped one' if same else 'DIFFERS'}), "
          f"{total:.0f} cycles stamped")
    for k, name in enumerate(names):
        d = s[k + 1] - s[k]
        print(f"  {name:28s} {d:9.0f} cycles {100 * d / total:5.1f} %  "
              f"{d / total * t_ship * 1e3:8.2f} us of the unstamped time")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
