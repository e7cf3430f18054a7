#!/usr/bin/env python3
"""Where the time of K1 (csrc/propagate_block.cu) and K4 (csrc/spd_solve.cu)
goes, phase by phase, on the card.

    python3 scripts/filter_kernel_phases.py [--kernel k1|k4|both]
        [--k1-source FILE] [--k4-source FILE] [--reps 50]

For each kernel it builds two throwaway copies of the source into the
git-ignored ``rvio_tpu_torch/build/phases/``: the source as it is, and one
with a ``clock64()`` stamp at each ``// phase: <name>`` comment and at the
kernel's end.  A stamp waits at a barrier (``__syncthreads()``, or
``__syncwarp()`` in a kernel that has no block barrier), then thread 0 of
the first block adds the cycles since the previous stamp to the phase that
was running; a phase inside a loop adds up over its trips.  A source
without phase comments is taken to be the design of commit a8e45c3 (K1 one
block of 576 threads, K4 one block of 256 threads a feature), whose phase
boundaries the script knows; save it with its ``common.cuh`` beside it
(``git show a8e45c3:rvio_tpu_torch/csrc/propagate_block.cu``).

Inputs: the check cases of ``rvio_tpu_torch/ops/checks.py``, K1 at B = 1,
K = 16 with 11 valid samples and K4 at F = 100, m = 30.  It prints the
card, each copy's error against the plain version, the unstamped copy's
device time (a CUDA graph of 200 launches), the stamped copy's, whether
the two copies' outputs are bitwise equal (the script exits 1 if not), and
each phase's mean cycles over ``--reps`` launches, its share, and that
share of the unstamped device time.
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
CSRC = ROOT / "rvio_tpu_torch" / "csrc"
MAX_PHASES = 32

# Phase comments for the designs of commit a8e45c3: a comment line before
# each anchor.
OLD_DESIGN = {
    "k1": [("  P[i][j] = P0[(size_t)b * N * N + tid];\n", "load P0, Psi = I"),
           ("    Phi[i][j] = i == j ? 1.f : 0.f;\n", "per-sample reset"),
           ("    if (tid == 0) {\n      const size_t s", "thread-0 state step"),
           ("    const float dt = s_dt;\n", "Q, Phi Psi, Phi P"),
           ("    Psi[i][j] = psi;\n", "P write-back"),
           ("  P_out[(size_t)b * N * N + tid]", "store")],
    "k4": [("  for (int idx = tid; idx < mm; idx += blockDim.x) T[idx]",
            "load S, r"),
           ("  float acc = 0.f;", "30 Cholesky and substitution steps"),
           ("  if (tid == 0) D[f] = acc;", "store D")],
}
# The kernel is the last definition of the anonymous namespace.
KERNEL_END = "}\n\n}  // namespace"
INCLUDE = '#include "common.cuh"\n'
IO = """
extern "C" int rvio_phase_io(long long* host, int n, int read) {
  return static_cast<int>(
      read ? cudaMemcpyFromSymbol(host, rvio_st, n * sizeof(long long))
           : cudaMemcpyToSymbol(rvio_st, host, n * sizeof(long long)));
}
"""


def add_old_markers(src: str, kernel: str) -> str:
    for anchor, name in OLD_DESIGN[kernel]:
        i = src.index(anchor)
        indent = len(anchor) - len(anchor.lstrip(" "))
        src = src[:i] + " " * indent + f"// phase: {name}\n" + src[i:]
    return src


def instrument(src: str):
    """(stamped source, phase names).  Phase k accumulates into rvio_st[k]."""
    sync = "__syncthreads()" if "__syncthreads" in src else "__syncwarp()"

    def stamp(k):
        close = (f"if (rvio_ph >= 0) rvio_st[rvio_ph] += rvio_now - rvio_t; "
                 f"rvio_t = rvio_now;")
        return (f"{sync}; if (threadIdx.x == 0 && blockIdx.x == 0) "
                f"{{ long long rvio_now = clock64(); {close} }}"
                + ("" if k is None else f" rvio_ph = {k};"))

    marks = list(re.finditer(r"^( *)// phase: ([^\n]*)$", src, flags=re.M))
    if not marks:
        raise ValueError("the source has no // phase: comments")
    names, out, pos = [], [], 0
    for k, m in enumerate(marks):
        decl = "long long rvio_t = 0; int rvio_ph = -1; " if k == 0 else ""
        out += [src[pos:m.start()], m.group(1) + decl + stamp(k) + "\n"]
        pos = m.start()
        names.append(m.group(2).strip())
    out.append(src[pos:])
    src = "".join(out)
    i = src.rindex(KERNEL_END)
    src = src[:i] + "  " + stamp(None) + "\n" + src[i:]
    i = src.index(INCLUDE) + len(INCLUDE)
    src = (src[:i] + f"\n__device__ long long rvio_st[{MAX_PHASES}];\n"
           + src[i:] + IO)
    if len(names) > MAX_PHASES:
        raise ValueError("too many phases")
    return src, names


def _k1_call(chk):
    from rvio_tpu_torch.ops import propagate_block as k1
    w, a, dte, R0, vR, gR, bg, ba, P0 = chk.args
    kw = chk.kwargs
    B, K = dte.shape
    dev = P0.device
    outs = [torch.empty(s, device=dev) for s in
            ((B, 3, 3), (B, 3), (B, 3), (B, 24, 24), (B, 24, 24))]
    scalars = [B, K, float(kw["gravity"]), float(kw["small_angle"]),
               *k1._sig(kw["sigma_g"], kw["sigma_wg"], kw["sigma_a"],
                        kw["sigma_wa"])]
    return "rvio_propagate_block", k1._ARGS, [w, a, dte, R0, vR, gR, bg, ba,
                                              P0], outs, scalars


def _k4_call(chk):
    from rvio_tpu_torch.ops import spd_solve as k4
    S, r = chk.args
    F, m = S.shape[0], S.shape[-1]
    D = torch.empty(F, device=S.device)
    return "rvio_spd_quadform", k4._ARGS, [S, r], [D], [F, m]


KERNELS = {"k1": ("propagate_block", 0, _k1_call),
           "k4": ("spd_solve", 3, _k4_call)}


def bitwise_equal(xs, ys) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(xs, ys))


def split(kernel: str, source: Path, checks, reps: int) -> bool:
    from chip_smoke import device_ms
    from rvio_tpu_torch.ops import _lib
    lib, index, call = KERNELS[kernel]
    chk = checks[index]
    text = source.read_text()
    design = "its phase comments"
    if "// phase:" not in text:
        text = add_old_markers(text, kernel)
        design = "the phase boundaries of commit a8e45c3's design"
    stamped, names = instrument(text)

    out = _lib.BUILD / "phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / _lib.HEADER).write_text((source.parent / _lib.HEADER).read_text())
    procs = {}
    for tag, code in (("unstamped", text), ("stamped", stamped)):
        cu = out / f"{lib}_{tag}.cu"
        cu.write_text(code)
        so = out / f"lib{lib}_{tag}.so"
        procs[tag] = (so, subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    symbol, argtypes, ins, _, scalars = call(chk)
    fns, io = {}, None
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {tag} copy:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        print(f"  {tag} copy: {'; '.join(regs)}")
        handle = ctypes.CDLL(str(so))
        fn = getattr(handle, symbol)
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[tag] = fn
        if tag == "stamped":
            io = handle.rvio_phase_io
            io.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            io.restype = ctypes.c_int
    outs = {tag: call(chk)[3] for tag in fns}

    def launcher(tag):
        def run():
            stream = torch.cuda.current_stream().cuda_stream
            err = fns[tag](*(ctypes.c_void_p(t.data_ptr())
                             for t in ins + outs[tag]), *scalars,
                           ctypes.c_void_p(stream))
            if err:
                raise RuntimeError(f"{tag} launch failed ({err})")
        return run

    zero = np.zeros(MAX_PHASES, np.int64)
    run_copy, run_stamped = launcher("unstamped"), launcher("stamped")
    run_copy()
    run_stamped()
    torch.cuda.synchronize()
    result = outs["unstamped"]
    result = result if len(result) > 1 else result[0]
    err = chk.compare(result, chk.run_plain())
    same = bitwise_equal(outs["unstamped"], outs["stamped"])
    t_copy = device_ms(run_copy, 200)
    t_stamped = device_ms(run_stamped, 200)
    acc = np.zeros(MAX_PHASES)
    buf = np.zeros(MAX_PHASES, np.int64)
    for _ in range(reps):
        torch.cuda.synchronize()
        if io(zero.ctypes.data, MAX_PHASES, 0):
            raise RuntimeError("resetting the stamps failed")
        run_stamped()
        torch.cuda.synchronize()
        if io(buf.ctypes.data, MAX_PHASES, 1):
            raise RuntimeError("reading the stamps failed")
        acc += buf
    cyc = acc[:len(names)] / reps
    total = cyc.sum()
    print(f"{chk.name}, source {source} ({design}): {t_copy * 1e3:.2f} us a "
          f"launch on the device (error against the plain version "
          f"{err:.3e}; {chk.tolerance}), stamped copy {t_stamped * 1e3:.2f} "
          f"us (outputs {'bitwise the unstamped copy' if same else 'DIFFER'}"
          f"), {total:.0f} cycles between the first and the last stamp")
    for name, c in zip(names, cyc):
        print(f"  {name:36s} {c:9.0f} cycles {100 * c / total:5.1f} %  "
              f"{c / total * t_copy * 1e3:8.2f} us of the unstamped time")
    return same


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("k1", "k4", "both"), default="both")
    ap.add_argument("--k1-source", default=str(CSRC / "propagate_block.cu"))
    ap.add_argument("--k4-source", default=str(CSRC / "spd_solve.cu"))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("filter_kernel_phases: needs a CUDA device", file=sys.stderr)
        return 1
    from rvio_tpu_torch.ops.checks import kernel_checks
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    checks = kernel_checks(torch.device("cuda", 0))
    ok = True
    for kernel in (("k1", "k4") if args.kernel == "both" else (args.kernel,)):
        source = Path(getattr(args, f"{kernel}_source"))
        ok &= split(kernel, source, checks, args.reps)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
