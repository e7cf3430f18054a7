#!/usr/bin/env python3
"""Where the time of K5 goes on the card: the narrow kernel
(csrc/ekf_tail.cu) phase by phase, or the wide route
(csrc/ekf_tail_wide.cu) launch by launch.

    python3 scripts/ekf_tail_phases.py [--source FILE] [--reps 50]
    python3 scripts/ekf_tail_phases.py --wide [--sizes 96 192 384] [--stamps]

With ``--wide``: for each n of ``--sizes`` (a multiple of 6), the wide
route (csrc/ekf_tail_wide.cu, called directly, so also at n <= 92, where
``ekf_tail`` runs the narrow kernel, whose time is printed beside it) on
the seeded stack of scripts/joseph_order.py (ops/checks.py
``ekf_tail_stack``, seed 97, 3840 rows, one system) under torch.profiler,
``--reps`` calls:
each of the route's eight launches (C's factorization, P Hn^T, S, S's
factorization, the solves with dx, I - K Hn, (I - K Hn) P, the Joseph
form with its store) by its median device time, their sum, the call's
device time (a CUDA graph of 200 calls) and the unfused chain's, beside
the card's name and power limit.  With ``--stamps`` also a copy of the
route built with a ``clock64()`` stamp at each ``// phase:`` comment of
its factorization and solve kernels, taken by thread 0 of the first CTA
(of the first cluster) and summed over the call's two factorizations:
each phase's cycles a call, the copy's outputs bitwise the route's.

Without it:

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


WIDE_LAUNCHES = ("factor C (cluster)", "P Hn^T", "S", "factor S (cluster)",
                 "solves, dx", "I - K Hn", "(I - K Hn) P",
                 "Joseph form, store")


def stamped_wide(out: Path):
    """Build the stamped copy of csrc/ekf_tail_wide.cu (module docstring)
    into ``out``; returns (its ``rvio_ekf_tail_wide``, the read and reset
    functions of its stamp sums, the phase names)."""
    from rvio_tpu_torch.ops import _lib
    names = []

    def stamp(m):
        names.append(m.group(2).strip())
        return f"{m.group(1)}RVIO_STAMP({len(names) - 1});"
    text = re.sub(r"^( *)// phase: ([^\n]*)$", stamp,
                  (_lib.CSRC / "ekf_tail_wide.cu").read_text(), flags=re.M)
    text = text.replace('#include "common.cuh"\n', (
        '#include "common.cuh"\n'
        "__device__ unsigned long long rvio_prof[64];\n"
        "__device__ long long rvio_t0;\n"
        "#define RVIO_ME (threadIdx.x == 0 && blockIdx.x == 0 && "
        "blockIdx.y == 0)\n"
        "#define RVIO_START() do { if (RVIO_ME) rvio_t0 = clock64(); } "
        "while (0)\n"
        "#define RVIO_STAMP(k) do { if (RVIO_ME) { long long t = clock64(); "
        "rvio_prof[k] += t - rvio_t0; rvio_t0 = t; } } while (0)\n"), 1)
    for anchor in ("              int is_s) {\n",
                   "             int wt_global) {\n"):
        if anchor not in text:
            raise SystemExit(f"--stamps: no kernel opens with {anchor!r}")
        text = text.replace(anchor, anchor + "  RVIO_START();\n", 1)
    text += ('\nextern "C" int rvio_prof_read(unsigned long long* h) {\n'
             "  return (int)cudaMemcpyFromSymbol(h, rvio_prof, "
             "sizeof(rvio_prof));\n}\n"
             'extern "C" int rvio_prof_reset() {\n'
             "  unsigned long long z[64] = {};\n"
             "  return (int)cudaMemcpyToSymbol(rvio_prof, z, sizeof(z));\n}\n")
    (out / _lib.HEADER).write_text((_lib.CSRC / _lib.HEADER).read_text())
    cu = out / "ekf_tail_wide_stamped.cu"
    so = out / "libekf_tail_wide_stamped.so"
    cu.write_text(text)
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.rvio_ekf_tail_wide
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, lib.rvio_prof_read, lib.rvio_prof_reset, names


def wide_split(sizes, reps: int, smi: str, stamps: bool) -> int:
    """The wide route's launches at each n of ``sizes`` (module
    docstring); returns 0, or 1 where a stamped copy's outputs differ."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_ms, library_device_ms
    from rvio_tpu_torch.ops import _lib
    from rvio_tpu_torch.ops import ekf_tail as k5
    from rvio_tpu_torch.ops.checks import ekf_tail_stack
    dev = torch.device("cuda", 0)
    fn = _lib.function(k5._WIDE_LIB, "rvio_ekf_tail_wide", k5._WIDE_ARGS)

    def wide(C, b, P, sig2):
        """The wide route at any n, as ``ekf_tail`` launches it."""
        n = C.shape[-1]
        outs = (torch.empty(1, n + 24, device=dev),
                torch.empty(1, n + 24, n + 24, device=dev),
                torch.empty(1, dtype=torch.bool, device=dev))
        ws = torch.empty(k5.wide_workspace_floats(n), device=dev)
        _lib.call(k5._WIDE_LIB, fn, *map(_lib.ptr, (C, b, P, sig2, *outs, ws)),
                  1, n, device=dev)
        return outs

    print(f"card: {smi}")
    built, bad = None, False
    stacks, split = {}, {}
    # every size's profile before any CUDA graph is captured: after the
    # graphs of the timings below the profiler loses kernel events
    for n in sizes:
        if n % 6:
            raise SystemExit(f"--sizes: n = {n} is no window (6 x clones)")
        args = stacks[n] = [
            torch.as_tensor(np.asarray(x))[None].to(dev) for x in
            ekf_tail_stack(np.random.default_rng(97), n // 6, 3840)]
        wide(*args)
        torch.cuda.synchronize()
        # a profiler session a call: a call whose eight kernels are not all
        # seen is set aside
        k, us = len(WIDE_LAUNCHES), []
        for _ in range(reps):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                wide(*args)
                torch.cuda.synchronize()
            kern = sorted((e for e in prof.events()
                           if e.device_type.name == "CUDA"
                           and not e.name.startswith(("Memcpy", "Memset"))),
                          key=lambda e: e.time_range.start)
            if len(kern) == k:
                us.append([e.time_range.elapsed_us() for e in kern])
        if len(us) < reps // 2:
            raise SystemExit(f"n = {n}: {len(us)} of {reps} calls with all "
                             f"{k} kernels seen")
        split[n] = np.median(np.array(us), axis=0)
    for n in sizes:
        args, med = stacks[n], split[n]
        got, want = wide(*args), k5.ekf_tail_plain(*args)
        torch.cuda.synchronize()
        err = float((got[1] - want[1]).abs().max() / want[1].abs().max())
        call = device_ms(lambda: wide(*args), 200) * 1e3
        chain, how = library_device_ms(
            lambda: k5.cholesky_tail(*(a[0] for a in args)), 200)
        narrow = (f"; the narrow kernel "
                  f"{device_ms(lambda: k5.ekf_tail(*args), 200) * 1e3:.2f} us"
                  if n <= k5.NMAX else "")
        print(f"n = {n} (D = {n + 24}): {call:.2f} us a call on the device "
              f"(graph of 200; P_new {err:.2e} of its largest entry from the "
              f"plain version), the launches' medians sum to {med.sum():.2f} "
              f"us; the unfused chain {chain * 1e3:.2f} us ({how}){narrow}")
        for name, t in zip(WIDE_LAUNCHES, med):
            print(f"  {name:22s} {t:9.2f} us {100 * t / med.sum():5.1f} %")
    for n in sizes if stamps else ():
        args = stacks[n]
        print(f"n = {n}:")
        if built is None:
            from rvio_tpu_torch.ops import _lib
            out = _lib.BUILD / "phases"
            out.mkdir(parents=True, exist_ok=True)
            built = stamped_wide(out)
        fn, read, reset, names = built
        D = n + 24
        outs = (torch.empty(1, D, device=dev),
                torch.empty(1, D, D, device=dev),
                torch.empty(1, dtype=torch.bool, device=dev))
        ws = torch.empty(k5.wide_workspace_floats(n), device=dev)

        def run():
            err = fn(*(ctypes.c_void_p(t.data_ptr())
                       for t in (*args, *outs, ws)), 1, n,
                     ctypes.c_void_p(torch.cuda.current_stream()
                                     .cuda_stream))
            if err:
                raise RuntimeError(f"stamped launch failed ({err})")
        run()
        torch.cuda.synchronize()
        ref = wide(*args)
        same = all(torch.equal(x, y) for x, y in zip(ref, outs))
        bad |= not same
        reset()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 64)()
        read(buf)
        print(f"  stamped copy (outputs "
              f"{'bitwise the route' if same else 'DIFFER'}'s), cycles "
              f"a call of thread 0 of the first CTA:")
        for k, name in enumerate(names):
            print(f"    {name:26s} {buf[k] / reps:12.0f}")
    return int(bad)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=str(ROOT / "rvio_tpu_torch" / "csrc"
                                            / "ekf_tail.cu"))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--wide", action="store_true",
                    help="split the wide route by launch instead")
    ap.add_argument("--sizes", type=int, nargs="+", default=[96, 192, 384])
    ap.add_argument("--stamps", action="store_true",
                    help="with --wide: split its factorization and solve "
                         "launches at their phase comments")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ekf_tail_phases: needs a CUDA device", file=sys.stderr)
        return 1
    if args.wide:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        return wide_split(args.sizes, args.reps, smi, args.stamps)
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
