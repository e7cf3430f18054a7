#!/usr/bin/env python3
"""Where the time of K1 (csrc/propagate_block.cu), K4 (csrc/spd_solve.cu),
K8 (csrc/lk_level.cu), K6 (csrc/tile_gather.cu), K10 and K11 (csrc/clahe.cu's
clahe_luts_kernel and clahe_apply_kernel), K3 (csrc/jac_project.cu), K9
(csrc/subpix_refine.cu), K13 and K12 (csrc/shi_tomasi_nms.cu's strip
kernel, with and without its NMS stage) goes, phase by phase, on the card.

    python3 scripts/filter_kernel_phases.py
        [--kernel k1|k4|k8|k6|k10|k11|k3|k9|k13|k12|both|all]...
        [--k1-source FILE] [--k4-source FILE] [--k8-source FILE]
        [--k6-source FILE] [--k10-source FILE] [--k11-source FILE]
        [--k3-source FILE] [--k9-source FILE] [--k13-source FILE]
        [--k12-source FILE] [--frame N] [--reps 50]

Each ``--kN-source`` may be given more than once: every source is split on
the same inputs in the same call (an old design beside the new one).  For
each source it builds throwaway copies into the git-ignored
``rvio_tpu_torch/build/phases/``: the source as it is (with an empty
kernel beside it), one with a ``clock64()`` stamp at each ``// phase:
<name>`` comment of the kernel's body and at its end (a source holding two
kernels, clahe.cu or shi_tomasi_nms.cu, is stamped in the one split
only), and, where the design has one, a copy without its finish (K8).  A
stamp waits at a barrier (``__syncthreads()``, or ``__syncwarp()`` in a
kernel that has no block
barrier or whose source says ``// phase sync: __syncwarp()``), then the
thread that runs the stamped feature (block 0's first thread for K1, K4,
K10, K11, K13 and K12, K10's block 0 being the first CTA of tile 0's
cluster, the one that finishes, K13's and K12's the first warp's strip,
K11's the first block of the top-left cell; corner 0's lane 0 for
K9; block 0's first column lane, thread 32, for K3, whose
warp 0 leaves after the barrier; for K8 the slowest of the features with
the most trips, found by timing each) adds the cycles since the
previous stamp to the phase that was running; a phase inside a loop adds
up over its trips.  A phase that the stamped feature's block never reaches
(K8's finish runs in the block that draws the last ticket) reads 0: the
copy without the finish gives its device time instead.  K6 has no phases:
its time is set beside an empty kernel's, both CUDA graphs of 200
launches.

A source without phase comments is taken to be an earlier design whose
phase boundaries the script knows: for K1 and K4 the designs of commit
a8e45c3 (K1 one block of 576 threads, K4 one block of 256 threads a
feature), for K8 that of commit 243dc0e (one block of 256 threads a
feature, two block barriers a trip, a second one-block launch for the
finish), for K10 and K3 those of commit fe8cabf (K10 one block of 1024
threads a tile, K3 one block of 128 threads a feature with its system in
shared memory), for K9 and K13 those of commit 6d6ae45 (K9 one block of
256 threads a corner, a block reduction a step; K13 a block a 16 x 32
tile, four stages through shared memory), for K11 and K12 those of commit
3c8a136 (K11 a thread a pixel column of 8 rows, the whole LUT table
staged per block; K12 K13's old template without its NMS stage).  Save
it with its ``common.cuh`` beside it (``git show
fe8cabf:rvio_tpu_torch/csrc/clahe.cu``).

Inputs: the check cases of ``rvio_tpu_torch/ops/checks.py`` (K1 at B = 1,
K = 16 with 11 valid samples, K4 at F = 100, m = 30, K8 and K6 at 200
features of a 752 x 480 frame, K10 on its checker frame of 752 x 480 at
g = 5, K11 on the same kind of frame with its LUTs, K3 at F = 100, L =
15, M = 14, K9 at 200 corners, win 7, 10 iterations, K13 and K12 on a 752
x 480 frame), and with ``--frame N`` also K8's and K6's inputs at tracked
frame N of the CLAHE-on image path at each pyramid level, K10's and
K11's image there (K11 with that image's LUTs), K9's and K13's inputs of
that frame's refill detection and K13's image for K12
(``chip_smoke.capture_klt_frame``),
and K3's inputs at the feature path's frame N, captured from its plain
path on the CPU (``chip_smoke.capture_frame_inputs``).  It prints the card, each copy's error
against the plain version, the unstamped copy's device time (a CUDA graph
of 200 launches), the stamped copy's, whether the two copies' outputs are
bitwise equal (the script exits 1 if not, or if a copy fails its
check; such a copy is still timed and split), and each phase's mean cycles
over ``--reps`` launches, its share, and that share of the unstamped
device time; for K8 also the trip counts (T and the stamped feature's).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "rvio_tpu_torch" / "csrc"
MAX_PHASES = 32
CANDIDATES = 24     # K8: features timed to find the slowest

# Phase comments for the earlier designs: a comment line before each anchor.
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
    "k8": [("  for (int idx = tid; idx < TT; idx += NT) {\n    Tt[idx]",
            "load both tiles"),
           ("  // Scharr /32 of the template tile", "whole-tile Scharr"),
           ("  const int r = win / 2, area = win * win;\n  const bool tap",
            "template taps, 3-value block_sums"),
           ("  for (int it = 0; it < max_iters && alive && !conv; ++it) {",
            "Gauss-Newton trips"),
           ("  float e = 0.f;\n  if (last) {", "last-level error"),
           ("  if (tid == 0) {\n    g_out[2 * n] = px;", "store")],
    "k10": [("  const int area = th * tw;\n  for (int idx = tid;",
             "histogram loop"),
            ("  // clip; the excess summed", "clip and excess, two barriers"),
            ("  // the CDF in bin order", "one-thread CDF"),
            ("  if (tid < NBINS) {\n    const float v = __fmul_rn(cdf[tid]",
             "LUT store")],
    "k3": [("  if (tid < L) {                   // ---- measurement l",
            "measurement and chain-column setup"),
           ("  // ---- Hx blocks", "Hx fill"),
           ("  // ---- rank check on the rho column", "rank check, three "
            "reflections"),
           ("  // ---- masks, absolute clone columns, outputs", "masked store")],
    "k9": [("  for (int idx = tid; idx < TT; idx += NT) T[idx]",
            "tile load, tap setup"),
           ("    const float ly = fminf(fmaxf(cy - ofy",
            "patch samples, a division a sample"),
           ("    float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};", "tap products"),
           ("    rvio::block_sums<5, NT>(s, red);", "five block sums"),
           ("    const float gxx = s[0], gxy = s[1]", "the step"),
           ("  if (tid == 0) {\n    out[2 * n] = cx;", "store")],
    "k13": [("  for (int idx = tid; idx < (TY + 6) * (TX + 6);", "halo load"),
            ("  for (int idx = tid; idx < (TY + 4) * (TX + 4);",
             "gradient products"),
            ("  for (int idx = tid; idx < (TY + 2) * (TX + 2);", "response"),
            ("  for (int idx = tid; idx < TY * TX;", "NMS and store")],
    "k11": [("  const int n = g * g * NBINS;\n  for (int i = threadIdx.x;",
             "stage the whole LUT table, barrier"),
            ("  const int x = blockIdx.x * APPLY_COLS + threadIdx.x;",
             "a row at a time: load, bin, four shared reads, blend, store")],
    "k12": [("  for (int idx = tid; idx < (TY + 6) * (TX + 6);", "halo load"),
            ("  for (int idx = tid; idx < (TY + 4) * (TX + 4);",
             "gradient products"),
            ("  for (int idx = tid; idx < (TY + 2) * (TX + 2);",
             "response and store")],
}
# Where a kernel's body starts in a source that may hold another kernel:
# (anchor, True for an earlier design that carries no phase comments); the
# first anchor found wins.  Kernels not listed: the whole source.
KERNEL_START = {
    "k10": [("\nclahe_luts_kernel(const float*", False)],
    "k11": [("\nclahe_apply_kernel(const float*", False)],
    "k13": [("\nshi_strip_kernel(const float*", False),
            ("\nshi_nms_kernel(const float*", False),
            ("void shi_kernel(", True)],
    "k12": [("\nshi_strip_kernel(const float*", False),
            ("void shi_kernel(", True)],
}
# The stamped kernel ends where its body closes: before the next definition
# (of several, the first after the kernel's start).
STRIP_END = ("}\n\ntemplate <int ROWS, bool NMS>\nint launch_strips(",
             "}\n\n}  // namespace")
KERNEL_END = {"k1": "}\n\n}  // namespace", "k4": "}\n\n}  // namespace",
              "k8": "}\n\ntemplate <int KT>\nvoid launch(",
              "k8_old": "}\n\n__global__ void __launch_bounds__(NT)\n"
                        "lk_finish_kernel",
              "k10": "}\n\n// The two tiles along one axis",
              "k10_old": "}\n\n// The two tiles along one axis",
              "k3": "}\n\ntemplate <int LMAX>\nint launch(",
              "k3_old": "}\n\n}  // namespace",
              "k9": "}\n\n}  // namespace", "k13": STRIP_END,
              "k11": "}\n\n}  // namespace",
              "k11_old": "}\n\n}  // namespace",
              "k12": STRIP_END,
              "k12_old": "  if constexpr (!NMS) return;"}
# Which feature a thread stamps for (-1: none).
BLOCK0 = "(threadIdx.x == 0 && blockIdx.x == 0 ? 0 : -1)"
STAMPER = {"k1": BLOCK0, "k4": BLOCK0, "k10": BLOCK0, "k10_old": BLOCK0,
           "k3": "(threadIdx.x == 32 && blockIdx.x == 0 ? 0 : -1)",
           "k3_old": BLOCK0, "k9": BLOCK0, "k13": BLOCK0, "k11": BLOCK0,
           "k11_old": BLOCK0, "k12": BLOCK0, "k12_old": BLOCK0,
           "k8": "((threadIdx.x & 31) == 0 ? (int)(blockIdx.x * "
                 "(blockDim.x >> 5) + (threadIdx.x >> 5)) : -1)",
           "k8_old": "(threadIdx.x == 0 ? (int)blockIdx.x : -1)"}
# A stamp's wait where the source's own barrier cannot serve: K11's
# earlier design returns the threads past the image's width before its end.
SYNC = {"k11_old": "__syncwarp(__activemask())"}
# The finish, taken out of a copy: (what, pattern, replacement).
FINISH = {"k8": ("the last block's finish", r"  if \(!last_block\) return;",
                 "  return;"),
          "k8_old": ("the one-block lk_finish_kernel launch",
                     r"  lk_finish_kernel<<<[^;]*;\n", "")}
INCLUDE = '#include "common.cuh"\n'
IO = """
extern "C" int rvio_phase_io(long long* host, int n, int read) {
  return static_cast<int>(
      read ? cudaMemcpyFromSymbol(host, rvio_st, n * sizeof(long long))
           : cudaMemcpyToSymbol(rvio_st, host, n * sizeof(long long)));
}

extern "C" int rvio_phase_who(int who) {
  return static_cast<int>(cudaMemcpyToSymbol(rvio_who, &who, sizeof(int)));
}
"""
EMPTY = """
__global__ void rvio_empty_kernel() {}

extern "C" int rvio_phase_empty(int grid, int block, cudaStream_t stream) {
  rvio_empty_kernel<<<grid, block, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def add_old_markers(src: str, kernel: str) -> str:
    for anchor, name in OLD_DESIGN[kernel]:
        i = src.index(anchor)
        indent = len(anchor) - len(anchor.lstrip(" "))
        src = src[:i] + " " * indent + f"// phase: {name}\n" + src[i:]
    return src


def region(src: str, kernel: str, key: str):
    """(start, end, earlier design): the span of ``kernel``'s body in
    ``src``, from its KERNEL_START anchor (the start of the source if it has
    none) to the first KERNEL_END[key] after it."""
    start, old = 0, False
    for anchor, was in KERNEL_START.get(kernel, []):
        if anchor in src:
            start, old = src.index(anchor), was
            break
    else:
        if kernel in KERNEL_START:
            raise ValueError(f"no {kernel} kernel in the source")
    ends = KERNEL_END[key]
    if kernel not in KERNEL_START:
        return start, src.rindex(ends), old
    ends = (ends,) if isinstance(ends, str) else ends
    end = min(src.index(e, start) for e in ends if e in src[start:])
    return start, end, old


def instrument(src: str, span, stamper: str, sync=None):
    """(stamped source, phase names) for the ``// phase:`` comments inside
    ``span`` (start, end): a stamp at each and one before ``end``.  Phase k
    accumulates into rvio_st[k]."""
    lo, hi = span
    body = src[lo:hi]
    m = re.search(r"// phase sync: (\S+)\(\)", body)
    sync = sync or (m.group(1) + "()" if m else "__syncthreads()"
                    if "__syncthreads" in body else "__syncwarp()")

    def stamp(k):
        close = (f"if (rvio_ph >= 0) rvio_st[rvio_ph] += rvio_now - rvio_t; "
                 f"rvio_t = rvio_now;")
        return (f"{sync}; if ({stamper} == rvio_who) "
                f"{{ long long rvio_now = clock64(); {close} }}"
                + ("" if k is None else f" rvio_ph = {k};"))

    marks = [m for m in re.finditer(r"^( *)// phase: ([^\n]*)$", src,
                                    flags=re.M) if lo <= m.start() < hi]
    if not marks:
        raise ValueError("the kernel has no // phase: comments")
    names, out, pos = [], [], 0
    for k, m in enumerate(marks):
        decl = "long long rvio_t = 0; int rvio_ph = -1; " if k == 0 else ""
        out += [src[pos:m.start()], m.group(1) + decl + stamp(k) + "\n"]
        pos = m.start()
        names.append(m.group(2).strip())
    out += [src[pos:hi], "  " + stamp(None) + "\n", src[hi:]]
    src = "".join(out)
    i = src.index(INCLUDE) + len(INCLUDE)
    src = (src[:i] + f"\n__device__ long long rvio_st[{MAX_PHASES}];\n"
           "__device__ int rvio_who;\n" + src[i:] + IO)
    if len(names) > MAX_PHASES:
        raise ValueError("too many phases")
    return src, names


# --- each kernel's C call on a check case ------------------------------------

@dataclass
class Call:
    symbol: str
    argtypes: list
    ins: List[torch.Tensor]
    outs: List[torch.Tensor]
    extra: list                    # pointers after the outputs (a ticket;
    scalars: list                  # None: a null pointer)
    n_result: int                  # leading outputs the check compares

    def pointers(self):
        return [ctypes.c_void_p(None if t is None else t.data_ptr())
                for t in self.ins + self.outs + self.extra]


def _k1_call(chk, text):
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
    return Call("rvio_propagate_block", k1._ARGS,
                [w, a, dte, R0, vR, gR, bg, ba, P0], outs, [], scalars, 5)


def _k4_call(chk, text):
    from rvio_tpu_torch.ops import spd_solve as k4
    S, r = chk.args
    F, m = S.shape[0], S.shape[-1]
    D = torch.empty(F, device=S.device)
    if "rvio_spd_quadform_ws" in text:       # 31d6c2d, 8edaf6f: no route
        return Call("rvio_spd_quadform_ws", k4._ARGS[:-1], [S, r], [D],
                    [None], [F, m], 1)
    if "rvio_spd_quadform_route" not in text:   # 451d70c: no workspace
        return Call("rvio_spd_quadform",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2, [S, r], [D],
                    [], [F, m], 1)
    # no workspace: the split takes the instances up to m = 64
    return Call("rvio_spd_quadform_route", k4._ARGS, [S, r], [D], [None],
                [F, m, k4.ROUTES[k4.instance(m)]], 1)


def _k8_call(chk, text):
    from rvio_tpu_torch.ops import klt_iterate as k8
    t_tiles, n_tiles, loc0, g_init, o1, status = chk.args
    kw = chk.kwargs
    N, TH, TW = t_tiles.shape
    dev = t_tiles.device

    def flags():
        return torch.empty(N, dtype=torch.bool, device=dev)

    outs = [torch.empty((N, 2), device=dev), flags(),
            torch.empty(N, device=dev),
            torch.empty(N, dtype=torch.int32, device=dev)]
    if "lk_finish_kernel" in text:        # 243dc0e: trips, alive, dok
        outs += [flags(), flags()]
        extra = []
        argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                    + [ctypes.c_float] * 3 + [ctypes.c_int] * 3)
    else:                                 # scratch, then the ticket
        extra = [torch.zeros(1, dtype=torch.int32, device=dev)]
        argtypes = k8._LK_ARGS
    H, W = kw["hw"]
    scalars = [N, TH, TW, kw["win"], kw["max_iters"], kw["eps"],
               kw["min_eig"], kw["wander"], int(kw["last"]), H, W]
    return Call("rvio_lk_level", argtypes,
                [t_tiles, n_tiles, loc0, g_init, o1, status], outs, extra,
                scalars, 3)


def _k6_call(chk, text):
    from rvio_tpu_torch.ops import tile_gather as k6
    img, o, th, tw = chk.args
    H, W = img.shape
    N = o.shape[0]
    out = torch.empty((N, th, tw), device=img.device)
    return Call("rvio_gather_tiles", k6._ARGS, [img, o], [out], [],
                [H, W, N, th, tw], 1)


def _k10_call(chk, text):
    from rvio_tpu_torch.ops import clahe as k10
    img, = chk.args
    g, clip = chk.kwargs["grid"], chk.kwargs["clip_limit"]
    H, W = img.shape
    th, tw = k10.tile_shape(H, W, g)
    limit = k10.clip_limit_count(clip, th * tw)
    luts = torch.empty((g * g, k10.KERNEL_BINS), device=img.device)
    scalars = [H, W, g, limit, (k10.KERNEL_BINS - 1.0) / (th * tw)]
    argtypes = k10._ARGS
    if "any_order" in text:               # since fe8cabf: the CDF's branch
        scalars.append(int(k10.cdf_any_order(limit, th * tw)))
        argtypes = k10._LUT_ARGS
    # the tracker's call: the LUTs alone (a null histogram pointer)
    return Call("rvio_clahe_luts", argtypes, [img], [luts], [None], scalars,
                1)


def _k3_call(chk, text):
    from rvio_tpu_torch.ops import jac_project as k3
    *arrays, M = chk.args
    if "long long* teff" not in text:     # fe8cabf's design: int32
        arrays[10:12] = [x.to(torch.int32) for x in arrays[10:12]]
    F, L = arrays[0].shape[:2]
    dev = arrays[0].device
    outs = [torch.empty((F, 2 * L), device=dev),
            torch.empty((F, 2 * L, 6 * M), device=dev),
            torch.empty(F, device=dev)]
    if "rvio_jac_project_route" not in text:   # before the wide kernel
        return Call("rvio_jac_project", k3._ARGS[:-1], arrays, outs, [],
                    [F, L, M, k3.KERNEL_EPS], 3)
    return Call("rvio_jac_project_route", k3._ARGS, arrays, outs, [],
                [F, L, M, k3.KERNEL_EPS, k3.ROUTES[k3.kernel_route(L)]], 3)


def _k9_call(chk, text):
    from rvio_tpu_torch.ops import klt_iterate as k9
    tiles, origin, pts = chk.args
    N, TH, TW = tiles.shape
    out = torch.empty((N, 2), device=tiles.device)
    return Call("rvio_subpix_refine", k9._SP_ARGS, [tiles, origin, pts],
                [out], [], [N, TH, TW, chk.kwargs["win"],
                            chk.kwargs["iters"]], 1)


def _k13_call(chk, text):
    from rvio_tpu_torch.ops import shi_tomasi as k13
    img, = chk.args
    return Call("rvio_shi_tomasi_nms", k13._ARGS, [img],
                [torch.empty_like(img)], [], list(img.shape), 1)


def _k11_call(chk, text):
    from rvio_tpu_torch.ops import clahe as k11
    img, luts = chk.args
    g = chk.kwargs["grid"]
    H, W = img.shape
    th, tw = k11.tile_shape(H, W, g)
    return Call("rvio_clahe_apply", k11._ARGS, [img, luts],
                [torch.empty_like(img)], [],
                [H, W, g, (th - 1) / 2.0, (tw - 1) / 2.0], 1)


def _k12_call(chk, text):
    from rvio_tpu_torch.ops import shi_tomasi as k12
    img, = chk.args
    return Call("rvio_shi_tomasi", k12._ARGS, [img],
                [torch.empty_like(img)], [], list(img.shape), 1)


@dataclass
class Kernel:
    lib: str
    check: str                     # its name in checks.kernel_checks
    call: Callable
    stamps: bool = True


KERNELS = {"k1": Kernel("propagate_block", "propagate_block", _k1_call),
           "k4": Kernel("spd_solve", "batched_quadform", _k4_call),
           "k8": Kernel("lk_level", "lk_level", _k8_call),
           "k6": Kernel("tile_gather", "gather_tiles", _k6_call,
                        stamps=False),
           "k10": Kernel("clahe", "clahe_luts", _k10_call),
           "k3": Kernel("jac_project", "jac_project", _k3_call),
           "k9": Kernel("subpix_refine", "subpix_refine", _k9_call),
           "k13": Kernel("shi_tomasi_nms", "shi_tomasi_nms", _k13_call),
           "k11": Kernel("clahe", "clahe_apply", _k11_call),
           "k12": Kernel("shi_tomasi_nms", "shi_tomasi", _k12_call)}


def bitwise_equal(xs, ys) -> bool:
    return all(torch.equal(*(t.view(torch.int32) if t.is_floating_point()
                             else t for t in (x, y)))
               for x, y in zip(xs, ys))


class Build:
    """The copies of one source: unstamped (with the empty kernel),
    stamped, and without its finish, built and loaded."""

    def __init__(self, kernel: str, source: Path, tag: str):
        spec = KERNELS[kernel]
        text = source.read_text()
        self.design = "its phase comments"
        key = kernel
        if spec.stamps:
            lo, hi, old = region(text, kernel, key)
            if old or "// phase:" not in text[lo:hi]:
                text = add_old_markers(text, kernel)
                self.design = "the phase boundaries of an earlier design"
                if kernel + "_old" in KERNEL_END:
                    key = kernel + "_old"
        self.text, self.kernel, self.source = text, kernel, source
        codes = {"unstamped": text + EMPTY}
        self.names = []
        if spec.stamps:
            lo, hi, _ = region(text, kernel, key)
            codes["stamped"], self.names = instrument(
                text, (lo, hi), STAMPER[key], SYNC.get(key))
        self.finish = FINISH.get(key)
        if self.finish:
            codes["no finish"] = re.sub(self.finish[1], self.finish[2], text,
                                        count=1)
        from rvio_tpu_torch.ops import _lib
        out = _lib.BUILD / "phases"
        out.mkdir(parents=True, exist_ok=True)
        (out / _lib.HEADER).write_text((source.parent / _lib.HEADER)
                                       .read_text())
        procs = {}
        for name, code in codes.items():
            stem = f"{spec.lib}_{tag}_{name.replace(' ', '_')}"
            cu = out / f"{stem}.cu"
            cu.write_text(code)
            so = out / f"lib{stem}.so"
            procs[name] = (so, subprocess.Popen(
                [_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        self.handles = {}
        for name, (so, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for the {name} copy of "
                                   f"{source}:\n{log}")
            regs = [ln.strip() for ln in log.splitlines() if "Used" in ln
                    or re.search(r"[1-9]\d* bytes spill", ln)]
            print(f"  {source} {name} copy: {'; '.join(regs)}", flush=True)
            self.handles[name] = ctypes.CDLL(str(so))

    def fn(self, copy: str, call: Call):
        fn = getattr(self.handles[copy], call.symbol)
        fn.argtypes = list(call.argtypes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn


def _launcher(fn, call: Call):
    def run():
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*call.pointers(), *call.scalars, ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(f"launch failed ({err})")
    return run


def split(build: Build, label: str, chk, reps: int) -> bool:
    """One source's split on one check case; True when the stamped copy's
    outputs are bitwise the unstamped copy's (or there is no stamped
    copy)."""
    from chip_smoke import device_ms
    spec = KERNELS[build.kernel]
    calls = {copy: spec.call(chk, build.text) for copy in build.handles}
    runs = {copy: _launcher(build.fn(copy, calls[copy]), calls[copy])
            for copy in build.handles}
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    result = calls["unstamped"].outs[:calls["unstamped"].n_result]
    try:
        err = chk.compare(result if len(result) > 1 else result[0],
                          chk.run_plain())
        fails = ""
    except AssertionError as e:       # reported and timed; the rest go on
        err, fails = float("nan"), f"; FAILS its check: {e}"
    times = {copy: device_ms(run, 200) for copy, run in runs.items()}
    empty = build.handles["unstamped"].rvio_phase_empty
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    empty.restype = ctypes.c_int

    def empty_run(grid, block):
        def run():
            if empty(grid, block,
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)):
                raise RuntimeError("the empty kernel failed")
        return run

    n = len(calls["unstamped"].ins[1]) if build.kernel == "k6" else 1
    t_empty = {(1, 32): device_ms(empty_run(1, 32), 200),
               (n, 256): device_ms(empty_run(n, 256), 200)}
    t_copy = times["unstamped"]
    line = (f"{chk.name}{label}, source {build.source} ({build.design}): "
            f"{t_copy * 1e3:.2f} us a launch on the device (error against "
            f"the plain version {err:.3e}; {chk.tolerance}); an empty kernel "
            + ", ".join(f"<<<{g}, {b}>>> {t * 1e3:.2f} us"
                        for (g, b), t in t_empty.items()))
    if build.finish:
        line += (f"; without {build.finish[0]} "
                 f"{times['no finish'] * 1e3:.2f} us (the finish: "
                 f"{(t_copy - times['no finish']) * 1e3:.2f} us)")
    trips = getattr(chk, "trips", None)
    line += fails
    if "stamped" not in runs:
        print(line, flush=True)
        return not fails
    same = bitwise_equal(calls["unstamped"].outs, calls["stamped"].outs)
    line += (f"; stamped copy {times['stamped'] * 1e3:.2f} us (outputs "
             f"{'bitwise the unstamped copy' if same else 'DIFFER'})")
    io = build.handles["stamped"].rvio_phase_io
    io.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    io.restype = ctypes.c_int
    set_who = build.handles["stamped"].rvio_phase_who
    set_who.argtypes = [ctypes.c_int]
    set_who.restype = ctypes.c_int

    def stamps(who, n):
        """Mean cycles of each phase over n launches, feature ``who``."""
        if set_who(who):
            raise RuntimeError("choosing the stamped feature failed")
        zero = np.zeros(MAX_PHASES, np.int64)
        acc = np.zeros(MAX_PHASES)
        buf = np.zeros(MAX_PHASES, np.int64)
        for _ in range(n):
            torch.cuda.synchronize()
            if io(zero.ctypes.data, MAX_PHASES, 0):
                raise RuntimeError("resetting the stamps failed")
            runs["stamped"]()
            torch.cuda.synchronize()
            if io(buf.ctypes.data, MAX_PHASES, 1):
                raise RuntimeError("reading the stamps failed")
            acc += buf
        return acc[:len(build.names)] / n

    who = 0
    if trips is not None:
        # the slowest of the features with the most trips, by their cycles
        # up to the last block's finish (which only that block runs)
        T = int(trips.max(initial=0))
        cands = np.flatnonzero(trips >= max(T - 1, 0))[:CANDIDATES]
        upto = [i for i, nm in enumerate(build.names)
                if not nm.startswith("finish")]
        own = {int(c): stamps(int(c), max(reps // 10, 3))[upto].sum()
               for c in cands}
        who = max(own, key=own.get)
        line += (f"; T {T}, stamped the slowest of {len(cands)} features "
                 f"with T - 1 trips or more: {who} ({int(trips[who])} trips; "
                 f"the others {min(own.values()):.0f}-"
                 f"{max(own.values()):.0f} cycles before the finish)")
    cyc = stamps(who, reps)
    total = cyc.sum()
    print(f"{line}; {total:.0f} cycles between the first and the last stamp",
          flush=True)
    for name, c in zip(build.names, cyc):
        extra = ""
        if trips is not None and "trips" in name and trips[who]:
            extra = f"  ({c / trips[who]:.0f} cycles a trip)"
        print(f"  {name:36s} {c:9.0f} cycles {100 * c / max(total, 1):5.1f} "
              f"%  {c / max(total, 1) * t_copy * 1e3:8.2f} us of the "
              f"unstamped time{extra}")
    return same and not fails


_CAPTURED: dict = {}


def feature_frame_case(dev, frame: int):
    """K3's case at the feature path's frame ``frame`` (the ``frame``-th
    filtered frame), captured from its plain path on the CPU."""
    from chip_smoke import _init_frame, capture_frame_inputs, workload_sim
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.ops.checks import jac_case
    from rvio_tpu_torch.runtime import batches_from_sim
    cfg, sim = RVIOConfig(), workload_sim()
    k_end = _init_frame(cfg, sim.imu_t, sim.imu_w, sim.imu_a,
                        sim.frame_t) + frame
    res, _, _, inputs = capture_frame_inputs(
        cfg, (sim.imu_t, sim.imu_w, sim.imu_a), sim.frame_t[:k_end],
        batches_from_sim(sim)[:k_end])
    if len(res.timestamps) != frame:
        raise AssertionError(f"the feature path filtered "
                             f"{len(res.timestamps)} frames, not {frame}")
    t_eff = inputs[10]
    what = (f" (the feature path's frame {frame}: t_eff sum "
            f"{int(t_eff.sum())} over {int((t_eff >= 2).sum())} features)")
    return [(what, jac_case(dev, inputs, what=what))]


def frame_cases(dev, kernel: str, frame: int) -> List[Tuple[str, object]]:
    """K8's, K6's, K10's, K11's, K9's, K13's or K12's cases at tracked frame
    ``frame`` of the CLAHE-on image path, one a pyramid level (K6: its
    template and its search gather; K10 and K11: the frame's image, K11
    with its LUTs; K9 and K13: the refill detection's calls; K12: K13's
    image); K3's at the feature path's frame."""
    from chip_smoke import capture_klt_frame, workload_sim
    from rvio_tpu_torch.ops.checks import (clahe_apply_case,
                                           clahe_luts_case, lk_case,
                                           shi_case, shi_nms_case,
                                           subpix_case, tile_case)
    from rvio_tpu_torch.ops.clahe import clahe_luts_plain
    if kernel == "k3":
        return feature_frame_case(dev, frame)
    if frame not in _CAPTURED:
        _CAPTURED[frame] = capture_klt_frame(dev, workload_sim(), frame=frame)
    levels, eq_img, subpix, nms_img = _CAPTURED[frame]
    if kernel == "k10":
        what = f" (frame {frame}'s image)"
        return [(what, clahe_luts_case(dev, eq_img, what=what))]
    if kernel == "k9":
        what = f" (frame {frame}'s refill, {len(subpix[0][2])} corners)"
        return [(what, subpix_case(dev, *subpix[0], **subpix[1], what=what))]
    if kernel == "k11":
        what = f" (frame {frame}'s image)"
        img = eq_img.cpu()
        return [(what, clahe_apply_case(dev, img, clahe_luts_plain(img), 5,
                                        what=what))]
    if kernel in ("k13", "k12"):
        what = f" (frame {frame}'s level 0)"
        case = shi_nms_case if kernel == "k13" else shi_case
        return [(what, case(dev, nms_img, what=what))]
    out = []
    for lvl, tmpl, search, args, kw in levels:
        what = f" (frame {frame}, level {lvl})"
        if kernel == "k8":
            out.append((what, lk_case(dev, args, kw, what=what)))
        else:
            out += [(what[:-1] + f", {which} tiles)",
                     tile_case(dev, img, o, what=what))
                    for which, (img, o) in (("template", tmpl),
                                            ("search", search))]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("k1", "k4", "k8", "k6", "k10",
                                         "k11", "k3", "k9", "k13", "k12",
                                         "both", "all"),
                    action="append",
                    help="may repeat; both (the default): k1 and k4; all: "
                         "every kernel")
    for k, name in (("k1", "propagate_block"), ("k4", "spd_solve"),
                    ("k8", "lk_level"), ("k6", "tile_gather"),
                    ("k10", "clahe"), ("k11", "clahe"),
                    ("k3", "jac_project"), ("k9", "subpix_refine"),
                    ("k13", "shi_tomasi_nms"), ("k12", "shi_tomasi_nms")):
        ap.add_argument(f"--{k}-source", action="append", default=None,
                        help=f"default csrc/{name}.cu; may repeat")
    ap.add_argument("--frame", type=int, default=None,
                    help="K8, K6, K10, K11, K9, K13 and K12 also on this "
                         "tracked frame's inputs, K3 on this filtered "
                         "frame's")
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
    dev = torch.device("cuda", 0)
    checks = {c.name: c for c in kernel_checks(dev)}
    groups = {"both": ("k1", "k4"),
              "all": ("k1", "k4", "k8", "k6", "k10", "k11", "k3", "k9",
                      "k13", "k12")}
    kernels = [k for arg in args.kernel or ["both"]
               for k in groups.get(arg, (arg,))]
    ok = True
    for kernel in kernels:
        spec = KERNELS[kernel]
        sources = getattr(args, f"{kernel}_source") or [
            str(CSRC / f"{spec.lib}.cu")]
        builds = [Build(kernel, Path(s), f"s{i}")
                  for i, s in enumerate(sources)]
        cases: List[Tuple[str, Optional[object]]] = [("", checks[spec.check])]
        if args.frame is not None and kernel != "k1" and kernel != "k4":
            cases += frame_cases(dev, kernel, args.frame)
        for label, chk in cases:
            for build in builds:
                ok &= split(build, label, chk, args.reps)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
