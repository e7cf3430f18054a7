#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rvio_tpu_torch) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``rvio_tpu_torch/csrc`` (one nvcc
per source, all at once), holds each kernel against its plain PyTorch
version at its main path's operating point and times both (and, where one
PyTorch call computes the same function, that call, eager and on the
device), then drives the
port's paths over the 60 s synthetic workload of bench.py at the EuRoC
operating point of ``RVIOConfig()`` (200 feature slots, 15-frame tracks,
14 clones, 20 Hz camera, 200 Hz IMU, f32), each with every launch count
set to 0 just before it and read just after:

- the feature-level filter, ``SequenceDriver`` on the simulator's tracks:
  every filter kernel (K5 included) runs once per filtered frame, ATE
  below 0.05 m, and the first 100 frames agree with the port's plain path
  on the CPU, whose 100th frame gives the inputs of K1's, K3's and K5's
  checks on a real frame (and K5 a seeded case that takes the wider
  ridge, and the seeded stack of scripts/joseph_order.py at n = 84,
  row ``ekf_tail@stack84``, also against the chain's order in f64);
- the same with the unfused library chain called in K5's place (a
  yardstick the port never runs on the card): the first 100 frames within
  the card-vs-CPU limits of the K5 run, and the back-end time of the two
  in turns;
- the workload written as a EuRoC ASL folder (rendered u8 frames as PNG,
  IMU and ground truth as CSV); the image paths below run on its
  timestamps;
- images -> poses, ``run_rendered_sequence_scan`` on rendered 752 x 480
  frames, with the equalizer off over the first 150 frames and with
  ``RVIOConfig()`` unmodified (CLAHE on) over the whole workload: every
  kernel launches as often as the path implies, ATE below 0.05 m, the
  front-end acceptance gates of tests/test_flagship_image_ate.py hold, and
  the first 50 frames agree with the CPU plain path;
- K8 and K6 on the tracker's inputs at tracked frame 100 of the CLAHE-on
  path (captured on the card), at each of the four pyramid levels: each
  against its plain version, with T (the largest trip count) and the
  device time; K10 on the same frame's image, LUTs bitwise with the CPU
  plain version, and K11 on that image with its LUTs, pixels bitwise with
  the CPU plain version; K9 and K13 on the same frame's refill detection (its
  corners and tiles, and its level-0 image), each against its plain
  version, with the device time; then images -> poses at a 21 x 21 LK
  window over 20 tracked frames through the graphed chunk scan (every
  kernel as the path implies, ATE below 0.05 m, within the image path's
  card-vs-CPU limits of the CPU plain path) and K8 on its last frame's
  inputs at every level (row ``lk_level@win21``); and at a 33 x 33 window,
  past the tile's room, where every feature is lost on its first trip,
  over 6 tracked frames against the CPU plain path, with K8's instance
  without trips on its last frame's inputs (row ``lk_level@win33``);
- the public entries that no path reaches, the detector's
  ``shi_tomasi_response`` (K12) and ``gather_tiles_aligned`` (K7), on the
  workload's frames and the tracker's live positions, each against its
  plain version;
- the live entry point, ``OnlineDriver``, fed frame by frame over the
  first 200 tracked frames: frames/s, push-to-pose latency, no drops, and
  the poses of the CLAHE-on run above (same seed, so the same draws);
- graph against eager (the one-dispatch frame): the feature path over the
  workload's first 200 frames through the eager frame loop and through the graphed
  sequence scan with 1, 8 and 32 frames a graph (capture seconds, reserved
  growth bytes, frames/s), every output of every frame bitwise or within
  1e-6 m; images -> poses with CLAHE on over the first GRAPH_IMG_FRAMES
  frames eagerly, then graphed through the fused chunk scan, the
  front-end and back-end chunk scans, and ``ImagePipeline``, each against
  the eager run; every kernel's launches under replay as the path implies;
- the file replay: ``python -m rvio_tpu_torch.run
  --euroc`` on the folder (in process): every kernel of the image path and
  K5 as often as the path implies, ATE below 0.05 m, the acceptance gates,
  the two .dat files one line a frame; then the replay against the
  rendered scan (300 frames, the same bytes), a bag of the first 200
  frames against the folder, and a run saved after 100 of them and
  resumed against the uninterrupted run;
- the segment-batched filter, this slice's main path:
  ``make_batched_sequence_scan`` over 16 copies of the feature workload
  (frames/s, ms a batched frame, capture seconds and reserved growth bytes),
  every filter kernel once a batched frame, every row bitwise the same,
  row 0 within the card-vs-CPU limits of the graphed single scan; K1-K5
  on frame 100 of 16 distinct segments of the workload (segment_plan,
  warm starts), each against its plain version with its own bound (rows
  ``<kernel>@B16`` of the kernels line), K5 also at B = 1, 4, 8, 15 and
  its clusters' residency; then ``run_segments_warm`` on the card in f32
  on tests/test_handoff.py's 300 s split with that test's gates, and the
  same split with its last segment's body stripped of features, which
  the repair pass (a B = 1 scan, a capture of its own) re-runs;
- the set replay, the segment-batched image pipeline: four synthetic
  sequences at ``RVIOConfig()`` (their own seeds and lengths, rendered
  once and held in memory) through ``run_sequence_set`` (each frame of
  the set one replay of the batched image frame) and each through its
  single replay with the same seed: frames/s of both, each ATE below
  0.05 m, every kernel once a batched frame (and once for each
  sequence's init frame), each sequence within the image path's
  card-vs-CPU limits of its single replay; one sequence four times,
  every row bitwise the same; then K6, K8, K9 (B·N rows), K10, K11 and
  K13 at B = 4 on tracked frame 100 of the four sequences, each against
  its plain version segment by segment (K8 at every level, bitwise
  against a single launch a segment), rows ``<kernel>@B4`` of the
  kernels line;
- the multi-device layer (rvio_tpu_torch/parallel): a (1, 1) NCCL mesh in
  this process, ``make_parallel_sequence`` over the batched filter's 16
  copies bitwise the batched scan (no collective of the port runs on a
  (1, 1) mesh: both axes have size 1), and a probe, one NCCL
  ``all_reduce`` of a frame's feat buffer at world size 1; then two
  ranks on the card over
  gloo (scripts/torch_multiprocess_check.py): the workload's four
  quarters with seg = 2 and with feat = 2 against the unsharded batched
  scan (the feat ranks' states bitwise equal, one ``all_reduce`` a frame,
  K2-K4 once a frame on each rank), ``run_segments_warm(mesh=)`` with
  seg = 2 against the warm split above, and the feat-split KLT through
  ``make_image_chunk_scan(mesh=)`` on a 32-frame chunk against the
  unsharded scan, each with its frames/s beside one rank's; K2-K4, K6 and
  K8 on a rank's rows, rows ``<kernel>@feat2`` of the kernels line;
- the QR compression in graphed frames: the feature workload with
  ``tpu.compression = "qr"`` through the graphed sequence scan (ATE, K5
  never launched, a QR frame's time against a Cholesky frame's in turns)
  and the graphed batched scan of 4 copies, each against the same frames
  run eagerly; windows of 16, 19, 32 and 64 clones (max_tracking_length
  17, 20, 33, 65: K5 past its narrow kernel's n = 92, K4's wide
  instance at 33 and 65, K3's wide kernel at every length) through the
  graphed sequence scan, every filter kernel (K5's wide route included)
  once a frame, against the CPU over 100 frames (n_good above 4; at 65,
  where the workload offers fewer usable features, above 0.9 of the CPU
  run's), and K3-K5 on each length's last update against their plain
  versions (rows ``<kernel>@wide<L>``; before a K3 or K4 row whose other
  kernel takes the length, a line with that kernel's time on the same
  inputs; at 33 the K4 seam: seeded systems at m = 64 through both
  instances beside the m = 66 row's, and the wide instance on dense
  seeded systems with an indefinite lane at m = 130, 240 (S packed) and
  340 (S in the workspace); K5 also on four updates at once at
  33, and on scripts/joseph_order.py's seeded stack at n = 96, row
  ``ekf_tail@stack96``, also against the chain's order in f64); a
  one-seed
  ``run_synthetic_sweep`` (15 s) on the card and on the CPU (the same frames,
  each ATE below 0.05 m) and ``python -m rvio_tpu_torch.run --sweep 1``,
  which prints the table;
- bench.py's high-rate stress config (BASELINE.json's fourth: 800 slots,
  400 update lanes, five pyramid levels down to 30 x 47): images -> poses
  over 110 tracked frames (launches, ATE, the acceptance gates), then
  K2-K4, K6 and K8 at each level, K9 and K13 on tracked frame 100's
  inputs at those shapes against their plain versions, rows
  ``<kernel>@stress`` of the kernels line.

The public drivers run their frames as replays of captured CUDA graphs
(rvio_tpu_torch/runtime/graph.py), so the phases that drive them measure
the graphed path; the eager frame loop (runtime/graph.py
``EagerFrameScan``) is the
reference of the graph-against-eager phase and drives the KLT frame
capture, whose recorders see each frame's calls.

Output, in order: a device line, the build, one line per kernel check, the
main-path lines, the script's time, the card's name and power limit as
nvidia-smi reports them, a JSON object describing every kernel, and as
the last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero without that line; with no CUDA device it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): the roofline bound of each kernel
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

ATE_LIMIT_M = 0.05
CPU_FRAMES = 100
# kernel path (card) vs plain path (CPU), both f32 with the same depth
# guard: two summation orders of the same arithmetic.  An H100 run read
# 2.6e-6 m and 1.2e-7 rad over these frames; the limits are about 40x and
# 80x that, so a fault at the main path's call sites shows.
CPU_GAP_POS_M = 1e-4
CPU_GAP_ROT_RAD = 1e-5
# images -> poses: card kernel path vs CPU plain path over the first frames
# (both f32, the same RANSAC draws).  An H100 run read 1.55e-6 m and every
# slot-frame agreeing; the position limit is about 30x that reading.
IMG_CPU_FRAMES = 50
IMG_CPU_ACTIVE_AGREE = 0.99
IMG_CPU_GAP_POS_M = 5e-5
# the equalizer-off image path runs this many frames after its init frame
IMG_OFF_FRAMES = 150
# the live path: tracked frames fed to OnlineDriver, and the largest
# position gap allowed to the CLAHE-on scan with the same draws.  An H100
# run read 0 (the same kernels and arithmetic in the same order); the limit
# is a few float32 ulps of a position at the trajectory's scale (meters),
# so any change of the computation shows.
ONLINE_FRAMES = 200
ONLINE_GAP_M = 1e-6
# K5 against its plain version on the captured frame: the tolerance of
# tests/test_ops.py::TestEkfTailKernel (2e-5 of the largest entry); H100
# runs read 4.6e-7 to 6.5e-7
EKF_TAIL_FRAME_TOL = 2e-5
# the feature path with K5 and with the library chain in its place, timed
# in turns: pairs of runs over the first frames
TIMING_FRAMES = 300
TIMING_PAIRS = 2
# the file replay: the workload's timestamps in the ASL folder are
# T0_NS + t ns (a start at 100 s keeps a float64 second exact to 1.4e-14 s,
# so a bag's sec/nsec stamps and the CSV's ns give the same dt in f32);
# threads that render and encode the folder's frames
T0_NS = 100_000_000_000
WRITE_THREADS = 6
# the replay (flag off) against the rendered scan over these frames, the
# bag and the resumed run against the folder over BAG_FRAMES, each saved
# and resumed half-way.  The same frames (PNG is lossless), IMU and draws
# in the same order on one card: 0 expected; the limit is a few float32
# ulps of a position in meters, as for the live path
REPLAY_SCAN_FRAMES = 300
BAG_FRAMES = 200
REPLAY_GAP_M = 1e-6
# K8 and K6 on a real frame: the tracker's calls at this tracked frame of
# the CLAHE-on image path
KLT_FRAME = 100
# graph against eager: frames of images -> poses (CLAHE on) compared, and
# the frames a graph of the sequence scan holds
GRAPH_IMG_FRAMES = 100
UNROLLS = (1, 8, 32)
# ... and the feature path's frames there (its first 200: the eager runs
# of the whole workload took 49 s of the script's time on an H100)
GRAPH_FEATURE_FRAMES = 200
# graphed against eager: the same kernels in the same order, so 0 is
# expected; the limit is PERF.md section 2's same-input limit
GRAPH_GAP_M = 1e-6
# front-end acceptance gates of tests/test_flagship_image_ate.py:49-53
ACCEPT_GATES = {"ransac_inlier_rate": (">", 0.80),
                "gate_reject_rate": ("<", 0.50),
                "track_len_mean": (">", 4.0)}
N_USABLE_MIN = 10.0
# the segment-batched filter: BATCH copies of the feature workload through
# make_batched_sequence_scan (bench.py's batched_fps).  Row 0 against the
# graphed single scan: two summation orders of one function (the batched
# scan composes the window chain sequentially, the single scan in its
# parallel form, and the batch changes the library calls' shapes), held to
# the card-vs-CPU limits of PERF.md section 2
BATCH = 16
BATCH_GAP_POS_M = CPU_GAP_POS_M
BATCH_GAP_ROT_RAD = CPU_GAP_ROT_RAD
# the filter kernels' batch checks take the inputs of this frame of BATCH
# distinct segments of the workload (segment_plan with this warm-up)
BATCH_FRAME = 100
BATCH_WARMUP = 40
# K5's device time at these batch sizes (one cluster of 8 CTAs a system;
# the card holds 15 such clusters at once: 15 is one wave, 16 two)
K5_BATCHES = (1, 4, 8, 15, 16)
# the warm split: tests/test_handoff.py TestWarmHandoff's case (small
# config, 300 s, seed 5, 8 segments, warm-up 150) and its gates, in f32
WARM_DURATION_S, WARM_SEED, WARM_SEGMENTS, WARM_WARMUP = 300.0, 5, 8, 150
WARM_ATE_MARGIN_M = 0.05
WARM_MAX_DEV_M = 0.6
WARM_NGOOD_MIN = 3.0
# the set replay: four synthetic sequences at RVIOConfig() (standing for
# the four V1/V2 easy+medium sequences of BASELINE.json's set), each its
# own seed and length (about 135-170 tracked frames at 20 Hz), rendered
# once and held in memory; each sequence against its single replay with
# the same seed within the image path's card-vs-CPU limits (the same
# function in other library shapes: the batch changes the filter's and
# the RANSAC's batched products)
SET_SEEDS = (31, 32, 33, 34)
SET_DURATIONS_S = (9.0, 9.5, 10.0, 10.5)
SET_GAP_POS_M = IMG_CPU_GAP_POS_M
SET_ACTIVE_AGREE = IMG_CPU_ACTIVE_AGREE
# the image kernels at the batched tracker's shapes: tracked frame
# KLT_FRAME of the set's sequences, one segment each
SET_B = len(SET_SEEDS)
# the mesh layer (rvio_tpu_torch/parallel): the feature workload's
# MESH_SEGMENTS quarters (each started from the unsplit scan's state at its
# first frame) in two ranks on the one card over gloo
# (scripts/torch_multiprocess_check.py), seg = 2 against the unsharded
# batched scan (bitwise expected: each rank's frame is the batched body at
# B = 2; held to the card-vs-CPU limits and equal n_good) and feat = 2
# against it within the card-vs-CPU limits (the sums of two halves,
# another summation order); the warm split with seg = 2 against mesh=None
# within the same position limit, with its gates and the same repairs;
# the feat-split KLT through make_image_chunk_scan(mesh=) on one
# MESH_KLT_FRAMES-frame chunk at RVIOConfig() against the unsharded scan:
# pos, hist and active equal (this chunk's data, on which K8's T rule, a
# rank's T its own lanes' largest trip count, parts nothing), every pose
# within the image path's card-vs-CPU limit
MESH_SEGMENTS = 4
MESH_GAP_POS_M = CPU_GAP_POS_M
MESH_GAP_ROT_RAD = CPU_GAP_ROT_RAD
MESH_KLT_FRAMES = 32
MESH_KLT_GAP_M = IMG_CPU_GAP_POS_M
MESH_TIMEOUT_S = 420
MESH_KERNELS = ("lm_triangulate", "jac_project", "batched_quadform",
                "gather_tiles", "lk_level")
# QR compression in graphed frames (ROADMAP.md section 3): the feature
# workload with tpu.compression = "qr" through the graphed sequence scan
# (all of it: ATE) and the graphed batched scan (QR_B copies of its first
# QR_FRAMES frames), each against the same frames run eagerly (the same
# kernels and calls in the same order: 0 expected; held to the card-vs-CPU
# limits, the issue's gate)
QR_FRAMES = 150
QR_B = 4
# the sweep's sequence on the card and the CPU (the CLI's run keeps its
# default, 30 s)
SWEEP_DURATION_S = 15.0
# windows past the narrow filter kernels (K5's narrow kernel takes n = 6 x
# clones <= 92, K4's warps m = 2L < 64, K3's narrow kernel L <= 16): the
# graphed sequence scan at these tracker.max_tracking_length over
# WIDE_FRAMES frames on the card and on the CPU, within the card-vs-CPU
# limits (the window of 64 clones fills at frame 64), and K3-K5 on each
# length's last frame with accepted features (rows <kernel>@wide<L>), K5
# also on WIDE_B of the run's last such frames at once at WIDE_B_LENGTH
WIDE_LENGTHS = (17, 20, 33, 65)
WIDE_FRAMES = 100
WIDE_DURATION_S = 10.0
WIDE_B = 4
WIDE_B_LENGTH = 33
# K4's wide instance on dense seeded systems beside WIDE_B_LENGTH's seam
# lines: the main path's m = 130 (window 65), 240 (S packed in shared
# memory on the H100) and 340 (S in the workspace), at F = 100
QUADFORM_DENSE_ORDERS = (130, 240, 340)
QUADFORM_DENSE_F = 100
# the second half's mean n_good must pass WIDE_NGOOD_MIN at every length
# but those of WIDE_FEW_USABLE, where the workload offers fewer usable
# features a frame than that (valid, triangulated and within the window: a
# window of 64 clones ends fewer tracks a frame, about 3.4 in the second
# half, on the CPU plain path too; ROADMAP.md section 3): there the card's
# must pass WIDE_ACCEPT of the usable features of the CPU run
WIDE_NGOOD_MIN = 4.0
WIDE_FEW_USABLE = (65,)
WIDE_ACCEPT = 0.9
# an LK window past 16 x 16 (OpenCV's usual 21): images -> poses with
# CLAHE on at tracker.klt_window WIN_WIDE over the first WIN_WIDE_FRAMES
# tracked frames through the graphed image chunk scan, within ATE_LIMIT_M
# and the image path's card-vs-CPU limits of the CPU run, then K8 on the
# last frame's inputs (recorded by an eager run) at every pyramid level
# (row lk_level@win21)
WIN_WIDE = 21
WIN_WIDE_FRAMES = 20
# an LK window past 31 x 31: the tracker's wander bound, (32 - win) / 2 - 1,
# is negative there, so the reference loses every feature on its first
# trip and K8 runs its instance without trips: images -> poses with CLAHE
# on at tracker.klt_window WIN_PAST over WIN_PAST_FRAMES tracked frames
# through the graphed image chunk scan against the CPU plain path (the same
# frames, slots and positions within the image path's card-vs-CPU limits,
# no update on either), then K8 on the last frame's inputs at every level
# (row lk_level@win33: the guesses bitwise, every status false, each
# feature's error within LK_POS_TOL of the plain version's)
WIN_PAST = 33
WIN_PAST_FRAMES = 6
# K5 on the seeded stack of scripts/joseph_order.py (ops/checks.py
# ekf_tail_stack, seed JOSEPH_SEED, JOSEPH_ROWS rows) at n = 84 (the
# narrow kernel) and n = 96 (the wide route): against its plain version
# (rows ekf_tail@stack84 and @stack96) and P_new within JOSEPH_F64_TOL of
# the chain's order in f64, scaled by P_new's diagonal (ROADMAP.md section
# 3: the narrow kernel's earlier order read 5.9e-4 there)
JOSEPH_SEED = 97
JOSEPH_ROWS = 3840
JOSEPH_F64_TOL = 1e-4
# bench.py's high-rate stress config (BASELINE.json's fourth: 800 slots,
# five pyramid levels, ops/checks.py STRESS_ENV): images -> poses over
# STRESS_FRAMES tracked frames of bench.py's sequence cut to
# STRESS_DURATION_S, the kernels checked on tracked frame KLT_FRAME's
# inputs (rows <kernel>@stress)
STRESS_FRAMES = 110
STRESS_DURATION_S = 14.0


def _events_ms(run, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, reps: int, warmup: int = 3) -> float:
    """Time per call of ``fn`` in ms as the port calls it (eager, host
    overhead included), by CUDA events around ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(reps):
            fn()

    return _events_ms(run, reps)


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` in ms: ``reps`` calls captured in one
    CUDA graph and replayed, so no host gap separates the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return _events_ms(graph.replay, reps)


def library_device_ms(fn, reps: int):
    """Device time per call of a library yardstick ``fn``, and how it was
    taken: a CUDA graph of ``reps`` calls, as a kernel's own time is taken;
    where the default backend refuses capture (MAGMA's batched
    ``cholesky_solve`` allocates while capturing), the same graph with the
    cuSOLVER backend; where the call reads back to the host and cannot be
    captured at all (``torch.bincount`` with ``minlength``), the sum of its
    kernels' device times over ``reps`` calls from torch.profiler, which
    leaves out the gaps between them."""
    for backend in ("default", "cusolver"):
        torch.backends.cuda.preferred_linalg_library(backend)
        try:
            return device_ms(fn, reps), ("graph" if backend == "default" else
                                         "graph, cuSOLVER backend")
        except RuntimeError:
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.preferred_linalg_library("default")
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None)
             or e.self_cuda_time_total for e in prof.key_averages()
             if e.device_type.name == "CUDA")
    return us / 1e3 / reps, "profiler kernel sum"


def rotation_gap(q1: np.ndarray, q2: np.ndarray) -> float:
    """Largest rotation angle between paired JPL quaternions (rad), from
    the skew part of R1^T R2 in f64 (accurate for small angles)."""
    from rvio_tpu_torch.core.quaternion import quat_normalize, quat_to_rot
    R1, R2 = (quat_to_rot(quat_normalize(torch.as_tensor(q, dtype=torch.float64)))
              for q in (q1, q2))
    Rr = R1.transpose(-1, -2) @ R2
    s = 0.5 * torch.stack([Rr[:, 2, 1] - Rr[:, 1, 2], Rr[:, 0, 2] - Rr[:, 2, 0],
                           Rr[:, 1, 0] - Rr[:, 0, 1]], dim=-1)
    return float(torch.arcsin(torch.linalg.vector_norm(s, dim=-1).clamp(max=1.0)).max())


@contextlib.contextmanager
def eager_frames():
    """Within the block, the public drivers and builders run their frames
    eagerly (the reference of the graph-against-eager phase)."""
    from unittest import mock

    import rvio_tpu_torch.runtime.image_driver as image_driver
    import rvio_tpu_torch.runtime.step as step
    from rvio_tpu_torch.runtime.graph import EagerFrameScan
    with mock.patch.object(step, "FrameScan", EagerFrameScan), \
            mock.patch.object(image_driver, "FrameScan", EagerFrameScan):
        yield


TAIL_KERNEL = "ekf_tail"
FILTER_KERNELS = ("propagate_block", "lm_triangulate", "jac_project",
                  "batched_quadform", TAIL_KERNEL)
EQUALIZER_KERNELS = ("clahe_luts", "clahe_apply")
ENTRY_KERNELS = ("shi_tomasi", "gather_tiles_aligned")


def expected_launches(n: int, equalizer: bool = True, levels: int = 4
                      ) -> dict:
    """Launches of each kernel when the image path runs its init frame and
    n tracked frames: per frame K6 twice per pyramid level (``levels``)
    plus once for the refill's subpix tiles, K8 once per level, K9 and K13
    once for the refill detection, K10 and K11 once with the equalizer on,
    every filter kernel (K5 included) once; the init frame's preprocessing
    and detection add one K10, K11, K6, K9 and K13.  K12 and K7 are on no
    path."""
    out = {name: n for name in FILTER_KERNELS}
    out.update(gather_tiles=(2 * levels + 1) * n + 1, lk_level=levels * n,
               subpix_refine=n + 1, shi_tomasi_nms=n + 1)
    out.update({name: n + 1 if equalizer else 0 for name in EQUALIZER_KERNELS})
    out.update(dict.fromkeys(ENTRY_KERNELS, 0))
    return out


def bound_ms(chk):
    """The least time the card could take for a check's work, in ms, and
    what bounds it: its bytes at the memory rate or its operations at the
    f32 rate, whichever is larger."""
    t_bytes = (chk.bytes_read + chk.bytes_written) / PEAK_BYTES_PER_S * 1e3
    t_ops = chk.flops / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def measure(chk, label: str = "") -> dict:
    """Kernel vs plain on the card (raises over the tolerance), the device
    time per launch (a CUDA graph of 200), the eager call, the plain
    version's time, the library call's eager and device times
    (:func:`library_device_ms`), and the bound; prints them and returns the
    kernel's record (launches 0 until a path sets them)."""
    err = chk.check()
    torch.cuda.synchronize()
    nbytes = chk.bytes_read + chk.bytes_written
    bound, bound_by = bound_ms(chk)
    ms = device_ms(chk.run_kernel, reps=200)
    per_call_ms = call_ms(chk.run_kernel, reps=200)
    plain_ms = call_ms(chk.run_plain, reps=10)
    lib_ms = lib_dev_ms = how = None
    if chk.library:
        lib_ms = call_ms(lambda: chk.library(*chk.args), reps=200)
        lib_dev_ms, how = library_device_ms(lambda: chk.library(*chk.args),
                                            reps=200)
    rec = dict(name=chk.name, route="cuda", source=chk.source,
               replaces=chk.replaces, launches=0, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
               library_ms=lib_ms, library_device_ms=lib_dev_ms,
               library_device_how=how)
    info = "".join(f", {k} {v}" for k, v in chk.info.items())
    print(f"kernel {chk.name}{label}: err {err:.3e} (tolerance: "
          f"{chk.tolerance}{info}); {ms * 1e3:.2f} us/launch on the device "
          f"({per_call_ms * 1e3:.1f} us per eager call), plain "
          f"{plain_ms * 1e3:.1f} us, library "
          f"{'-' if lib_ms is None else f'{lib_ms * 1e3:.1f} us eager, {lib_dev_ms * 1e3:.2f} us on the device ({how})'}, "
          f"bound {rec['bound_ms'] * 1e3:.3f} us ({rec['bound_by']}: "
          f"{nbytes} B, {chk.flops:.3g} flop)", flush=True)
    return rec


def _zero(kernels) -> None:
    for kernel in kernels.values():
        kernel.launches = 0


def _launches(kernels) -> dict:
    return {name: k.launches for name, k in kernels.items()}


def image_config(equalizer: bool):
    from rvio_tpu_torch import RVIOConfig
    cfg = RVIOConfig()
    if equalizer:
        return cfg
    return dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, enable_equalizer=False))


def image_phase(dev, sim, kernels, records, equalizer: bool,
                n_frames=None):
    """Images -> poses on the card (the first ``n_frames`` tracked frames,
    or all), then its first frames on the CPU.  With the equalizer on, the
    image kernels' launches go to ``records``.  Returns the card run."""
    from rvio_tpu_torch.eval.ate import ate_rmse
    from rvio_tpu_torch.runtime import run_rendered_sequence_scan

    cfg = image_config(equalizer)
    label = "image path (equalizer on)" if equalizer else \
        "image path (equalizer off)"
    k0 = _init_frame(cfg, sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    k_end = len(sim.frame_t) if n_frames is None else k0 + 1 + n_frames
    # warm-up: library handles and the allocator's pool
    run_rendered_sequence_scan(cfg, sim, device=dev, max_frames=k0 + 9)
    _zero(kernels)
    t0 = time.perf_counter()
    res = run_rendered_sequence_scan(cfg, sim, device=dev, timing_split=True,
                                     max_frames=k_end)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(kernels)
    if equalizer:
        for kernel, rec in records:
            if rec["name"] not in FILTER_KERNELS + ENTRY_KERNELS and (
                    "@" not in rec["name"]):      # rows of other paths
                rec["launches"] = kernel.launches
    n = len(res.timestamps)
    if n != k_end - k0 - 1:
        raise AssertionError(f"{label} skipped frames of the loop")
    idx = np.searchsorted(sim.frame_t, res.timestamps)
    ate = ate_rmse(res.positions, sim.gt_p[idx])
    acc = res.acceptance_stats()
    usable = float(res.diag["n_usable"].mean())
    fe, be = float(res.frontend_ms.mean()), float(res.backend_ms.mean())
    print(f"{label}: {n} frames (init frame {k0}), {n / wall:.1f} frames/s "
          f"images -> poses ({wall:.2f} s, host rendering included); "
          f"front-end {fe:.3f} ms/frame, back-end {be:.3f} ms/frame on the "
          f"card; ATE {ate:.4f} m (limit {ATE_LIMIT_M}); acceptance "
          f"{json.dumps(acc)}, n_usable mean {usable:.1f}; wider ridge on "
          f"{int(res.diag['ridge_fallback'].sum())} frames; launches "
          f"{launches}", flush=True)
    want = expected_launches(n, equalizer)
    if launches != want:
        raise AssertionError(f"image path launches {launches}, expected {want}")
    if not (np.isfinite(res.positions).all() and res.positions.shape == (n, 3)
            and np.isfinite(res.quaternions).all()):
        raise AssertionError("non-finite or misshapen image-path trajectory")
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"image-path ATE {ate:.4f} m over {ATE_LIMIT_M} m")
    for key, (op, lim) in ACCEPT_GATES.items():
        if not (acc[key] > lim if op == ">" else acc[key] < lim):
            raise AssertionError(f"{key} {acc[key]:.3f} fails {op} {lim}")
    if not usable > N_USABLE_MIN:
        raise AssertionError(f"n_usable mean {usable:.1f} <= {N_USABLE_MIN}")

    # the first frames again through the plain path on the CPU (f32, the
    # same seed and so the same RANSAC draws)
    t0 = time.perf_counter()
    cpu = run_rendered_sequence_scan(cfg, sim, device="cpu",
                                     max_frames=k0 + 1 + IMG_CPU_FRAMES)
    m = len(cpu.timestamps)
    if m != IMG_CPU_FRAMES or not np.array_equal(cpu.timestamps,
                                                 res.timestamps[:m]):
        raise AssertionError("the CPU image run filtered other frames")
    agree = float((cpu.active_slots == res.active_slots[:m]).mean())
    dp = float(np.abs(cpu.positions - res.positions[:m]).max())
    print(f"{label}, cpu plain path, first {m} frames "
          f"({time.perf_counter() - t0:.1f} s): active slots agree on "
          f"{agree:.4%} of slot-frames (limit {IMG_CPU_ACTIVE_AGREE:.0%}), "
          f"max position gap {dp:.3e} m (limit {IMG_CPU_GAP_POS_M})",
          flush=True)
    if not (agree >= IMG_CPU_ACTIVE_AGREE and dp < IMG_CPU_GAP_POS_M):
        raise AssertionError("card image path and CPU plain path disagree")
    return res


def workload_sim():
    """bench.py's 60 s synthetic sequence at ``RVIOConfig()``."""
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.dataio import simulate_sequence
    return simulate_sequence(RVIOConfig(), duration=60.0, static_time=1.5,
                             ramp_time=5.0, seed=7, n_landmarks=2000,
                             motion_scale=0.8, meas_noise=0.001,
                             imu_noise=True)


def capture_klt_frame(dev, sim, cfg=None, frame: int = KLT_FRAME, seq=None,
                      filters=None):
    """The inputs of the tracker's K6, K8, K10, K9 and K13 calls at tracked
    frame ``frame`` of images -> poses on ``dev`` (``cfg``: ``RVIOConfig()``,
    CLAHE on), in one run: ``sim`` rendered, or ``seq``, a loaded sequence,
    replayed (``sim`` then only gives the init frame's stamps).  Returns
    (levels, K10's image, K9's call, K13's image): per pyramid level,
    coarsest first, (level, the template gather's (image, origins), the
    search gather's, K8's args, K8's kwargs); the image of the last
    ``clahe_luts`` call (None with the equalizer off); the (args, kwargs)
    of the frame's refill ``subpix_refine`` and the image of its
    ``shi_tomasi_nms``.  The tracker is its batched body at B = 1, so the
    recorders drop the segment axis of the batched calls.  The run's
    frames are eager (:func:`eager_frames`), so the recorders see every
    frame's calls.  A dict ``filters`` receives the frame's K2, K3 and K4
    calls (name -> args) as well."""
    from unittest import mock

    import rvio_tpu_torch.frontend.detector as detector
    import rvio_tpu_torch.frontend.image as image
    import rvio_tpu_torch.frontend.klt as klt
    from rvio_tpu_torch.runtime import (run_euroc_sequence_scan,
                                        run_rendered_sequence_scan)
    cfg = image_config(True) if cfg is None else cfg
    levels = cfg.tracker.klt_levels + 1
    calls = {"lk_level": [], "gather_tiles": [], "clahe_luts": [],
             "subpix_refine": [], "shi_tomasi_nms": []}

    def recorder(module, name, keep, segment=None):
        fn = getattr(module, name)
        # the calls with a segment axis (K9's take B·N rows)
        segment = name != "subpix_refine" if segment is None else segment

        def record(*args, **kw):
            kept = tuple((a[0] if segment else a).clone()
                         if torch.is_tensor(a) else a for a in args)
            calls[name] = (calls[name] + [(kept, dict(kw))])[-keep:]
            return fn(*args, **kw)
        return record

    if seq is not None:
        k0 = _init_frame(cfg, seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t)
    else:
        k0 = _init_frame(cfg, sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    import rvio_tpu_torch.filter.update as update
    stack = contextlib.ExitStack()
    for name in (("lm_triangulate", "jac_project", "batched_quadform")
                 if filters is not None else ()):
        calls[name] = []
        stack.enter_context(mock.patch.object(
            update, name, recorder(update, name, 1, segment=False)))
    with stack, \
            mock.patch.object(klt, "lk_level", recorder(klt, "lk_level", levels)), \
            mock.patch.object(klt, "gather_tiles",
                              recorder(klt, "gather_tiles", 2 * levels)), \
            mock.patch.object(image, "clahe_luts",
                              recorder(image, "clahe_luts", 1)), \
            mock.patch.object(detector, "subpix_refine",
                              recorder(detector, "subpix_refine", 1)), \
            mock.patch.object(detector, "shi_tomasi_nms",
                              recorder(detector, "shi_tomasi_nms", 1)), \
            eager_frames():
        if seq is not None:
            res = run_euroc_sequence_scan(cfg, seq, device=dev,
                                          max_frames=k0 + 1 + frame)
        else:
            res = run_rendered_sequence_scan(cfg, sim, device=dev,
                                             max_frames=k0 + 1 + frame)
    if len(res.timestamps) != frame:
        raise AssertionError(f"the capture run tracked {len(res.timestamps)} "
                             f"frames, not {frame}")
    out = []
    for i in range(levels):
        tmpl, search = (calls["gather_tiles"][2 * i + k][0][:2] for k in (0, 1))
        args, kw = calls["lk_level"][i]
        out.append((levels - 1 - i, tmpl, search, args, kw))
    eq = calls["clahe_luts"]
    if filters is not None:
        filters.update({name: calls[name][-1][0] for name in (
            "lm_triangulate", "jac_project", "batched_quadform")})
    return (out, eq[-1][0][0] if eq else None, calls["subpix_refine"][-1],
            calls["shi_tomasi_nms"][-1][0][0])


def klt_frame_phase(dev, sim, records):
    """K8 and K6 on the tracker's inputs at tracked frame KLT_FRAME of the
    CLAHE-on image path, at each pyramid level: each against its plain
    version (raises over the check's tolerance), T and the trip counts of
    the live features (plain version), the device time a launch (a CUDA
    graph of 200); into each kernel's record as ``frame_levels``.  K10 on
    the same frame's image, K11 on that image with its LUTs (the tracker's
    CLAHE: clip 3.0, a 5 x 5 grid), K9 and K13 on that frame's refill
    detection (:func:`frame_check`), all captured in the same run.
    Returns the per-level captures (:func:`capture_klt_frame`)."""
    from rvio_tpu_torch.ops.checks import (clahe_apply_case,
                                           clahe_luts_case, lk_case,
                                           shi_nms_case, subpix_case,
                                           tile_case)
    from rvio_tpu_torch.ops.clahe import clahe_luts_plain
    t0 = time.perf_counter()
    captured, eq_img, subpix, nms_img = capture_klt_frame(dev, sim)
    print(f"KLT inputs of tracked frame {KLT_FRAME} (CLAHE on) captured on "
          f"the card in {time.perf_counter() - t0:.1f} s", flush=True)
    k8_levels, k6_levels = [], []
    for lvl, tmpl, search, args, kw in captured:
        what = f" (frame {KLT_FRAME}, level {lvl})"
        lk = lk_case(dev, args, kw, what=what)
        err = lk.check()
        tiles = [tile_case(dev, img, o, what=what) for img, o in (tmpl, search)]
        for chk in tiles:
            chk.check()
        torch.cuda.synchronize()
        H, W = tmpl[0].shape
        live = args[5].cpu().numpy()
        trips = lk.trips[live]
        T = int(lk.trips.max(initial=0))
        hist = {int(k): int(v) for k, v in
                zip(*np.unique(trips, return_counts=True))}
        ms = device_ms(lk.run_kernel, reps=200)
        ms6 = [device_ms(chk.run_kernel, reps=200) for chk in tiles]
        k8_levels.append(dict(level=lvl, hw=[H, W], n_live=int(live.sum()),
                              T=T, trips=hist, max_abs_err=err,
                              alive_agree=lk.info["alive_agree"], ms=ms))
        k6_levels.append(dict(level=lvl, hw=[H, W], max_abs_err=0.0,
                              ms_template=ms6[0], ms_search=ms6[1]))
        print(f"kernel lk_level{what}: {H}x{W}, {int(live.sum())} live of "
              f"{len(live)}, trips of the live {hist}, T {T}; err {err:.3e} "
              f"(tolerance: {lk.tolerance}, alive agree "
              f"{lk.info['alive_agree']:.4f}); {ms * 1e3:.2f} us/launch on "
              f"the device, bound {bound_ms(lk)[0] * 1e3:.3f} us", flush=True)
        print(f"kernel gather_tiles{what}: exact; template tiles "
              f"{ms6[0] * 1e3:.2f} us/launch, search tiles "
              f"{ms6[1] * 1e3:.2f} us/launch on the device, bounds "
              f"{bound_ms(tiles[0])[0] * 1e3:.3f} and "
              f"{bound_ms(tiles[1])[0] * 1e3:.3f} us", flush=True)
    for _, r in records:
        if r["name"] == "lk_level":
            r["frame_levels"] = k8_levels
        elif r["name"] == "gather_tiles":
            r["frame_levels"] = k6_levels
    frame_check(records, clahe_luts_case(
        dev, eq_img, what=f" (frame {KLT_FRAME}'s image)"),
        f"tracked frame {KLT_FRAME}'s image, CLAHE on")
    eq = eq_img.cpu()
    frame_check(records, clahe_apply_case(
        dev, eq, clahe_luts_plain(eq, 3.0, 5), 5,
        what=f" (frame {KLT_FRAME}'s image)"),
        f"tracked frame {KLT_FRAME}'s image and its LUTs")
    (tiles, origin, pts), kw = subpix
    frame_check(records, subpix_case(
        dev, tiles, origin, pts, **kw, what=f" (frame {KLT_FRAME}'s refill)"),
        f"tracked frame {KLT_FRAME}'s refill, {len(pts)} corners, win "
        f"{kw['win']}, {kw['iters']} iterations")
    frame_check(records, shi_nms_case(
        dev, nms_img, what=f" (frame {KLT_FRAME}'s level 0)"),
        f"tracked frame {KLT_FRAME}'s level 0, CLAHE on, "
        f"{nms_img.shape[0]}x{nms_img.shape[1]}")
    return captured


def _render_u8(cfg, sim, k):
    from rvio_tpu_torch.dataio.synthetic import render_frame
    return np.clip(render_frame(cfg, sim, k), 0, 255).astype(np.uint8)


def online_phase(dev, sim, kernels, scan):
    """OnlineDriver on the card, fed as a live node would be: each frame's
    IMU through the first sample at or after its stamp (the buffer waits
    for such a sample, and the simulator's stamps can put the sample of
    the frame's instant a rounding error before it), then its image, then
    one spin.  Returns the driver."""
    from rvio_tpu_torch.runtime import OnlineDriver

    cfg = image_config(True)
    k_end = int(np.searchsorted(sim.frame_t, scan.timestamps[ONLINE_FRAMES - 1])) + 1
    t0 = time.perf_counter()
    frames = [_render_u8(cfg, sim, k) for k in range(k_end)]
    render_s = time.perf_counter() - t0
    drv = OnlineDriver(cfg, device=dev)
    _zero(kernels)
    pushed, lat, imu_done = {}, [], 0
    t0 = time.perf_counter()
    for k in range(k_end):
        t = sim.frame_t[k]
        end = min(int(np.searchsorted(sim.imu_t, t)) + 1, len(sim.imu_t))
        for j in range(imu_done, end):
            drv.push_imu(sim.imu_t[j], sim.imu_w[j], sim.imu_a[j], seq=j)
        imu_done = end
        pushed[t] = time.perf_counter()
        drv.push_image(t, frames[k], seq=k)
        got = drv.spin_once()
        if got is not None:
            lat.append((time.perf_counter() - pushed[got["t"]]) * 1e3)
    wall = time.perf_counter() - t0
    launches = _launches(kernels)
    n = len(drv.poses)
    want = expected_launches(drv.pipeline.n_tracked)
    t_on = np.asarray([p[0] for p in drv.poses])
    p_on = np.asarray([p[1] for p in drv.poses])
    if n < ONLINE_FRAMES - 1 or not np.array_equal(t_on, scan.timestamps[:n]):
        raise AssertionError(f"the live path gave {n} poses at other frames "
                             f"than the scan")
    gap = float(np.abs(p_on - scan.positions[:n]).max())
    p50, p99 = np.percentile(lat, [50, 99])
    print(f"live path (OnlineDriver): {n} poses from {k_end} pushed frames "
          f"in {wall:.2f} s = {n / wall:.1f} frames/s (frames pre-rendered "
          f"in {render_s:.1f} s); push-to-pose latency p50 {p50:.2f} ms, p99 "
          f"{p99:.2f} ms; drops {drv.drops}; max position gap to the "
          f"equalizer-on scan {gap:.3e} m (limit {ONLINE_GAP_M}); launches "
          f"{launches}", flush=True)
    if drv.drops != {"imu": 0, "image": 0}:
        raise AssertionError(f"the live path counted drops {drv.drops}")
    if launches != want:
        raise AssertionError(f"live path launches {launches}, expected {want}")
    if not (np.isfinite(p_on).all() and gap < ONLINE_GAP_M):
        raise AssertionError("the live path and the scan disagree")
    return drv


def entries_phase(dev, sim, kernels, records, drv) -> None:
    """K12 and K7 through their public entries on the workload's frames:
    the detector's response on the first tracked frames, the aligned
    tiles at the live driver's final feature positions."""
    from rvio_tpu_torch.frontend.detector import shi_tomasi_response
    from rvio_tpu_torch.ops.shi_tomasi import \
        shi_tomasi_response as shi_plain
    from rvio_tpu_torch.ops.tile_gather import (gather_tiles_aligned,
                                                gather_tiles_aligned_plain)

    cfg = image_config(True)
    k1 = int(np.searchsorted(sim.frame_t, drv.poses[0][0]))
    imgs = [torch.as_tensor(_render_u8(cfg, sim, k)).to(dev).float()
            for k in range(k1, k1 + 3)]
    ts = drv.pipeline.tracker_state
    live = ts.pos[ts.active]
    origins = torch.round(live - live.new_tensor([128.0, 20.0])).int()
    last = ts.pyramid[0].contiguous()
    _zero(kernels)
    resp = [shi_tomasi_response(img) for img in imgs]
    tiles = gather_tiles_aligned(last, origins)
    torch.cuda.synchronize()
    launches = _launches(kernels)
    for kernel, rec in records:
        if rec["name"] in ENTRY_KERNELS:
            rec["launches"] = kernel.launches
    plain = [shi_plain(img) for img in imgs]
    diff = sum(int((r != q).sum()) for r, q in zip(resp, plain))
    rel = max(float(((r - q).abs() / q.abs().clamp(min=1e-30)).max())
              for r, q in zip(resp, plain))
    exact = torch.equal(tiles, gather_tiles_aligned_plain(last, origins))
    print(f"public entries: shi_tomasi_response on {len(imgs)} frames, "
          f"{diff} pixels differ from the plain version (max rel {rel:.3e}, "
          f"limit 1e-5); gather_tiles_aligned at {len(origins)} live "
          f"positions, {'exact' if exact else 'DIFFERS'}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    want = dict.fromkeys(kernels, 0)
    want.update(shi_tomasi=len(imgs), gather_tiles_aligned=1)
    if launches != want:
        raise AssertionError(f"entry launches {launches}, expected {want}")
    if not (rel <= 1e-5 and exact):
        raise AssertionError("a public entry disagrees with its plain version")


def capture_frame_inputs(cfg, args, frame_t, batches):
    """The feature path on the CPU plain path, keeping the inputs of the
    last K1, K3 and K5 calls: a real frame's IMU block, state and P24 (the
    inputs of the propagation's form on the CPU, K1's plain version or the
    parallel prefix, which take the same arguments); its update features'
    measurements, chains and triangulation; and its C, b, P and sigma^2.
    Returns (result, K1 inputs, K5 inputs, K3 inputs)."""
    from unittest import mock

    import rvio_tpu_torch.filter.propagation as propagation
    import rvio_tpu_torch.filter.update as update
    from rvio_tpu_torch.ops import ekf_tail as k5
    from rvio_tpu_torch.ops import jac_project as k3
    from rvio_tpu_torch.ops import propagate_block as k1
    from rvio_tpu_torch.runtime import SequenceDriver
    captured = {}

    def recorder(name, fn):
        def record(*call_args, **kw):
            captured[name] = [a.detach().clone() if torch.is_tensor(a) else a
                              for a in call_args]
            return fn(*call_args, **kw)
        return record

    with mock.patch.object(update, "ekf_tail", recorder("k5", k5.ekf_tail)), \
            mock.patch.object(update, "jac_project",
                              recorder("k3", k3.jac_project)), \
            mock.patch.object(propagation, "propagate_block",
                              recorder("k1", k1.propagate_block)), \
            mock.patch.object(propagation, "propagate_parallel",
                              recorder("k1", propagation.propagate_parallel)):
        res = SequenceDriver(cfg, dtype=torch.float32,
                             device="cpu").run(*args, frame_t, batches)
    return (res, [x.numpy() for x in captured["k1"]],
            [x[0].numpy() for x in captured["k5"]], captured["k3"])


def frame_check(records, chk, label: str) -> None:
    """A kernel's check on a real frame's inputs beside its check case:
    error (raises over the tolerance), device time a launch (a CUDA graph of
    200) and bound go into its record as ``frame_max_abs_err``,
    ``frame_ms`` and ``frame_bound_ms``."""
    err = chk.check()
    torch.cuda.synchronize()
    ms = device_ms(chk.run_kernel, reps=200)
    bound, bound_by = bound_ms(chk)
    for _, r in records:
        if r["name"] == chk.name:
            r.update(frame_max_abs_err=err, frame_ms=ms, frame_bound_ms=bound)
    info = "".join(f", {k} {v}" for k, v in chk.info.items())
    print(f"kernel {chk.name} ({label}): err {err:.3e} (tolerance: "
          f"{chk.tolerance}{info}); {ms * 1e3:.2f} us/launch on the device, "
          f"bound {bound * 1e3:.3f} us ({bound_by})", flush=True)


def filter_frame_phase(dev, records, k1_inputs, k3_inputs) -> None:
    """K1 and K3 on the feature path's frame 100 (captured from the CPU
    plain path; :func:`frame_check`)."""
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.ops.checks import jac_case, propagate_case
    if not all(np.isfinite(x).all() for x in k1_inputs):
        raise AssertionError("the captured K1 inputs are not finite")
    label = "the feature path's frame 100, CPU plain path"
    frame_check(records, propagate_case(RVIOConfig(), dev, k1_inputs,
                                        what=" (the feature path's frame 100)"),
                f"{label}; {k1_inputs[2].shape[-1]} samples")
    t_eff = k3_inputs[10]
    frame_check(records, jac_case(dev, k3_inputs,
                                  what=" (the feature path's frame 100)"),
                f"{label}; F {len(t_eff)}, t_eff sum {int(t_eff.sum())}, "
                f"M {k3_inputs[-1]}")


def ekf_tail_phase(dev, records, inputs) -> None:
    """K5 on a real frame's inputs (its record: error, times, bound), on
    seeded inputs that take the wider ridge, and on the seeded stack of
    scripts/joseph_order.py at n = 84 (:func:`joseph_stack_row`, with the
    main path's launches)."""
    from rvio_tpu_torch.ops.checks import (EKF_TAIL_FALLBACK_SCALED_TOL,
                                           EKF_TAIL_FALLBACK_TOL,
                                           ekf_tail_case,
                                           ekf_tail_fallback_inputs)
    C, b, P, sig2 = inputs
    if not all(np.isfinite(x).all() for x in inputs):
        raise AssertionError("the captured K5 inputs are not finite")
    chk = ekf_tail_case(dev, C, b, P, sig2, tol=EKF_TAIL_FRAME_TOL,
                        what="the feature path's frame 100")
    rec = measure(chk, " (the feature path's frame 100, CPU plain path)")
    main_launches = next(r["launches"] for _, r in records
                         if r["name"] == TAIL_KERNEL)
    for _, r in records:
        if r["name"] == TAIL_KERNEL:
            r.update(rec)
    # what one K5 launch replaces: the unfused chain's launches (its device
    # time, a CUDA graph of its launches, is the record's library column)
    from torch.profiler import ProfilerActivity, profile
    lib_dev_ms = rec["library_device_ms"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chk.library(*chk.args)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.count]
    kern = sum(e.count for e in rows
               if not e.key.startswith(("Memcpy", "Memset")))
    copies = sum(e.count for e in rows) - kern
    print(f"kernel {TAIL_KERNEL}: one launch replaces the unfused chain's "
          f"{kern} kernel launches and {copies} copies/sets a call "
          f"(torch.profiler), {lib_dev_ms * 1e3:.2f} us on the device "
          f"({rec['library_device_how']}) against K5's {rec['ms'] * 1e3:.2f} "
          f"us: K5 takes {rec['ms'] / lib_dev_ms:.3f} of the chain's device "
          f"time", flush=True)
    fb = ekf_tail_case(dev, *ekf_tail_fallback_inputs(
        np.random.default_rng(0)), tol=EKF_TAIL_FALLBACK_TOL,
        what="seeded wider-ridge case",
        scaled_tol=EKF_TAIL_FALLBACK_SCALED_TOL)
    err = fb.check()
    torch.cuda.synchronize()
    if not (fb.info["fallback"] and bool(fb.run_kernel()[2].all())):
        raise AssertionError("ekf_tail: the seeded case did not take the "
                             "wider ridge")
    print(f"kernel {TAIL_KERNEL} (seeded wider-ridge case): fallback taken "
          f"by kernel and plain version, err {err:.3e}, P_new scaled by its "
          f"diagonal {fb.info['P_new scaled by its diagonal']} (tolerance: "
          f"{fb.tolerance})", flush=True)
    joseph_stack_row(dev, records, 14, main_launches)


def library_chain_phase(dev, sim, batches, kernels, k5_run, k5_driver
                        ) -> None:
    """The feature path on the card with the unfused library chain called
    in K5's place (a yardstick: the port never runs it on the card): K5
    never launches, and the first frames stay within the card-vs-CPU
    limits of the K5 run (two summation orders of one function); then the
    back-end time of the two over the first TIMING_FRAMES frames, in turns
    (chain, K5, K5, chain, ...)."""
    from unittest import mock

    import rvio_tpu_torch.filter.update as update
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.eval.ate import ate_rmse
    from rvio_tpu_torch.ops.ekf_tail import ekf_tail_plain
    from rvio_tpu_torch.runtime import SequenceDriver

    args = (sim.imu_t, sim.imu_w, sim.imu_a)
    driver = SequenceDriver(RVIOConfig(), dtype=torch.float32, device=dev)

    def chain_run(frame_t, bs):
        with mock.patch.object(update, "ekf_tail", ekf_tail_plain):
            return driver.run(*args, frame_t, bs)

    chain_run(sim.frame_t[:100], batches[:100])   # warm-up: handles
    _zero(kernels)
    t0 = time.perf_counter()
    res = chain_run(sim.frame_t, batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(kernels)
    n = len(res.timestamps)
    want = dict.fromkeys(kernels, 0)
    want.update(dict.fromkeys(FILTER_KERNELS, n))
    want[TAIL_KERNEL] = 0
    if launches != want or not np.array_equal(res.timestamps,
                                              k5_run.timestamps):
        raise AssertionError(f"library-chain feature path: launches "
                             f"{launches} over {n} frames, expected {want}")
    dp = float(np.abs(res.positions - k5_run.positions)[:CPU_FRAMES].max())
    dq = rotation_gap(res.quaternions[:CPU_FRAMES],
                      k5_run.quaternions[:CPU_FRAMES])
    ate = ate_rmse(res.positions,
                   sim.gt_p[np.searchsorted(sim.frame_t, res.timestamps)])
    print(f"feature path with the library chain in K5's place: {n} frames, "
          f"{n / wall:.1f} frames/s end to end, back-end "
          f"{res.backend_ms.mean():.3f} ms/frame (K5 "
          f"{k5_run.backend_ms.mean():.3f}), ATE {ate:.4f} m; first "
          f"{CPU_FRAMES} frames against the K5 run: max position gap "
          f"{dp:.3e} m (limit {CPU_GAP_POS_M}), attitude {dq:.3e} rad "
          f"(limit {CPU_GAP_ROT_RAD}); wider ridge on "
          f"{int(res.diag['ridge_fallback'].sum())} frames (K5 "
          f"{int(k5_run.diag['ridge_fallback'].sum())}); launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if not (dp < CPU_GAP_POS_M and dq < CPU_GAP_ROT_RAD and ate < ATE_LIMIT_M
            and np.isfinite(res.positions).all()):
        raise AssertionError("the K5 and library-chain feature paths "
                             "disagree")

    k_end = int(np.searchsorted(sim.frame_t,
                                res.timestamps[TIMING_FRAMES - 1])) + 1
    runs = {False: chain_run,
            True: lambda ft, bs: k5_driver.run(*args, ft, bs)}
    ms = {False: [], True: []}
    for k5 in (False, True) * (TIMING_PAIRS // 2) + (True, False) * (
            TIMING_PAIRS // 2):
        ms[k5].append(float(runs[k5](sim.frame_t[:k_end],
                                     batches[:k_end]).backend_ms.mean()))
    print(f"feature path back-end in turns over the first {TIMING_FRAMES} "
          f"frames: library chain {[round(x, 3) for x in ms[False]]} "
          f"ms/frame, K5 {[round(x, 3) for x in ms[True]]} ms/frame; medians "
          f"{np.median(ms[False]):.3f} and {np.median(ms[True]):.3f}",
          flush=True)


def write_asl(root, cfg, sim):
    """The workload as a EuRoC ASL folder (the layout of
    tests/test_euroc_pipeline.py): every rendered u8 frame as a PNG, the
    IMU and the ground truth as CSV, stamps T0_NS + t ns.  Returns the
    folder loaded back (``load_euroc``) and the simulator's sequence on
    those stamps (the same frames and IMU, so the rendered paths and the
    replay see the same inputs)."""
    from rvio_tpu_torch.dataio.euroc import load_euroc
    from rvio_tpu_torch.dataio.png import write_png_gray
    mav = os.path.join(root, "mav0")
    for d in ("imu0", "cam0/data", "state_groundtruth_estimate0"):
        os.makedirs(os.path.join(mav, d))

    def ns(t):
        return T0_NS + int(round(t * 1e9))

    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for t, w, a in zip(sim.imu_t, sim.imu_w, sim.imu_a):
            f.write(f"{ns(t)},{w[0]},{w[1]},{w[2]},{a[0]},{a[1]},{a[2]}\n")
    with open(os.path.join(mav, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        f.writelines(f"{ns(t)},{ns(t)}.png\n" for t in sim.frame_t)
    with open(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"),
              "w") as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n")
        for t, p in zip(sim.frame_t, sim.gt_p):
            f.write(f"{ns(t)},{p[0]},{p[1]},{p[2]},1,0,0,0\n")

    def frame(k):
        write_png_gray(os.path.join(mav, "cam0", "data",
                                    f"{ns(sim.frame_t[k])}.png"),
                       _render_u8(cfg, sim, k))

    with ThreadPoolExecutor(WRITE_THREADS) as pool:
        list(pool.map(frame, range(len(sim.frame_t))))
    seq = load_euroc(root)
    if not (np.array_equal(seq.imu_w, sim.imu_w)
            and np.array_equal(seq.imu_a, sim.imu_a)
            and len(seq.cam_files) == len(sim.frame_t)):
        raise AssertionError("the ASL folder does not read back")
    return seq, dataclasses.replace(sim, imu_t=seq.imu_t, frame_t=seq.cam_t)


def _init_frame(cfg, imu_t, imu_w, imu_a, frame_t) -> int:
    from rvio_tpu_torch.runtime import bundle_imu
    from rvio_tpu_torch.runtime.image_driver import _find_init_frame
    groups = bundle_imu(imu_t, imu_w, imu_a, frame_t)
    return _find_init_frame(cfg, groups, len(frame_t), torch.float32,
                            "cpu")[1]


def replay_phase(dev, root, seq, kernels, records, tmp):
    """The slice's main path: ``python -m rvio_tpu_torch.run --euroc`` on
    the folder with ``RVIOConfig()``, in process.  Returns the run."""
    from rvio_tpu_torch import run as cli
    from rvio_tpu_torch.dataio.tum import read_tum
    from rvio_tpu_torch.eval.ate import ate_rmse

    out = os.path.join(tmp, "out")
    _zero(kernels)
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res = cli.run(["--euroc", root, "--output", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(kernels)
    for kernel, rec in records:
        if rec["name"] == TAIL_KERNEL:
            rec["launches"] = kernel.launches
    n = len(res.timestamps)
    gi = np.clip(np.searchsorted(seq.gt_t, res.timestamps), 0,
                 len(seq.gt_t) - 1)
    ate = ate_rmse(res.positions, seq.gt_p[gi])
    acc = res.acceptance_stats()
    usable = float(res.diag["n_usable"].mean())
    t_dat = read_tum(os.path.join(out, "stamped_pose_ests.dat"))[0]
    cost = np.loadtxt(os.path.join(out, "time_cost.dat"), ndmin=2)
    fe, be = float(cost[:, 1].mean()), float(cost[:, 2].mean())
    print(f"file replay (the run CLI, --euroc): {n} "
          f"frames in {wall:.2f} s = {n / wall:.1f} frames/s end to end, "
          f"{n / (wall - res.image_s):.1f} frames/s without the "
          f"{res.image_s:.2f} s of PNG decode ({res.decoder} decoder); "
          f"front-end {fe:.3f} ms/frame, back-end {be:.3f} ms/frame; ATE "
          f"{ate:.4f} m (limit {ATE_LIMIT_M}); acceptance {json.dumps(acc)}, "
          f"n_usable mean {usable:.1f}; wider ridge on "
          f"{int(res.diag['ridge_fallback'].sum())} frames; launches "
          f"{launches}", flush=True)
    print("  the CLI printed: " + " | ".join(printed.getvalue().splitlines()),
          flush=True)
    want = expected_launches(n)
    if launches != want:
        raise AssertionError(f"file replay launches {launches}, expected "
                             f"{want}")
    if not (np.isfinite(res.positions).all() and ate < ATE_LIMIT_M):
        raise AssertionError(f"file replay ATE {ate:.4f} m over {ATE_LIMIT_M}")
    for key, (op, lim) in ACCEPT_GATES.items():
        if not (acc[key] > lim if op == ">" else acc[key] < lim):
            raise AssertionError(f"file replay {key} {acc[key]:.3f} fails "
                                 f"{op} {lim}")
    if not usable > N_USABLE_MIN:
        raise AssertionError(f"n_usable mean {usable:.1f} <= {N_USABLE_MIN}")
    # stamped_pose_ests.dat keeps nine decimals of a second
    if not (len(t_dat) == n and np.abs(t_dat - res.timestamps).max() < 1e-9
            and cost.shape == (n, 3)
            and np.array_equal(cost[:, 0], np.arange(1, n + 1))):
        raise AssertionError("the .dat files do not hold one line a frame")
    return res


def replay_checks(dev, seq, kernels, scan, tmp) -> None:
    """The replay against the rendered scan (the same bytes); a bag of the
    first frames against the folder; a run saved half-way and resumed
    against the uninterrupted run."""
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.dataio.euroc import load_image
    from rvio_tpu_torch.dataio.rosbag import (load_rosbag, serialize_image,
                                              serialize_imu, write_rosbag)
    from rvio_tpu_torch.runtime import run_euroc_sequence_scan

    cfg = RVIOConfig()
    k0 = _init_frame(cfg, seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t)
    m = REPLAY_SCAN_FRAMES
    _zero(kernels)
    rep = run_euroc_sequence_scan(cfg, seq, device=dev, max_frames=k0 + 1 + m)
    launches = _launches(kernels)
    agree = float((rep.active_slots == scan.active_slots[:m]).mean())
    gap = float(np.abs(rep.positions - scan.positions[:m]).max())
    print(f"file replay vs the rendered scan, first {m} "
          f"frames: active slots agree on {agree:.4%} of slot-frames, max "
          f"position gap {gap:.3e} m (limit {REPLAY_GAP_M})", flush=True)
    if not (np.array_equal(rep.timestamps, scan.timestamps[:m])
            and agree == 1.0 and gap <= REPLAY_GAP_M
            and launches == expected_launches(m)):
        raise AssertionError(f"the replay and the rendered scan disagree "
                             f"(launches {launches})")

    k_end = k0 + 1 + BAG_FRAMES
    bag = os.path.join(tmp, "first.bag")
    t_last = seq.cam_t[k_end - 1]
    msgs = [("/imu0", b"sensor_msgs/Imu", float(t),
             serialize_imu(i, float(t), w, a))
            for i, (t, w, a) in enumerate(zip(seq.imu_t, seq.imu_w, seq.imu_a))
            if t <= t_last]
    msgs += [("/cam0/image_raw", b"sensor_msgs/Image", float(seq.cam_t[k]),
              serialize_image(k, float(seq.cam_t[k]),
                              load_image(seq.cam_files[k])))
             for k in range(k_end)]
    msgs.sort(key=lambda x: x[2])
    write_rosbag(bag, msgs, chunk_count=20)
    bseq = load_rosbag(bag)
    ni = len(bseq.imu_t)
    dt = max(float(np.abs(bseq.imu_t - seq.imu_t[:ni]).max()),
             float(np.abs(bseq.cam_t - seq.cam_t[:k_end]).max()))
    if not (np.array_equal(bseq.imu_w, seq.imu_w[:ni])
            and np.array_equal(bseq.imu_a, seq.imu_a[:ni]) and dt < 1e-9):
        raise AssertionError("the bag does not hold the folder's IMU stream")
    # The two formats turn one ns stamp into float seconds by different
    # roundings (sec + nsec 1e-9 against ns 1e-9, an ulp apart), and the
    # workload's init gate sums frame spans to an exact 0.6 s boundary
    # (runtime/driver.py InitializationGate), so the folder replay compared
    # takes the bag's stamps: what differs is where frames and IMU come from.
    seq = dataclasses.replace(seq, imu_t=bseq.imu_t, imu_w=seq.imu_w[:ni],
                              imu_a=seq.imu_a[:ni], cam_t=bseq.cam_t,
                              cam_files=seq.cam_files[:k_end])
    folder = run_euroc_sequence_scan(cfg, seq, device=dev)
    _zero(kernels)
    from_bag = run_euroc_sequence_scan(cfg, bseq, device=dev)
    tail = kernels[TAIL_KERNEL].launches
    n = len(folder.timestamps)
    gap_bag = float(np.abs(from_bag.positions - folder.positions).max())
    ck = os.path.join(tmp, "session.npz")
    half = k0 + 1 + BAG_FRAMES // 2
    first = run_euroc_sequence_scan(cfg, seq, device=dev, max_frames=half,
                                    checkpoint_path=ck)
    second = run_euroc_sequence_scan(cfg, seq, device=dev, resume_from=ck)
    both = np.concatenate([first.positions, second.positions])
    gap_res = float(np.abs(both - folder.positions).max())
    print(f"rosbag of the first {n} frames ({os.path.getsize(bag) >> 20} MiB, "
          f"uncompressed): max position gap to the folder replay "
          f"{gap_bag:.3e} m (limit {REPLAY_GAP_M}), stamps within "
          f"{dt:.1e} s of the folder's, K5 launches {tail}; saved after "
          f"{len(first.timestamps)} frames and resumed: max position gap to "
          f"the uninterrupted run {gap_res:.3e} m (limit {REPLAY_GAP_M})",
          flush=True)
    if not (len(from_bag.timestamps) == n == BAG_FRAMES and tail == n
            and np.array_equal(from_bag.timestamps, folder.timestamps)
            and gap_bag <= REPLAY_GAP_M):
        raise AssertionError("the bag replay and the folder replay disagree")
    if not (len(first.timestamps) + len(second.timestamps) == n
            and np.array_equal(np.concatenate([first.timestamps,
                                               second.timestamps]),
                               folder.timestamps)
            and gap_res <= REPLAY_GAP_M):
        raise AssertionError("the resumed run is not the uninterrupted run")


def _same(a, b):
    """(bitwise equal, largest absolute gap) of two tensors or arrays."""
    a, b = (torch.as_tensor(np.asarray(x)).double() for x in (a, b))
    return bool(torch.equal(a, b)), float((a - b).abs().max()) if a.numel() \
        else 0.0


def graph_vs_eager_phase(dev, sim, sim_f, kernels) -> None:
    """The one-dispatch frame against the eager frame loop, in one run.

    The feature path over its first GRAPH_FEATURE_FRAMES frames: the
    sequence scan eagerly, then graphed with each of UNROLLS frames a
    graph (its first run
    captures; the best of two more is timed), every output of every frame
    compared.  Images -> poses, CLAHE on, over GRAPH_IMG_FRAMES frames:
    eagerly, then through the graphed fused chunk scan, the front-end and
    back-end chunk scans (timing split) and ImagePipeline.  Each run ends
    in a readback; each checks every kernel's launches."""
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.bench import feature_bundles
    from rvio_tpu_torch.runtime import (ImagePipeline, bundle_imu,
                                        run_rendered_sequence_scan)
    from rvio_tpu_torch.runtime.step import _sequence_scan

    cfg = RVIOConfig()
    state0, bundles, _ = feature_bundles(cfg, sim, dev)
    bundles = _head(bundles, GRAPH_FEATURE_FRAMES)
    T = int(bundles.imu.w.shape[0])
    want = dict.fromkeys(kernels, 0)
    want.update(dict.fromkeys(FILTER_KERNELS, T))

    def timed(run):
        _zero(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = run(state0, bundles)
        host = {k: v.cpu() for k, v in out.items()}
        wall = time.perf_counter() - t0
        launches = _launches(kernels)
        if launches != want:
            raise AssertionError(f"sequence scan launches {launches}, "
                                 f"expected {want}")
        return wall, host

    with eager_frames():
        eager_run = _sequence_scan(cfg, dev, torch.float32, 1)
    timed(eager_run)                                          # warm-up
    e_wall, e_out = min((timed(eager_run) for _ in range(2)),
                        key=lambda r: r[0])
    print(f"graph vs eager, feature path: {T} frames eagerly in "
          f"{e_wall:.3f} s = {T / e_wall:.1f} frames/s "
          f"({e_wall * 1e3 / T:.3f} ms/frame)", flush=True)
    for U in UNROLLS:
        run = _sequence_scan(cfg, dev, torch.float32, U)
        first_wall, _ = timed(run)
        g_wall, g_out = min((timed(run) for _ in range(2)),
                            key=lambda r: r[0])
        caps = [(c["frames"], round(c["seconds"], 4), c["reserved_growth_bytes"])
                for c in run.frame_scan.captures]
        differ = {}
        for k, v in e_out.items():
            exact, gap = _same(v, g_out[k])
            if not exact:
                differ[k] = gap
        print(f"graph vs eager, feature path, U {U}: graphed {T / g_wall:.1f} "
              f"frames/s ({g_wall * 1e3 / T:.3f} ms/frame) against eager "
              f"{T / e_wall:.1f}; first run {first_wall:.3f} s, captures "
              f"{caps} (frames, s, reserved growth bytes); every output of every "
              f"frame "
              f"{'bitwise equal' if not differ else f'equal but {differ}'}",
              flush=True)
        if differ and not differ.get("p_Gk", 0.0) < GRAPH_GAP_M:
            raise AssertionError(f"graphed feature path differs: {differ}")

    cfg = image_config(True)
    k0 = _init_frame(cfg, sim_f.imu_t, sim_f.imu_w, sim_f.imu_a, sim_f.frame_t)
    k_end = k0 + 1 + GRAPH_IMG_FRAMES
    n = GRAPH_IMG_FRAMES

    def image_run(label, **kw):
        _zero(kernels)
        res = run_rendered_sequence_scan(cfg, sim_f, device=dev,
                                         max_frames=k_end, **kw)
        launches = _launches(kernels)
        if launches != expected_launches(n) or len(res.timestamps) != n:
            raise AssertionError(f"{label}: launches {launches}, expected "
                                 f"{expected_launches(n)}")
        return res

    with eager_frames():
        run_rendered_sequence_scan(cfg, sim_f, device=dev, max_frames=k0 + 9)
        eager = image_run("eager image path")
    runs = {"fused chunk scan": image_run("fused chunk scan"),
            "front + back chunk scans": image_run("front + back",
                                                  timing_split=True)}
    frames = {k: _render_u8(cfg, sim_f, k) for k in range(k_end)}
    groups = bundle_imu(sim_f.imu_t, sim_f.imu_w, sim_f.imu_a, sim_f.frame_t)
    pipe = ImagePipeline(cfg, device=dev)
    _zero(kernels)
    rows, t_pipe = [], 0.0
    for k in range(k_end):
        t0 = time.perf_counter()
        out = pipe.process_device(sim_f.frame_t[k], frames[k], *groups[k])
        if out is not None:
            rows.append(pipe.unpack(out))
        t_pipe += time.perf_counter() - t0
    if _launches(kernels) != expected_launches(n) or len(rows) != n:
        raise AssertionError(f"ImagePipeline launches {_launches(kernels)}")

    def loop_ms(res):
        return float((res.frontend_ms + res.backend_ms).mean())

    print(f"graph vs eager, images -> poses (CLAHE on), {n} frames: eager "
          f"frame loop {loop_ms(eager):.3f} ms/frame "
          f"({1e3 / loop_ms(eager):.1f} frames/s)", flush=True)
    for label, res in runs.items():
        agree = float((res.active_slots == eager.active_slots).mean())
        exact, gap = _same(res.positions, eager.positions)
        exact = exact and _same(res.quaternions, eager.quaternions)[0]
        print(f"graph vs eager, {label}: {loop_ms(res):.3f} ms/frame "
              f"({1e3 / loop_ms(res):.1f} frames/s; front-end "
              f"{res.frontend_ms.mean():.3f}, back-end "
              f"{res.backend_ms.mean():.3f}); active slots agree on "
              f"{agree:.4%} of slot-frames, poses "
              f"{'bitwise equal' if exact else f'max gap {gap:.3e} m'}",
              flush=True)
        if not (np.array_equal(res.timestamps, eager.timestamps)
                and agree == 1.0 and gap <= GRAPH_GAP_M):
            raise AssertionError(f"graphed {label} and eager disagree")
    p = np.asarray([r["p_Gk"] for r in rows])
    exact, gap = _same(p, eager.positions)
    print(f"graph vs eager, ImagePipeline: {n} frames in {t_pipe:.3f} s = "
          f"{n / t_pipe:.1f} frames/s frame in to pose out ({k0 + 1} "
          f"frames before it fed to the init gate); positions "
          f"{'bitwise equal' if exact else f'max gap {gap:.3e} m'} to the "
          f"eager scan", flush=True)
    if not gap <= GRAPH_GAP_M:
        raise AssertionError("graphed ImagePipeline and eager disagree")


def _cut(bundles, n: int):
    """The first n frames of (S, T, ...) bundles."""
    from rvio_tpu_torch.state.filter_state import map_fields
    return dataclasses.replace(
        bundles, imu=map_fields(lambda x: x[:, :n], bundles.imu),
        batch=map_fields(lambda x: x[:, :n], bundles.batch))


def batched_phase(dev, sim, kernels) -> dict:
    """The segment-batched filter: BATCH copies of the feature workload
    through make_batched_sequence_scan (each frame of the batch one graph
    replay), timed (the first run captures; the best of two more, each
    ending in a readback of every frame's pose), every filter kernel once
    a batched frame, every row bitwise the same, row 0 against the graphed
    single scan.  Returns each filter kernel's launches."""
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.bench import batch_copies, feature_bundles
    from rvio_tpu_torch.runtime import (make_batched_sequence_scan,
                                        make_sequence_scan)
    from rvio_tpu_torch.state import stack_states
    cfg = RVIOConfig()
    state0, bundles, _ = feature_bundles(cfg, sim, dev)
    T = int(bundles.imu.w.shape[0])
    states, bb = stack_states([state0] * BATCH), batch_copies(bundles, BATCH)
    want = dict.fromkeys(kernels, 0)
    want.update(dict.fromkeys(FILTER_KERNELS, T))
    run = make_batched_sequence_scan(cfg, dev)

    def timed():
        _zero(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = run(states, bb)
        float(out["p_Gk"].sum() + out["q_kG"].sum())   # every frame's pose
        wall = time.perf_counter() - t0
        launches = _launches(kernels)
        if launches != want:
            raise AssertionError(f"batched scan launches {launches}, "
                                 f"expected {want} (one a batched frame)")
        return wall, out

    first_wall, _ = timed()
    wall, out = min((timed() for _ in range(2)), key=lambda r: r[0])
    differ = sorted(k for k, v in out.items()
                    if not all(torch.equal(v[0], v[b]) for b in range(BATCH)))
    _, one = make_sequence_scan(cfg, dev)(state0, bundles)
    p0, p1 = (x.double().cpu().numpy() for x in (out["p_Gk"][0], one["p_Gk"]))
    dp = float(np.abs(p0 - p1).max())
    dq = rotation_gap(out["q_kG"][0].cpu().numpy(), one["q_kG"].cpu().numpy())
    caps = [(c["frames"], round(c["seconds"], 4), c["reserved_growth_bytes"])
            for c in run.frame_scan.captures]
    print(f"batched filter, B {BATCH} copies of the feature workload: "
          f"{BATCH * T} frames in {wall:.3f} s = {BATCH * T / wall:.1f} "
          f"frames/s, {wall * 1e3 / T:.3f} ms a batched frame ({T} of them; "
          f"first run {first_wall:.3f} s), captures {caps} (frames, s, reserved "
          f"growth bytes); launches {dict((k, want[k]) for k in FILTER_KERNELS)}"
          f" (one a batched frame); rows "
          f"{'bitwise equal' if not differ else f'differ in {differ}'}; row "
          f"0 against the graphed single scan: max position gap {dp:.3e} m "
          f"(limit {BATCH_GAP_POS_M}), max attitude gap {dq:.3e} rad (limit "
          f"{BATCH_GAP_ROT_RAD})", flush=True)
    if differ:
        raise AssertionError(f"batched rows differ: {differ}")
    if not (dp < BATCH_GAP_POS_M and dq < BATCH_GAP_ROT_RAD):
        raise AssertionError("batched row 0 and the single scan disagree")
    return {k: want[k] for k in FILTER_KERNELS}


def capture_batch_inputs(dev, sim):
    """The filter kernels' inputs at frame BATCH_FRAME of BATCH distinct
    segments of the workload: segment_plan's segments (segment 0 from the
    static init, the others warm starts) through the masked segment scan,
    eagerly on the card, recording each kernel wrapper's last call."""
    from unittest import mock

    import rvio_tpu_torch.filter.propagation as propagation
    import rvio_tpu_torch.filter.update as update
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.bench import feature_bundles
    from rvio_tpu_torch.parallel import make_masked_segment_scan, warm_segments
    cfg = RVIOConfig()
    state0, bundles, _ = feature_bundles(cfg, sim, dev)
    cfg_w, _, states, sb, sok, _ = warm_segments(
        cfg, state0, bundles, BATCH, BATCH_WARMUP, torch.float32, dev)
    captured = {}

    def recorder(name, fn):
        def record(*call_args, **kw):
            captured[name] = [a.detach().clone() if torch.is_tensor(a) else a
                              for a in call_args]
            return fn(*call_args, **kw)
        return record

    n = BATCH_FRAME + 1
    with eager_frames(), \
            mock.patch.object(propagation, "propagate_block", recorder(
                "propagate_block", propagation.propagate_block)), \
            contextlib.ExitStack() as stack:
        for name in ("lm_triangulate", "jac_project", "batched_quadform",
                     "ekf_tail"):
            stack.enter_context(mock.patch.object(
                update, name, recorder(name, getattr(update, name))))
        make_masked_segment_scan(cfg_w, dev)(states, _cut(sb, n), sok[:, :n])
    torch.cuda.synchronize()
    return cfg, captured


def batch_kernel_phase(dev, sim, records, launches):
    """K1-K5 at the batched filter's shapes on frame BATCH_FRAME of BATCH
    segments (:func:`capture_batch_inputs`), each against its plain
    version with its own bound (:func:`measure`); their rows join the
    kernels line as ``<name>@B16`` with the batched phase's launches.  K5
    also at B = 1 and 4 (its first systems), and its clusters' residency.
    Returns the captured inputs."""
    from rvio_tpu_torch.ops import ekf_tail as k5
    from rvio_tpu_torch.ops.checks import (ekf_tail_case, jac_case, lm_case,
                                           propagate_case, quadform_case)
    t0 = time.perf_counter()
    cfg, cap = capture_batch_inputs(dev, sim)
    print(f"batch checks: frame {BATCH_FRAME} of {BATCH} segments "
          f"(warm-up {BATCH_WARMUP}) captured eagerly on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def host(xs):
        return [x.cpu().numpy() if torch.is_tensor(x) else x for x in xs]

    for x in host(cap["propagate_block"]) + host(cap["ekf_tail"]):
        if not np.isfinite(x).all():
            raise AssertionError("the captured batch inputs are not finite")
    z, Rc, tc, tl = cap["lm_triangulate"]
    C, b, P, sig2 = host(cap["ekf_tail"])
    label = f" (frame {BATCH_FRAME} of {BATCH} segments)"
    checks = [
        propagate_case(cfg, dev, host(cap["propagate_block"]), what=label),
        lm_case(dev, z, Rc, tc, tl, cfg.camera.sigma_image, what=label),
        jac_case(dev, cap["jac_project"], what=label),
        quadform_case(dev, *cap["batched_quadform"], what=label),
        ekf_tail_case(dev, C, b, P, sig2, tol=EKF_TAIL_FRAME_TOL,
                      what=f"frame {BATCH_FRAME} of {BATCH} segments")]
    for chk in checks:
        rec = measure(chk, f"@B{BATCH}{label}")
        rec.update(name=f"{chk.name}@B{BATCH}", batch=BATCH,
                   launches=launches[chk.name])
        records.append((chk.kernel, rec))
        if chk.name == TAIL_KERNEL:
            n = C.shape[-1]
            for nb in K5_BATCHES:
                args = tuple(a[:nb].contiguous() for a in chk.args)
                ms = device_ms(lambda: chk.kernel(*args), reps=200)
                print(f"kernel {TAIL_KERNEL} at B {nb}: {ms * 1e3:.2f} us a "
                      f"launch on the device ({nb * 8} CTAs)", flush=True)
                rec[f"ms_b{nb}"] = ms
            fit = k5.max_active_clusters(BATCH, n, dev)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            print(f"kernel {TAIL_KERNEL}: cudaOccupancyMaxActiveClusters "
                  f"{fit} clusters of 8 CTAs at n {n} ({sms} SMs): B "
                  f"{BATCH} runs in {-(-BATCH // max(fit, 1))} wave(s)",
                  flush=True)
            rec["max_active_clusters"] = fit
    return cap


def warm_split_phase(dev, kernels):
    """The warm split on the card in f32: tests/test_handoff.py
    TestWarmHandoff's case through run_segments_warm against the unsplit
    graphed scan, with that test's gates; then the same split with the
    last segment's body stripped of its features, so the repair pass runs
    (its B = 1 scan, a capture of its own).  Returns the case (state0,
    bundles, gt, the unsplit positions ``full`` and ATE ``ate_full``) and
    the first split's stitched positions and info."""
    from rvio_tpu_torch import config as tconfig
    from rvio_tpu_torch.bench import feature_bundles
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.eval.ate import ate_rmse
    from rvio_tpu_torch.parallel import run_segments_warm, segment_plan
    from rvio_tpu_torch.runtime import make_sequence_scan
    cfg = tconfig.RVIOConfig(
        imu=tconfig.ImuConfig(rate_hz=100.0),
        camera=tconfig.CameraConfig(fps=10.0),
        tracker=tconfig.TrackerConfig(num_features=24, max_tracking_length=6,
                                      min_tracking_length=3),
        tpu=tconfig.TpuConfig(imu_block=16))
    t0 = time.perf_counter()
    sim = simulate_sequence(cfg, duration=WARM_DURATION_S, static_time=1.0,
                            seed=WARM_SEED, meas_noise=5e-4, imu_noise=True)
    state0, bundles, idx0 = feature_bundles(cfg, sim, dev)
    T = int(bundles.imu.w.shape[0])
    S, W = WARM_SEGMENTS, WARM_WARMUP
    _, ok_plan, Bl = segment_plan(T, S, W)
    gt = sim.gt_p[idx0:]
    print(f"warm split: {WARM_DURATION_S:.0f} s simulated, {T} frames "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    _zero(kernels)
    t0 = time.perf_counter()
    _, out = make_sequence_scan(cfg, dev)(state0, bundles)
    full = out["p_Gk"].double().cpu().numpy()
    wall_full = time.perf_counter() - t0
    ate_full = ate_rmse(full, gt)

    def split(bd):
        _zero(kernels)
        t0 = time.perf_counter()
        res = run_segments_warm(cfg, state0, bd, S, W, device=dev)
        wall = time.perf_counter() - t0
        repaired = res[2]["repaired_segments"]
        want = dict.fromkeys(kernels, 0)
        want.update(dict.fromkeys(FILTER_KERNELS,
                                  (W + Bl) * (1 + len(repaired))))
        if _launches(kernels) != want:
            raise AssertionError(f"warm split launches {_launches(kernels)},"
                                 f" expected {want}")
        return res, wall

    (stitched, outs, info), wall = split(bundles)
    ate_split = ate_rmse(stitched, gt)
    dev_max = float(np.linalg.norm(stitched - full, axis=1).max())
    ng, ok = outs["n_good"].cpu().numpy(), outs["ok"].cpu().numpy()
    ng_ok = [float(ng[s][ok[s]].mean()) for s in range(S)]
    ng_body = [float(ng[s, W:][ok[s, W:]].mean()) for s in range(S)]
    boots = ["static" if d is None else "fallback" if "rejected" in d
             else f"bootstrap sigma_v {d['sigma_v']:.3f}"
             for d in info["bootstrap_diags"]]
    caps = [(c["frames"], round(c["seconds"], 4), c["reserved_growth_bytes"])
            for c in info["scan"].frame_scan.captures]
    print(f"warm split, f32, {S} segments of {Bl} frames after a warm-up "
          f"of {W} (the small config): unsplit ATE {ate_full:.4f} m "
          f"({T} frames in {wall_full:.2f} s), split ATE {ate_split:.4f} m "
          f"(limit {ate_full + WARM_ATE_MARGIN_M:.4f}), max split-vs-unsplit "
          f"deviation {dev_max:.4f} m (limit {WARM_MAX_DEV_M}), n_good mean "
          f"a segment {[round(x, 2) for x in ng_ok]} over its frames, "
          f"{[round(x, 2) for x in ng_body]} over its body (limit "
          f"{WARM_NGOOD_MIN}), repaired segments {info['repaired_segments']},"
          f" starts {boots}; {S * (W + Bl)} segment-frames in {wall:.2f} s "
          f"(bootstrap on the host included), captures {caps} (frames, s, "
          f"reserved growth bytes)", flush=True)
    if not (ate_split <= ate_full + WARM_ATE_MARGIN_M
            and dev_max < WARM_MAX_DEV_M
            and min(ng_ok) > WARM_NGOOD_MIN and min(ng_body) > WARM_NGOOD_MIN
            and np.isfinite(stitched).all()
            and stitched.shape == full.shape):
        raise AssertionError("the warm split misses a gate")

    valid = bundles.batch.valid.clone()
    valid[(S - 1) * Bl:] = False
    stripped = dataclasses.replace(bundles, batch=dataclasses.replace(
        bundles.batch, valid=valid))
    (_, _, info2), wall2 = split(stripped)
    if S - 1 not in info2["repaired_segments"] or info2["repair_scan"] is None:
        raise AssertionError(f"the stripped segment was not repaired: "
                             f"{info2['repaired_segments']}")
    caps = [(c["frames"], round(c["seconds"], 4), c["reserved_growth_bytes"])
            for c in info2["repair_scan"].frame_scan.captures]
    print(f"warm split, segment {S - 1}'s body stripped of its features: "
          f"repaired segments {info2['repaired_segments']} in {wall2:.2f} s; "
          f"the repair's B = 1 scan captures {caps} (frames, s, reserved "
          f"growth bytes)", flush=True)
    return dict(state0=state0, bundles=bundles, stitched=stitched,
                info=info, gt=gt, full=full, ate_full=ate_full)


def set_sequences():
    """The set replay's sequences at ``RVIOConfig()``: (sims, sequences),
    each sequence's frames rendered once (WRITE_THREADS threads) and held
    in memory as a ``BagSequence``."""
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.dataio.rosbag import BagSequence
    cfg = RVIOConfig()
    sims, seqs = [], []
    with ThreadPoolExecutor(WRITE_THREADS) as pool:
        for seed, dur in zip(SET_SEEDS, SET_DURATIONS_S):
            sim = simulate_sequence(cfg, duration=dur, static_time=1.5,
                                    ramp_time=2.0, seed=seed,
                                    n_landmarks=2000, motion_scale=0.8,
                                    meas_noise=0.001, imu_noise=True)
            imgs = np.stack(list(pool.map(lambda k, s=sim: _render_u8(
                cfg, s, k), range(len(sim.frame_t)))))
            sims.append(sim)
            seqs.append(BagSequence(imu_t=sim.imu_t, imu_w=sim.imu_w,
                                    imu_a=sim.imu_a, cam_t=sim.frame_t,
                                    images=imgs))
    return sims, seqs


def set_replay_phase(dev, sims, seqs, kernels) -> dict:
    """The set replay, this slice's main path: the SET_B sequences through
    ``run_sequence_set`` on the card (each frame of the set one replay of
    the batched image frame), then each through ``run_euroc_sequence_scan``
    with the same seed: frames/s of both, each sequence's ATE, every
    kernel's launches (one a batched frame, plus each sequence's init
    frame), the largest set-vs-single gap and the share of slot-frames
    that agree; then one sequence SET_B times, whose rows must be bitwise
    equal.  Returns each kernel's launches in the set run."""
    from unittest import mock

    import rvio_tpu_torch.runtime.replay_set as replay_set
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.eval.ate import ate_rmse
    from rvio_tpu_torch.runtime import run_euroc_sequence_scan
    cfg = RVIOConfig()
    scans = []
    build = replay_set.make_batched_image_chunk_scan

    def kept(*args, **kw):
        scans.append(build(*args, **kw))
        return scans[-1]

    def run_set(seq_list):
        _zero(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(replay_set, "make_batched_image_chunk_scan",
                               kept):
            out = replay_set.run_sequence_set(cfg, seq_list, device=dev)
        return out, time.perf_counter() - t0, _launches(kernels)

    run_set(seqs)                          # warm-up: handles, the build
    res, wall, launches = run_set(seqs)
    n_frames = [len(r.timestamps) for r in res]
    L = max(len(s.cam_t) - 1 - _init_frame(cfg, s.imu_t, s.imu_w, s.imu_a,
                                           s.cam_t) for s in seqs)
    want = dict.fromkeys(kernels, 0)
    want.update(dict.fromkeys(FILTER_KERNELS, L))
    want.update(gather_tiles=9 * L + SET_B, lk_level=4 * L,
                subpix_refine=L + SET_B, shi_tomasi_nms=L + SET_B,
                clahe_luts=L + SET_B, clahe_apply=L + SET_B)
    if launches != want:
        raise AssertionError(f"set replay launches {launches}, expected "
                             f"{want} (one a batched frame and each "
                             f"sequence's init frame)")
    singles, walls = [], []
    for s in seqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        singles.append(run_euroc_sequence_scan(cfg, s, device=dev))
        walls.append(time.perf_counter() - t0)
    ates, dps, dqs, agree = [], [], [], []
    for sim, r, one in zip(sims, res, singles):
        if not np.array_equal(r.timestamps, one.timestamps):
            raise AssertionError("a set sequence filtered other frames than "
                                 "its single replay")
        idx = np.searchsorted(sim.frame_t, r.timestamps)
        ates.append(ate_rmse(r.positions, sim.gt_p[idx]))
        dps.append(float(np.abs(r.positions - one.positions).max()))
        dqs.append(rotation_gap(r.quaternions, one.quaternions))
        agree.append(float((r.active_slots == one.active_slots).mean()))
        if not (np.isfinite(r.positions).all()
                and r.positions.shape == (len(r.timestamps), 3)):
            raise AssertionError("non-finite or misshapen set trajectory")
    caps = [(c["frames"], round(c["seconds"], 4), c["reserved_growth_bytes"])
            for c in scans[-1].frame_scan.captures]
    print(f"set replay, {SET_B} sequences ({n_frames} tracked frames, "
          f"{L} batched frames): {sum(n_frames)} frames in {wall:.3f} s = "
          f"{sum(n_frames) / wall:.1f} frames/s (init gates and frames "
          f"included); single replays {sum(n_frames)} frames in "
          f"{sum(walls):.3f} s = {sum(n_frames) / sum(walls):.1f} frames/s; "
          f"ATE {[round(a, 4) for a in ates]} m (limit {ATE_LIMIT_M}); "
          f"set vs single: max position gap {[f'{x:.3e}' for x in dps]} m "
          f"(limit {SET_GAP_POS_M}), max attitude gap "
          f"{[f'{x:.3e}' for x in dqs]} rad, slot-frames agreeing "
          f"{[round(x, 5) for x in agree]} (limit {SET_ACTIVE_AGREE}); "
          f"captures {caps} (frames, s, reserved growth bytes); kernel launches "
          f"a batched frame {dict((k, round(v / L, 3)) for k, v in launches.items() if v)}",
          flush=True)
    if not max(ates) < ATE_LIMIT_M:
        raise AssertionError(f"a set sequence's ATE is over {ATE_LIMIT_M} m")
    if not (max(dps) < SET_GAP_POS_M and min(agree) >= SET_ACTIVE_AGREE):
        raise AssertionError("a set sequence and its single replay disagree")

    copies, wall_c, _ = run_set([seqs[0]] * SET_B)
    differ = [k for k in ("positions", "quaternions", "active_slots",
                          "n_good")
              if not all(np.array_equal(getattr(copies[0], k),
                                        getattr(c, k)) for c in copies)]
    m = sum(len(c.timestamps) for c in copies)
    print(f"set replay of {SET_B} copies of sequence 0: {m} frames in "
          f"{wall_c:.3f} s = {m / wall_c:.1f} frames/s; rows "
          f"{'bitwise equal' if not differ else f'differ in {differ}'}",
          flush=True)
    if differ:
        raise AssertionError(f"the copies' rows differ: {differ}")
    return launches


def batch_image_kernel_phase(dev, sims, seqs, records, launches) -> None:
    """K6, K8, K9, K10, K11 and K13 at the batched tracker's shapes: the
    inputs of tracked frame KLT_FRAME of each of the set's sequences
    (:func:`capture_klt_frame`, one segment each), one launch for the SET_B
    segments against the plain version on the same inputs, segment by
    segment (K8 at every pyramid level, each segment with its own T,
    bitwise against a single launch a segment, and against its plain
    version on the features well posed in f32, ops/checks.py
    ``lk_well_posed``); rows ``<kernel>@B4`` of the kernels line with the
    set replay's launches."""
    from rvio_tpu_torch.ops.checks import (batch_case, clahe_apply_case,
                                           clahe_luts_case, lk_case,
                                           shi_nms_case, subpix_case,
                                           tile_case)
    from rvio_tpu_torch.ops.clahe import clahe_luts_plain
    t0 = time.perf_counter()
    caps = [capture_klt_frame(dev, sim, frame=KLT_FRAME, seq=seq)
            for sim, seq in zip(sims, seqs)]
    print(f"batch image checks: tracked frame {KLT_FRAME} of {SET_B} "
          f"sequences captured on the card in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    label = f" (frame {KLT_FRAME} of {SET_B} sequences)"
    levels = len(caps[0][0])
    for i in range(levels):
        lvl = caps[0][0][i][0]
        singles = [lk_case(dev, c[0][i][3], c[0][i][4], well_posed=True)
                   for c in caps]
        T = [int(c.trips.max(initial=0)) for c in singles]
        print(f"lk_level@B{SET_B}{label}, level {lvl}: T {T} by segment",
              flush=True)
        if lvl == 0:
            k8 = singles                   # the row's case
            continue
        chk = batch_case(singles, what=f"{label}, level {lvl}")
        err = chk.check()
        print(f"kernel lk_level@B{SET_B}{label}, level {lvl}: err "
              f"{err:.3e}, alive agree {chk.info['alive_agree']}, set aside "
              f"(not well posed in f32) {chk.info['set_aside']}, bitwise "
              f"with a single launch a segment", flush=True)
    top = [c[0][levels - 1] for c in caps]        # level 0
    eq = [c[1].cpu() for c in caps]
    checks = [
        batch_case([tile_case(dev, *t[2]) for t in top], label),
        batch_case(k8, label),
        batch_case([subpix_case(dev, *c[2][0], **c[2][1]) for c in caps],
                   label),
        batch_case([clahe_luts_case(dev, x) for x in eq], label),
        batch_case([clahe_apply_case(dev, x, clahe_luts_plain(x, 3.0, 5), 5)
                    for x in eq], label),
        batch_case([shi_nms_case(dev, c[3]) for c in caps], label)]
    for chk in checks:
        rec = measure(chk, f"@B{SET_B}{label}")
        rec.update(name=f"{chk.name}@B{SET_B}", batch=SET_B,
                   launches=launches[chk.name])
        records.append((chk.kernel, rec))


def _arrays(prefix, obj) -> dict:
    """The tensors of a dataclass as host arrays keyed ``prefix + field``."""
    return {f"{prefix}{f.name}": getattr(obj, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(obj)}


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def mesh_quarters(dev, sim):
    """The feature workload's MESH_SEGMENTS quarters at ``RVIOConfig()``:
    segment s takes frames [s Q, (s + 1) Q) and starts from the graphed
    single scan's state after s Q frames (a checkpoint continuation).
    Returns (cfg, stacked states, (S, Q, ...) bundles)."""
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.bench import feature_bundles
    from rvio_tpu_torch.runtime import FrameBundle, make_sequence_scan
    from rvio_tpu_torch.state import stack_states
    from rvio_tpu_torch.state.filter_state import map_fields
    cfg = RVIOConfig()
    state0, bundles, _ = feature_bundles(cfg, sim, dev)
    Q = int(bundles.imu.w.shape[0]) // MESH_SEGMENTS
    run = make_sequence_scan(cfg, dev)
    states, parts = [], []
    for q in range(MESH_SEGMENTS):
        if q == 0:
            states.append(state0)
        else:
            states.append(run(state0, FrameBundle(
                imu=map_fields(lambda x: x[:q * Q], bundles.imu),
                batch=map_fields(lambda x: x[:q * Q], bundles.batch)))[0])
        parts.append(FrameBundle(
            imu=map_fields(lambda x: x[q * Q:(q + 1) * Q], bundles.imu),
            batch=map_fields(lambda x: x[q * Q:(q + 1) * Q], bundles.batch)))
    stacked = FrameBundle(
        imu=dataclasses.replace(parts[0].imu, **{
            f.name: torch.stack([getattr(p.imu, f.name) for p in parts])
            for f in dataclasses.fields(parts[0].imu)}),
        batch=dataclasses.replace(parts[0].batch, **{
            f.name: torch.stack([getattr(p.batch, f.name) for p in parts])
            for f in dataclasses.fields(parts[0].batch)}))
    return cfg, stack_states(states), stacked


def mesh_chunk(dev, sim):
    """One MESH_KLT_FRAMES-frame chunk of images -> poses at ``RVIOConfig()``
    (CLAHE on): the init frame's image and filter state (the init gate on
    the card) and the next frames' chunk with the run's draws."""
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.runtime import bundle_imu
    from rvio_tpu_torch.runtime.image_driver import (_find_init_frame,
                                                     _imu_chunk_host,
                                                     uniform_table)
    cfg = RVIOConfig()
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    st0, k0 = _find_init_frame(cfg, groups, len(sim.frame_t), torch.float32,
                               dev)
    ks = range(k0 + 1, k0 + 1 + MESH_KLT_FRAMES)
    with ThreadPoolExecutor(WRITE_THREADS) as ex:
        images = list(ex.map(lambda k: _render_u8(cfg, sim, k),
                             range(k0, ks[-1] + 1)))
    chunk = {**_imu_chunk_host(groups, ks, cfg.tpu.imu_block),
             "image": np.stack(images[1:]),
             "u": uniform_table(0, MESH_KLT_FRAMES,
                                cfg.tracker.num_features).numpy()}
    return cfg, images[0], st0, chunk


def all_reduce_ms(dev, nbytes: int, reps: int = 200) -> float:
    """Time of one NCCL ``all_reduce`` of ``nbytes`` of f32 on the card
    in the current (one-rank) process group: CUDA events around ``reps``
    calls."""
    import torch.distributed as dist
    buf = torch.zeros(nbytes // 4, dtype=torch.float32, device=dev)
    for _ in range(3):
        dist.all_reduce(buf)

    def run():
        for _ in range(reps):
            dist.all_reduce(buf)

    return _events_ms(run, reps)


def mesh_phase(dev, sim, kernels, records, batch_cap, klt_cap,
               warm) -> None:
    """The mesh layer (rvio_tpu_torch/parallel) on the card:

    - NCCL, one rank, in this process: ``make_parallel_sequence`` on a
      (1, 1) mesh over BATCH copies of the feature workload, bitwise the
      graphed batched scan (no collective of the port runs at (1, 1));
      the per-frame bytes of the feat ``all_reduce`` (Cholesky: C, b and
      the counts of each segment) and, a probe of its cost, an NCCL
      ``all_reduce`` of that size at world size 1;
    - two ranks on the card over gloo (scripts/torch_multiprocess_check.py,
      one launch, the kernels built here first): the workload's quarters
      with seg = 2 and with feat = 2 against the unsharded batched scan
      (frames/s of each beside it), the feat ranks' states bitwise equal,
      K2-K4 once a frame on each rank; ``run_segments_warm(mesh=)`` with
      seg = 2 against this run's ``mesh=None`` split (``warm``); the
      feat-split KLT through ``make_image_chunk_scan(mesh=)`` against the
      unsharded graphed chunk scan;
    - K2-K4 on a rank's rows (4 segments x F/2 lanes of frame BATCH_FRAME,
      from ``batch_cap``) and K6 and K8 on a rank's N/2 lanes (level 0 of
      tracked frame KLT_FRAME, from ``klt_cap``), each against its plain
      version: rows ``<kernel>@feat2`` of the kernels line, with the
      launches of rank 0 in the two-rank runs."""
    import torch.distributed as dist

    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.bench import batch_copies, feature_bundles
    from rvio_tpu_torch.frontend import make_tracker
    from rvio_tpu_torch.ops.checks import (jac_case, lk_case, lm_case,
                                           quadform_case, tile_case)
    from rvio_tpu_torch.parallel import (make_mesh, make_parallel_sequence,
                                         shard_bundles, shard_states)
    from rvio_tpu_torch.runtime import (make_batched_sequence_scan,
                                        make_image_chunk_scan)
    from rvio_tpu_torch.runtime.graph import tree_leaves
    from rvio_tpu_torch.state import stack_states

    # ---- NCCL, world size 1, in this process ----
    cfg = RVIOConfig()
    state0, bundles, _ = feature_bundles(cfg, sim, dev)
    T = int(bundles.imu.w.shape[0])
    states, bb = stack_states([state0] * BATCH), batch_copies(bundles, BATCH)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(seg=1, feat=1)
            fs, out = make_batched_sequence_scan(cfg, dev)(states, bb)
            _zero(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pfs, pout = make_parallel_sequence(cfg, mesh)(
                shard_states(states, mesh), shard_bundles(bb, mesh))
            torch.cuda.synchronize()
            wall1 = time.perf_counter() - t0
            launches = _launches(kernels)
            M, B4 = cfg.window_size, MESH_SEGMENTS
            n_sums = 3 + 2 * int(cfg.tpu.adaptive_noise)
            frame_bytes = 4 * B4 * (36 * M * M + 6 * M + n_sums)
            ar_ms = all_reduce_ms(dev, frame_bytes)
        finally:
            dist.destroy_process_group()
    same = (all(torch.equal(pout[k], out[k]) for k in pout)
            and all(torch.equal(x, y) for x, y in
                    zip(tree_leaves(pfs), tree_leaves(fs), strict=True)))
    want = dict.fromkeys(kernels, 0)
    want.update(dict.fromkeys(FILTER_KERNELS, T))
    print(f"mesh, NCCL world size 1 (1, 1): make_parallel_sequence over "
          f"{BATCH} copies of the feature workload in {wall1:.3f} s "
          f"({BATCH * T / wall1:.1f} frames/s), "
          f"{'bitwise equal to' if same else 'DIFFERENT from'} the graphed "
          f"batched scan; launches {dict((k, launches[k]) for k in FILTER_KERNELS)};"
          f" the feat all_reduce a frame at {B4} segments a rank: "
          f"{frame_bytes} B (C, b and {n_sums} counts a segment, f32), "
          f"NCCL all_reduce of it at world size 1: {ar_ms * 1e3:.2f} us",
          flush=True)
    if not same or launches != want:
        raise AssertionError(f"the (1, 1) mesh scan is not the batched scan "
                             f"(launches {launches}, expected {want})")

    # ---- two ranks on the card over gloo ----
    t0 = time.perf_counter()
    qcfg, qstates, qb = mesh_quarters(dev, sim)
    Q = int(qb.imu.w.shape[1])
    wstate0, wbundles, wstitched = (warm[k] for k in
                                    ("state0", "bundles", "stitched"))
    ccfg, image0, cst0, chunk = mesh_chunk(dev, sim)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as tmp:
        inputs, outd = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(inputs)
        np.savez(os.path.join(inputs, "sequence.npz"), config="default",
                 dtype="float32", **_arrays("state.", qstates),
                 **_arrays("imu.", qb.imu), **_arrays("batch.", qb.batch))
        np.savez(os.path.join(inputs, "warm.npz"), config="small",
                 dtype="float32", segments=WARM_SEGMENTS, warmup=WARM_WARMUP,
                 **_arrays("state.", wstate0), **_arrays("imu.", wbundles.imu),
                 **_arrays("batch.", wbundles.batch))
        np.savez(os.path.join(inputs, "chunk.npz"), config="default",
                 dtype="float32", image0=image0, **_arrays("state.", cst0),
                 **{f"chunk.{k}": v for k, v in chunk.items()})
        print(f"mesh: inputs built in {time.perf_counter() - t0:.1f} s "
              f"({MESH_SEGMENTS} quarters of {Q} frames, the warm split's "
              f"case, a {MESH_KLT_FRAMES}-frame chunk)", flush=True)
        runs = ("sequence:2x1", "sequence:1x2", "warm:2x1", "chunk:1x2")
        cmd = [sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "scripts", "torch_multiprocess_check.py"),
            "--backend", "gloo", "--device", "cuda", "--world", "2",
            "--inputs", inputs, "--out", outd,
            "--timeout", str(MESH_TIMEOUT_S)]
        for r in runs:
            cmd += ["--run", r]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=MESH_TIMEOUT_S + 60)
        wall2 = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the two-rank check failed "
                                 f"({proc.returncode}):\n{proc.stdout[-3000:]}"
                                 f"\n{proc.stderr[-3000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        got = {r.replace(":", "-"): [dict(np.load(os.path.join(
            outd, f"{r.replace(':', '-')}.rank{i}.npz"))) for i in range(2)]
            for r in runs}
    print(f"mesh, two ranks on the card over gloo: {wall2:.1f} s for the "
          f"launch, start-up and {len(runs)} runs; runs (s by rank) "
          f"{ {k: [round(x, 3) for x in v['seconds']] for k, v in line['runs'].items()} }",
          flush=True)

    # the quarters: seg = 2 and feat = 2 against the unsharded batched scan
    run4 = make_batched_sequence_scan(qcfg, dev)
    run4(qstates, qb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qfs, qout = run4(qstates, qb)
    torch.cuda.synchronize()
    wall4 = time.perf_counter() - t0
    ref = {k: qout[k].cpu().numpy() for k in ("p_Gk", "q_kG", "n_good")}
    fps1 = MESH_SEGMENTS * Q / wall4
    for name in ("sequence-2x1", "sequence-1x2"):
        r0, r1 = got[name]
        secs = max(line["runs"][name]["seconds"])
        warm_s = max(float(r["warm_seconds"]) for r in (r0, r1))
        calls = [int(r["allreduce_calls"]) for r in (r0, r1)]
        feat = name.endswith("1x2")
        same = all(np.array_equal(r0[f"out.{k}"], ref[k]) for k in ref)
        dp = _gap(r0["out.p_Gk"], ref["p_Gk"])
        dq = max(rotation_gap(r0["out.q_kG"][s], ref["q_kG"][s])
                 for s in range(MESH_SEGMENTS))
        ranks_same = all(np.array_equal(r0[f"out.{k}"], r1[f"out.{k}"])
                         for k in ref)
        k24 = {k: [int(r[f"launches.{k}"]) for r in (r0, r1)]
               for k in ("lm_triangulate", "jac_project", "batched_quadform")}
        extra = ""
        if name == "sequence-1x2":
            states_same = all(np.array_equal(r0[k], r1[k]) for k in r0
                              if k.startswith("state."))
            extra = (f", the feat ranks' states "
                     f"{'bitwise equal' if states_same else 'DIFFER'}")
            if not states_same:
                raise AssertionError("the feat ranks' states differ")
        ar = (f"; all_reduce calls of the warm run by rank {calls}, "
              f"{int(r0['allreduce_bytes'])} B each, a gloo all_reduce of "
              f"that size on the card {float(r0['allreduce_ms']) * 1e3:.1f} "
              f"us" if feat else f"; all_reduce calls {calls}")
        print(f"mesh {name}: {MESH_SEGMENTS} x {Q} frames at "
              f"{MESH_SEGMENTS * Q / warm_s:.1f} frames/s warm (the slower "
              f"rank, {warm_s:.3f} s; the first call, building and capturing "
              f"included, {secs:.3f} s) against {fps1:.1f} for the "
              f"unsharded batched scan on one rank{ar}; "
              f"{'bitwise equal' if same else 'not bitwise'}"
              f" to it, max position gap {dp:.3e} m (limit {MESH_GAP_POS_M}),"
              f" attitude {dq:.3e} rad (limit {MESH_GAP_ROT_RAD}), n_good "
              f"{'equal' if np.array_equal(r0['out.n_good'], ref['n_good']) else 'differs'}"
              f"{'' if feat else ' (gated)'}"
              f", ranks' gathered outputs "
              f"{'bitwise equal' if ranks_same else 'DIFFER'}{extra}; K2-K4 "
              f"launches by rank {k24}", flush=True)
        n_good_same = np.array_equal(r0["out.n_good"], ref["n_good"])
        if not (dp < MESH_GAP_POS_M and dq < MESH_GAP_ROT_RAD and ranks_same
                and (feat or n_good_same)
                and all(v == [Q, Q] for v in k24.values())
                and calls == [Q if feat else 0] * 2):
            raise AssertionError(f"{name} misses a gate")

    # the warm split with seg = 2 against mesh=None: its gates, the same
    # repairs, and the gap to the mesh=None split
    from rvio_tpu_torch.eval.ate import ate_rmse
    w0, w1 = got["warm-2x1"]
    W = WARM_WARMUP
    dw = _gap(w0["stitched"], wstitched)
    ate = ate_rmse(w0["stitched"], warm["gt"])
    dev_max = float(np.linalg.norm(w0["stitched"] - warm["full"],
                                   axis=1).max())
    ng, okm = w0["out.n_good"], w0["out.ok"]
    ng_min = min(min(float(ng[s][okm[s]].mean()),
                     float(ng[s, W:][okm[s, W:]].mean()))
                 for s in range(WARM_SEGMENTS))
    repaired = [int(x) for x in w0["repaired"]]
    print(f"mesh warm-2x1: run_segments_warm(mesh=) over {WARM_SEGMENTS} "
          f"segments, {max(line['runs']['warm-2x1']['seconds']):.2f} s: ATE "
          f"{ate:.4f} m (limit {warm['ate_full'] + WARM_ATE_MARGIN_M:.4f}), "
          f"deviation from the unsplit run {dev_max:.4f} m (limit "
          f"{WARM_MAX_DEV_M}), least mean n_good {ng_min:.2f} (limit "
          f"{WARM_NGOOD_MIN}), repaired {repaired} against "
          f"{warm['info']['repaired_segments']} with mesh=None, max gap to "
          f"the mesh=None split {dw:.3e} m (limit {MESH_GAP_POS_M}), ranks "
          f"{'bitwise equal' if np.array_equal(w0['stitched'], w1['stitched']) else 'DIFFER'}",
          flush=True)
    if not (ate <= warm["ate_full"] + WARM_ATE_MARGIN_M
            and dev_max < WARM_MAX_DEV_M and ng_min > WARM_NGOOD_MIN
            and dw < MESH_GAP_POS_M
            and np.isfinite(w0["stitched"]).all()
            and np.array_equal(w0["stitched"], w1["stitched"])
            and repaired == warm["info"]["repaired_segments"]):
        raise AssertionError("the sharded warm split misses a gate")

    # the feat-split KLT against the unsharded graphed chunk scan
    init_fn, _ = make_tracker(ccfg, dev)
    ts0, _ = init_fn(torch.as_tensor(image0))
    scan = make_image_chunk_scan(ccfg, dev)
    tens = {k: torch.as_tensor(v, device=dev) for k, v in chunk.items()}
    tens = {k: v.float() if v.is_floating_point() else v
            for k, v in tens.items()}
    (ts, _), cout = scan((ts0, cst0), tens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan((ts0, cst0), tens)
    torch.cuda.synchronize()
    cwall = time.perf_counter() - t0
    c0, c1 = got["chunk-1x2"]
    act = cout["active"].cpu().numpy()
    agree = float((c0["out.active"] == act).mean())
    dp = _gap(c0["out.p_Gk"], cout["p_Gk"].cpu().numpy())
    dpos = _gap(np.where(act[-1][:, None], c0["ts.pos"], 0),
                np.where(act[-1][:, None], ts.pos.cpu().numpy(), 0))
    equal = (np.array_equal(c0["out.active"], act)
             and np.array_equal(c0["ts.pos"], ts.pos.cpu().numpy())
             and np.array_equal(c0["ts.hist"], ts.hist.cpu().numpy()))
    ranks_same = all(np.array_equal(c0[k], c1[k]) for k in c0
                     if k.startswith(("out.", "ts.")))
    calls = [int(r["allreduce_calls"]) for r in (c0, c1)]
    print(f"mesh chunk-1x2: the feat-split KLT over {MESH_KLT_FRAMES} frames "
          f"(eager: {max(float(r['warm_seconds']) for r in (c0, c1)):.3f} s "
          f"warm, {max(line['runs']['chunk-1x2']['seconds']):.2f} s the "
          f"first call; all_reduce calls by rank {calls}, "
          f"{int(c0['allreduce_bytes'])} B each, a gloo all_reduce of that "
          f"size on the card {float(c0['allreduce_ms']) * 1e3:.1f} us; the "
          f"unsharded graphed scan {MESH_KLT_FRAMES / cwall:.1f} frames/s "
          f"warm) against the unsharded graphed scan: "
          f"{'equal (pos, hist, active)' if equal else 'not equal'}, "
          f"slot-frames agreeing {agree:.4f} "
          f"({int((c0['out.active'] != act).sum())} of {act.size} differ), "
          f"max pose gap {dp:.3e} m, last frame's live positions "
          f"{dpos:.3e} px (limit {MESH_KLT_GAP_M} m on the poses), ranks "
          f"{'bitwise equal' if ranks_same else 'DIFFER'}; K8 launches by "
          f"rank {[int(r['launches.lk_level']) for r in (c0, c1)]}",
          flush=True)
    if not (equal and ranks_same and dp < MESH_KLT_GAP_M
            and agree >= IMG_CPU_ACTIVE_AGREE
            and calls == [MESH_KLT_FRAMES] * 2):
        raise AssertionError("the feat-split KLT misses a gate")

    # ---- the kernels on a rank's rows: <kernel>@feat2 ----
    F = cfg.tracker.max_update_features

    def shard(x):
        if not torch.is_tensor(x) or x.dim() == 0 or x.shape[0] != BATCH * F:
            return x
        y = x.reshape((BATCH, F) + tuple(x.shape[1:]))
        return y[:MESH_SEGMENTS, :F // 2].reshape(
            (MESH_SEGMENTS * (F // 2),) + tuple(x.shape[1:])).contiguous()

    label = (f" (frame {BATCH_FRAME} of {MESH_SEGMENTS} segments, F/2 = "
             f"{F // 2} lanes)")
    z, Rc, tc, tl = (shard(x) for x in batch_cap["lm_triangulate"][:4])
    lvl, tmpl, search, args, kw = klt_cap[-1]            # level 0
    half = len(args[5]) // 2
    klabel = f" (frame {KLT_FRAME}, level {lvl}, N/2 = {half} lanes)"
    checks = [
        (lm_case(dev, z, Rc, tc, tl, cfg.camera.sigma_image, what=label),
         "sequence-1x2", label),
        (jac_case(dev, [shard(x) for x in batch_cap["jac_project"]],
                  what=label), "sequence-1x2", label),
        (quadform_case(dev, *(shard(x) for x in
                              batch_cap["batched_quadform"]), what=label),
         "sequence-1x2", label),
        (tile_case(dev, search[0], search[1][:half], what=klabel),
         "chunk-1x2", klabel),
        (lk_case(dev, [a[:half] if torch.is_tensor(a) else a for a in args],
                 kw, what=klabel), "chunk-1x2", klabel)]
    for chk, run, what in checks:
        rec = measure(chk, f"@feat2{what}")
        rec.update(name=f"{chk.name}@feat2", feat=2,
                   launches=int(got[run][0][f"launches.{chk.name}"]))
        records.append((chk.kernel, rec))

def _head(bundles, n: int):
    """The first n frames of (T, ...) bundles."""
    from rvio_tpu_torch.state.filter_state import map_fields
    return dataclasses.replace(
        bundles, imu=map_fields(lambda x: x[:n], bundles.imu),
        batch=map_fields(lambda x: x[:n], bundles.batch))


def _pose_gaps(p, q, p_ref, q_ref):
    """Largest position (m) and attitude (rad) gaps of two pose runs."""
    return (float(np.abs(p - p_ref).max()),
            rotation_gap(q.reshape(-1, 4), q_ref.reshape(-1, 4)))


def qr_phase(dev, sim, kernels) -> dict:
    """QR compression in graphed frames (ROADMAP.md section 3): the feature
    workload with ``tpu.compression = "qr"`` through the graphed sequence
    scan over all its frames (ATE, every kernel but K5 once a frame: the
    QR route does not reach K5) and the graphed batched scan over QR_B
    copies of its first QR_FRAMES frames, each against the same frames run
    eagerly; a graphed QR frame's time against a Cholesky frame's, in
    turns.  Returns the record of the phase."""
    from rvio_tpu_torch.bench import batch_copies, bench_config, feature_bundles
    from rvio_tpu_torch.eval.ate import ate_rmse
    from rvio_tpu_torch.runtime import (make_batched_sequence_scan,
                                        make_sequence_scan)
    from rvio_tpu_torch.state import stack_states
    cfg = bench_config({"BENCH_COMPRESSION": "qr"})
    state0, bundles, idx0 = feature_bundles(cfg, sim, dev)
    n = int(bundles.imu.w.shape[0])
    runs = {"qr": make_sequence_scan(cfg, dev),
            "cholesky": make_sequence_scan(bench_config({}), dev)}
    first = {}
    for name, run in runs.items():          # capture, then steady runs
        t0 = time.perf_counter()
        run(state0, bundles)
        torch.cuda.synchronize()
        first[name] = time.perf_counter() - t0
    walls = {"qr": [], "cholesky": []}
    for name in ("qr", "cholesky", "cholesky", "qr"):
        _zero(kernels)
        t0 = time.perf_counter()
        _, out = runs[name](state0, bundles)
        float(out["p_Gk"].sum())
        walls[name].append(time.perf_counter() - t0)
        if name == "qr":
            launches = _launches(kernels)
            got = {k: out[k].cpu().numpy() for k in ("p_Gk", "q_kG")}
    want = dict.fromkeys(FILTER_KERNELS, n)
    want[TAIL_KERNEL] = 0
    if {k: launches[k] for k in FILTER_KERNELS} != want or any(
            v for k, v in launches.items() if k not in FILTER_KERNELS):
        raise AssertionError(f"QR path launches {launches}, expected {want}")
    ate = ate_rmse(got["p_Gk"], sim.gt_p[idx0:])
    ms = {k: min(v) / n * 1e3 for k, v in walls.items()}
    head = _head(bundles, QR_FRAMES)
    states = stack_states([state0] * QR_B)
    _, outb = make_batched_sequence_scan(cfg, dev)(
        states, batch_copies(head, QR_B))
    with eager_frames():
        _, ref = make_sequence_scan(cfg, dev)(state0, head)
        _, refb = make_batched_sequence_scan(cfg, dev)(
            states, batch_copies(head, QR_B))
    gaps = {
        "single": _pose_gaps(got["p_Gk"][:QR_FRAMES], got["q_kG"][:QR_FRAMES],
                             ref["p_Gk"].cpu().numpy(),
                             ref["q_kG"].cpu().numpy()),
        f"B{QR_B}": _pose_gaps(outb["p_Gk"].cpu().numpy(),
                               outb["q_kG"].cpu().numpy(),
                               refb["p_Gk"].cpu().numpy(),
                               refb["q_kG"].cpu().numpy())}
    print(f"QR compression, graphed: {n} frames (the whole workload) in "
          f"{ms['qr']:.3f} ms a frame against {ms['cholesky']:.3f} ms for the "
          f"Cholesky (K5) frame (best of 2 each, in turns; first runs with "
          f"capture {first['qr']:.2f} and {first['cholesky']:.2f} s); ATE "
          f"{ate:.4f} m (limit {ATE_LIMIT_M}); launches {launches} (K5 0: "
          f"the QR route is one torch.linalg.qr, then the EKF correction by "
          f"two triangular solves); against the eager frames over {QR_FRAMES} "
          f"frames, single and B = {QR_B}: max gaps (m, rad) {gaps} (limits "
          f"{CPU_GAP_POS_M}, {CPU_GAP_ROT_RAD})", flush=True)
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"QR ATE {ate:.4f} m over {ATE_LIMIT_M} m")
    for key, (dp, dq) in gaps.items():
        if not (dp < CPU_GAP_POS_M and dq < CPU_GAP_ROT_RAD):
            raise AssertionError(f"graphed QR scan ({key}) and its eager "
                                 f"frames disagree: {dp:.3e} m, {dq:.3e} rad")
    return {"frames": n, "ms_qr": ms["qr"], "ms_cholesky": ms["cholesky"],
            "ate_m": ate, "gaps": gaps}


def _kernel_row(records, chk, label: str, name: str, launches: int,
                **extra) -> None:
    """A kernel's check (:func:`measure`) as a row ``name`` of the kernels
    line, with the launches of the run it belongs to."""
    rec = measure(chk, label)
    rec.update(name=name, launches=launches, **extra)
    records.append((chk.kernel, rec))


def joseph_stack_row(dev, records, clones: int, launches: int) -> None:
    """K5 on the seeded stack of scripts/joseph_order.py at ``clones``
    clones (n = 6 clones): against its plain version (:func:`measure`), a
    row ``ekf_tail@stack<n>`` with ``launches``, and its P_new within
    JOSEPH_F64_TOL of the chain's order in f64 (ops/checks.py
    ``joseph_p_new``), scaled by P_new's diagonal."""
    from rvio_tpu_torch.ops.checks import (ekf_tail_case, ekf_tail_stack,
                                           joseph_p_new, scaled_cov_err)
    n = 6 * clones
    C, b, P, sig2 = ekf_tail_stack(np.random.default_rng(JOSEPH_SEED),
                                   clones, JOSEPH_ROWS)
    chk = ekf_tail_case(dev, C, b, P, sig2, tol=2e-5,
                        what=f"seeded stack {JOSEPH_SEED}, n {n}")
    _kernel_row(records, chk, f"@stack{n} (seed {JOSEPH_SEED})",
                f"ekf_tail@stack{n}", launches, seed=JOSEPH_SEED)
    ref = joseph_p_new(*(torch.as_tensor(np.float64(x))
                         for x in (C, b, P, sig2)), True).numpy()
    got = chk.run_kernel()[1][0].double().cpu().numpy()
    err = scaled_cov_err(got, ref)
    records[-1][1]["f64_scaled_err"] = err
    print(f"kernel {TAIL_KERNEL}@stack{n}: P_new against the chain's order in "
          f"f64, scaled by its diagonal: {err:.3e} (limit "
          f"{JOSEPH_F64_TOL:.0e})", flush=True)
    if not err <= JOSEPH_F64_TOL:
        raise AssertionError(f"ekf_tail at n {n}: P_new {err:.3e} from f64")


def _k3_routes(L: int):
    """K3's route at length L (the wrapper's dispatch) and the other one,
    where it takes L (None past the compiled row bounds)."""
    from rvio_tpu_torch.ops import jac_project as k3
    route = k3.kernel_route(L)
    other = "wide" if route == "narrow" else (
        "narrow" if L <= k3.ROW_BOUND_MAX_L else None)
    return route, other


def _k4_routes(m: int):
    """K4's instance at order m (the wrapper's dispatch) and the other one,
    where it takes m (None past the warp instances)."""
    from rvio_tpu_torch.ops import spd_solve as k4
    route = k4.instance(m)
    other = "wide" if route == "narrow" else (
        "narrow" if m <= k4.NARROW_M else None)
    return route, other


def other_route(chk, route: str, other: str, label: str) -> dict:
    """The kernel of a check by the route the dispatch does not take, on
    the same inputs: checked against the plain version and timed as a
    CUDA graph of 200 launches; printed on its own line (before the
    dispatched route's row) and returned as the row's extra keys."""
    def run():
        return chk.kernel(*chk.args, **chk.kwargs, route=other)

    err = chk.compare(run(), chk.run_plain())
    torch.cuda.synchronize()
    ms = device_ms(run, reps=200)
    print(f"kernel {chk.name}{label}: the {other} route (not dispatched; "
          f"the row below is the {route} route) {ms * 1e3:.2f} us/launch on "
          f"the device, err {err:.3e} (tolerance: {chk.tolerance})",
          flush=True)
    return {"route_taken": route, "other_route": other,
            "other_route_ms": ms, "other_route_err": err}


def quadform_seam(dev, inputs) -> None:
    """K4 at the seam of its dispatch: seeded systems at m = 64 (the last
    order of the warp instances; as many as ``inputs`` has) through both
    instances, beside the wide instance on ``inputs`` (the
    m = 66 row's), each checked against the plain version and timed as a
    CUDA graph of 200 launches.  Then the wide instance as the dispatch
    takes it on dense seeded systems (QUADFORM_DENSE_F of them, one
    indefinite) at QUADFORM_DENSE_ORDERS: the main path's m = 130 (five
    panels, every one past the first with 4 x 4 trailing tiles; the
    recorded lanes there have few measurements, so their S is mostly
    sig2 I), S packed in shared memory, and S in the workspace."""
    from rvio_tpu_torch.ops.checks import quadform_case, spd_systems
    S, r = spd_systems(np.random.default_rng(64), len(inputs[1]), 64)
    cases = [("m = 64, warp instance", quadform_case(dev, S, r), "narrow"),
             ("m = 64, wide instance", quadform_case(dev, S, r), "wide"),
             ("m = 66, wide instance", quadform_case(dev, *inputs), "wide")]
    for m in QUADFORM_DENSE_ORDERS:
        S, r = spd_systems(np.random.default_rng(m), QUADFORM_DENSE_F, m)
        bad = QUADFORM_DENSE_F // 2
        S[bad] -= 2 * np.abs(np.linalg.eigvalsh(S[bad])).max() * np.eye(m)
        cases.append((f"m = {m}, dense, lane {bad} indefinite, the "
                      f"dispatch's instance",
                      quadform_case(dev, S, r, nan_lanes=[bad]), "auto"))
    for what, chk, route in cases:
        def run(chk=chk, route=route):
            return chk.kernel(*chk.args, route=route)

        err = chk.compare(run(), chk.run_plain())
        torch.cuda.synchronize()
        us = device_ms(run, reps=200) * 1e3
        print(f"kernel batched_quadform seam, {what}: {us:.2f} us/launch on "
              f"the device, err {err:.3e}", flush=True)


def wide_window_phase(dev, kernels, records) -> None:
    """Windows past the narrow filter kernels (WIDE_LENGTHS): the graphed
    sequence scan at each length over WIDE_FRAMES frames on the card
    (every filter kernel, K5 included, once a frame) and on the CPU,
    within the card-vs-CPU limits, the second half's mean n_good above
    WIDE_NGOOD_MIN (at WIDE_FEW_USABLE, above WIDE_ACCEPT of the features
    the CPU run found usable).  The CPU run records the K3 and K4 calls of
    the last frame in which a feature has two or more measurements, and
    the K5 calls of the last frames whose C is not zero;
    K3-K5 on those inputs against their plain versions (:func:`measure`)
    are rows ``<kernel>@wide<L>`` with the card run's launches, and K5 on
    WIDE_B such frames at once at WIDE_B_LENGTH a row
    ``ekf_tail@wide<L>B<B>``."""
    from unittest import mock

    import rvio_tpu_torch.filter.update as update
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.bench import feature_bundles
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.ops.checks import (ekf_tail_case, jac_case,
                                           quadform_case)
    from rvio_tpu_torch.runtime import make_sequence_scan
    for length in WIDE_LENGTHS:
        base = RVIOConfig()
        cfg = base.replace(tracker=dataclasses.replace(
            base.tracker, max_tracking_length=length))
        nn = 6 * cfg.window_size
        sim = simulate_sequence(cfg, duration=WIDE_DURATION_S,
                                static_time=1.5, ramp_time=5.0, seed=7,
                                n_landmarks=2000, motion_scale=0.8,
                                meas_noise=0.001, imu_noise=True)
        calls = {"jac_project": [], "batched_quadform": [], "ekf_tail": []}
        frame = {}      # this frame's K3 call, while it has a measurement

        def recorder(name):
            fn = getattr(update, name)

            def record(*args, **kw):
                kept = [a.detach().clone() if torch.is_tensor(a) else a
                        for a in args]
                if name == "jac_project":       # t_eff: args[10]
                    frame["k3"] = kept if bool((kept[10] >= 2).any()) else None
                elif name == "batched_quadform":
                    if frame.get("k3") is not None:
                        calls["jac_project"] = [frame["k3"]]
                        calls[name] = [kept]
                elif bool(kept[0].abs().sum() > 0):
                    calls[name] = (calls[name] + [kept])[-WIDE_B:]
                return fn(*args, **kw)
            return record

        out = {}
        for where in (dev, "cpu"):
            state0, bundles, _ = feature_bundles(cfg, sim, where)
            head = _head(bundles, WIDE_FRAMES)
            run = make_sequence_scan(cfg, where)
            with contextlib.ExitStack() as stack:
                if where == dev:
                    run(state0, head)                   # capture
                    _zero(kernels)
                else:
                    for name in calls:
                        stack.enter_context(mock.patch.object(
                            update, name, recorder(name)))
                t0 = time.perf_counter()
                _, o = run(state0, head)
                out[str(where)] = {k: v.cpu().numpy() for k, v in o.items()}
            if where == dev:
                wall = time.perf_counter() - t0
                launches = _launches(kernels)
        want = dict.fromkeys(FILTER_KERNELS, WIDE_FRAMES)
        card, cpu = out[str(dev)], out["cpu"]
        dp, dq = _pose_gaps(card["p_Gk"], card["q_kG"], cpu["p_Gk"],
                            cpu["q_kG"])
        half = slice(WIDE_FRAMES // 2, WIDE_FRAMES)
        good = float(card["n_good"][half].mean())
        usable = float(cpu["n_usable"][half].mean())
        need = (WIDE_ACCEPT * usable if length in WIDE_FEW_USABLE
                else WIDE_NGOOD_MIN)
        print(f"window of {cfg.window_size} clones (max_tracking_length "
              f"{length}: K3 at L = {length}, K4 at m = {2 * length}, K5 at "
              f"n = {nn}); graphed, {WIDE_FRAMES} frames in "
              f"{wall * 1e3 / WIDE_FRAMES:.3f} ms a frame, n_good mean "
              f"{card['n_good'].mean():.2f} (second half {good:.2f}, the "
              f"CPU's {float(cpu['n_good'][half].mean()):.2f} of "
              f"{usable:.2f} usable a frame; limit {need:.2f}), "
              f"launches {({k: launches[k] for k in FILTER_KERNELS})}; "
              f"against the CPU: max position gap {dp:.3e} m (limit "
              f"{CPU_GAP_POS_M}), attitude {dq:.3e} rad (limit "
              f"{CPU_GAP_ROT_RAD})", flush=True)
        if {k: launches[k] for k in FILTER_KERNELS} != want:
            raise AssertionError(f"wide window launches {launches}, "
                                 f"expected {want}")
        if not (dp < CPU_GAP_POS_M and dq < CPU_GAP_ROT_RAD):
            raise AssertionError(f"window {length}: card and CPU disagree")
        if not good > need:
            raise AssertionError(f"window {length}: too few good features")

        tag = f"@wide{length}"
        what = f" (window {length}, the last update's lanes)"
        k5 = [[x[0].numpy() for x in c] for c in calls["ekf_tail"]]
        if len(k5) < WIDE_B or not calls["jac_project"]:
            raise AssertionError(f"window {length}: {len(k5)} frames with "
                                 f"accepted features")
        t_eff = calls["jac_project"][0][10]
        lanes = f"{len(t_eff)} lanes ({int((t_eff >= 2).sum())} measured)"
        C, b, P, sig2 = k5[-1]
        checks = [
            (jac_case(dev, calls["jac_project"][0], what=what),
             f", {lanes}, L {length}"),
            (quadform_case(dev, *calls["batched_quadform"][0][:2], what=what),
             f", {lanes}, m {2 * length}"),
            (ekf_tail_case(dev, C, b, P, sig2, tol=EKF_TAIL_FRAME_TOL,
                           what=f"window {length}'s last update"),
             f", n {nn}, the last update")]
        routes = {"jac_project": _k3_routes(length),
                  "batched_quadform": _k4_routes(2 * length)}
        for chk, label in checks:
            extra = {}
            if chk.name in routes and routes[chk.name][1]:
                extra = other_route(chk, *routes[chk.name], f"{tag}{label}")
            _kernel_row(records, chk, f"{tag}{label}", f"{chk.name}{tag}",
                        launches[chk.name], window=length, **extra)
        if length == WIDE_B_LENGTH:
            quadform_seam(dev, calls["batched_quadform"][0][:2])
        if nn == 96:
            joseph_stack_row(dev, records, 16, launches["ekf_tail"])
        if length == WIDE_B_LENGTH:
            chk = ekf_tail_case(dev, *(np.stack(x) for x in zip(*k5)),
                                tol=EKF_TAIL_FRAME_TOL,
                                what=f"window {length}'s last {WIDE_B} updates")
            _kernel_row(records, chk, f"{tag}B{WIDE_B}, n {nn}",
                        f"ekf_tail{tag}B{WIDE_B}", launches["ekf_tail"],
                        window=length, systems=WIDE_B)


def wide_lk_phase(dev, sim, kernels, records) -> None:
    """K8 at an LK window past 16 x 16: images -> poses with CLAHE on at
    tracker.klt_window WIN_WIDE over WIN_WIDE_FRAMES tracked frames through
    the graphed image chunk scan (``run_rendered_sequence_scan``, as
    :func:`image_phase`): every kernel as often as the path implies, ATE
    below ATE_LIMIT_M, and the same frames through the plain path on the
    CPU within the image path's card-vs-CPU limits (active slots and
    positions).  Then an eager run to the same frame
    (:func:`capture_klt_frame`) records the last frame's K8 calls, and K8
    on those inputs at every level against its plain version (on the
    features well posed in f32, ops/checks.py ``lk_well_posed``): the
    level-0 check a row ``lk_level@win21`` of the kernels line with the
    graphed run's launches and every level's error in ``frame_levels``."""
    from rvio_tpu_torch.eval.ate import ate_rmse
    from rvio_tpu_torch.ops.checks import lk_case
    from rvio_tpu_torch.runtime import run_rendered_sequence_scan
    base = image_config(True)
    cfg = base.replace(tracker=dataclasses.replace(base.tracker,
                                                   klt_window=WIN_WIDE))
    levels = cfg.tracker.klt_levels + 1
    label = f"images -> poses at a {WIN_WIDE} x {WIN_WIDE} LK window"
    k0 = _init_frame(cfg, sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    k_end = k0 + 1 + WIN_WIDE_FRAMES
    # warm-up: library handles and the allocator's pool
    run_rendered_sequence_scan(cfg, sim, device=dev, max_frames=k0 + 9)
    _zero(kernels)
    t0 = time.perf_counter()
    res = run_rendered_sequence_scan(cfg, sim, device=dev, max_frames=k_end)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(kernels)
    n = len(res.timestamps)
    idx = np.searchsorted(sim.frame_t, res.timestamps)
    ate = ate_rmse(res.positions, sim.gt_p[idx])
    t0 = time.perf_counter()
    cpu = run_rendered_sequence_scan(cfg, sim, device="cpu", max_frames=k_end)
    cpu_s = time.perf_counter() - t0
    same = np.array_equal(cpu.timestamps, res.timestamps)
    agree = float((cpu.active_slots == res.active_slots).mean()) if same \
        else 0.0
    dp = float(np.abs(cpu.positions - res.positions).max()) if same \
        else float("inf")
    print(f"{label} (CLAHE on): {n} frames graphed in {wall:.2f} s (host "
          f"rendering included), ATE {ate:.4f} m (limit {ATE_LIMIT_M}), "
          f"n_good mean {res.n_good.mean():.2f}, launches {launches}; the "
          f"CPU plain path ({cpu_s:.1f} s): active slots agree on "
          f"{agree:.4%} of slot-frames (limit {IMG_CPU_ACTIVE_AGREE:.0%}), "
          f"max position gap {dp:.3e} m (limit {IMG_CPU_GAP_POS_M})",
          flush=True)
    want = expected_launches(WIN_WIDE_FRAMES, True, levels)
    if n != WIN_WIDE_FRAMES or launches != want:
        raise AssertionError(f"LK window {WIN_WIDE}: {n} frames, launches "
                             f"{launches}, expected {want}")
    if not (np.isfinite(res.positions).all() and res.positions.shape == (n, 3)
            and np.isfinite(res.quaternions).all() and ate < ATE_LIMIT_M):
        raise AssertionError(f"LK window {WIN_WIDE}: ATE {ate:.4f} m or a "
                             f"non-finite trajectory")
    if not (same and agree >= IMG_CPU_ACTIVE_AGREE
            and dp < IMG_CPU_GAP_POS_M):
        raise AssertionError(f"LK window {WIN_WIDE}: card and CPU disagree")
    captured = capture_klt_frame(dev, sim, cfg=cfg, frame=WIN_WIDE_FRAMES)[0]
    frame_levels = []
    for lvl, _, _, args, kw in captured:
        what = f" (win {WIN_WIDE}, frame {WIN_WIDE_FRAMES}, level {lvl})"
        chk = lk_case(dev, args, kw, what=what, well_posed=True)
        err = chk.check()
        torch.cuda.synchronize()
        frame_levels.append(dict(level=lvl, max_abs_err=err,
                                 alive=chk.info["alive"],
                                 alive_agree=chk.info["alive_agree"],
                                 set_aside=chk.info["set_aside"],
                                 T=int(chk.trips.max(initial=0))))
        print(f"kernel lk_level{what}: err {err:.3e} (tolerance: "
              f"{chk.tolerance}), alive {chk.info['alive']}, set aside "
              f"{chk.info['set_aside']}, T {int(chk.trips.max(initial=0))}",
              flush=True)
        if lvl == 0:
            level0 = chk
    _kernel_row(records, level0, f"@win{WIN_WIDE}, level 0",
                f"lk_level@win{WIN_WIDE}", launches["lk_level"],
                window=WIN_WIDE, frame_levels=frame_levels)


def past_lk_phase(dev, sim, kernels, records) -> None:
    """K8 at an LK window past 31 x 31 (WIN_PAST), where the tracker's
    wander bound is negative and the reference loses every feature on its
    first trip: images -> poses with CLAHE on over WIN_PAST_FRAMES tracked
    frames through the graphed image chunk scan, every kernel as often as
    the path implies, and the same frames on the CPU plain path: the same
    frames and slots, positions within the image path's card-vs-CPU limit,
    no feature good for an update on either.  Then an eager run to the
    same frame records its K8 calls, and K8 on them at every level against
    its plain version: the guesses bitwise the level-entry guesses, every
    status false on both, each feature's error within LK_POS_TOL (the
    level-0 check a row ``lk_level@win33`` with the graphed run's
    launches)."""
    from rvio_tpu_torch.ops.checks import LK_POS_TOL, lk_case
    from rvio_tpu_torch.runtime import run_rendered_sequence_scan
    base = image_config(True)
    cfg = base.replace(tracker=dataclasses.replace(base.tracker,
                                                   klt_window=WIN_PAST))
    levels = cfg.tracker.klt_levels + 1
    k0 = _init_frame(cfg, sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    k_end = k0 + 1 + WIN_PAST_FRAMES
    run_rendered_sequence_scan(cfg, sim, device=dev, max_frames=k0 + 3)
    _zero(kernels)
    res = run_rendered_sequence_scan(cfg, sim, device=dev, max_frames=k_end)
    torch.cuda.synchronize()
    launches = _launches(kernels)
    cpu = run_rendered_sequence_scan(cfg, sim, device="cpu", max_frames=k_end)
    n = len(res.timestamps)
    same = np.array_equal(cpu.timestamps, res.timestamps)
    agree = float((cpu.active_slots == res.active_slots).mean()) if same \
        else 0.0
    dp = float(np.abs(cpu.positions - res.positions).max()) if same \
        else float("inf")
    good = int(res.n_good.max(initial=0)), int(cpu.n_good.max(initial=0))
    print(f"images -> poses at a {WIN_PAST} x {WIN_PAST} LK window (CLAHE "
          f"on): {n} frames graphed, n_good at most {good[0]} (CPU "
          f"{good[1]}), launches {launches}; the CPU plain path: active "
          f"slots agree on {agree:.4%} of slot-frames (limit "
          f"{IMG_CPU_ACTIVE_AGREE:.0%}), max position gap {dp:.3e} m "
          f"(limit {IMG_CPU_GAP_POS_M})", flush=True)
    want = expected_launches(WIN_PAST_FRAMES, True, levels)
    if n != WIN_PAST_FRAMES or launches != want:
        raise AssertionError(f"LK window {WIN_PAST}: {n} frames, launches "
                             f"{launches}, expected {want}")
    if not (same and agree >= IMG_CPU_ACTIVE_AGREE
            and dp < IMG_CPU_GAP_POS_M and np.isfinite(res.positions).all()
            and good == (0, 0)):
        raise AssertionError(f"LK window {WIN_PAST}: card and CPU disagree "
                             f"or a feature was tracked")
    captured = capture_klt_frame(dev, sim, cfg=cfg, frame=WIN_PAST_FRAMES)[0]
    frame_levels = []
    tol = (f"guesses bitwise the level-entry guesses, every status false on "
           f"both, err {LK_POS_TOL:g} of the plain version's on every "
           f"feature")
    for lvl, _, _, args, kw in captured:
        what = f" (win {WIN_PAST}, frame {WIN_PAST_FRAMES}, level {lvl})"

        def compare(ko, po, what=what):
            (gk, sk, ek), (gp, sp, ep) = ko, po
            if not torch.equal(gk, gp) or bool(sk.any()) or bool(sp.any()):
                raise AssertionError(f"lk_level{what}: a guess moved or a "
                                     f"status is true")
            err = float((ek - ep).abs().max()) if len(ek) else 0.0
            if not err <= LK_POS_TOL:
                raise AssertionError(f"lk_level{what}: err {err:.3e}")
            return err

        chk = dataclasses.replace(lk_case(dev, args, kw, what=what),
                                  compare=compare, tolerance=tol)
        err = chk.check()
        torch.cuda.synchronize()
        frame_levels.append(dict(level=lvl, max_abs_err=err,
                                 features=len(args[0])))
        print(f"kernel lk_level{what}: err {err:.3e} over {len(args[0])} "
              f"features ({tol})", flush=True)
        if lvl == 0:
            level0 = chk
    _kernel_row(records, level0, f"@win{WIN_PAST}, level 0",
                f"lk_level@win{WIN_PAST}", launches["lk_level"],
                window=WIN_PAST, frame_levels=frame_levels)


def sweep_phase(dev, kernels) -> None:
    """``run_synthetic_sweep`` with one seed over SWEEP_DURATION_S on the
    card (every filter kernel once a filtered frame) and on the CPU: the
    same frames, each ATE below ATE_LIMIT_M; then ``python -m
    rvio_tpu_torch.run --sweep 1`` in process, which prints the table."""
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch import run as run_cli
    from rvio_tpu_torch.eval.sweep import format_table, run_synthetic_sweep
    cfg = RVIOConfig()
    _zero(kernels)
    t0 = time.perf_counter()
    rows = run_synthetic_sweep(cfg, seeds=(0,), duration=SWEEP_DURATION_S,
                               device=dev)
    wall = time.perf_counter() - t0
    launches = _launches(kernels)
    cpu = run_synthetic_sweep(cfg, seeds=(0,), duration=SWEEP_DURATION_S,
                              device="cpu")
    print(f"sweep, one seed on the card ({wall:.1f} s with the simulation):\n"
          f"{format_table(rows)}\nlaunches {launches}; on the CPU:\n"
          f"{format_table(cpu)}", flush=True)
    n = rows[0].frames
    if {k: launches[k] for k in FILTER_KERNELS} != dict.fromkeys(
            FILTER_KERNELS, n):
        raise AssertionError(f"sweep launches {launches}, {n} frames")
    if n != cpu[0].frames:
        raise AssertionError(f"sweep frames {n} on the card, "
                             f"{cpu[0].frames} on the CPU")
    for r in rows + cpu:
        if not r.ate_m < ATE_LIMIT_M:
            raise AssertionError(f"sweep ATE {r.ate_m:.4f} m over the limit")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as out, \
            contextlib.redirect_stdout(io.StringIO()) as printed:
        run_cli.main(["--sweep", "1", "--output", out])
    text = printed.getvalue()
    print(f"python -m rvio_tpu_torch.run --sweep 1 printed:\n{text}",
          end="", flush=True)
    if "synthetic_seed0" not in text or "mean" not in text:
        raise AssertionError("run --sweep printed no table")


def stress_phase(dev, kernels, records) -> None:
    """bench.py's high-rate stress config (BASELINE.json's fourth: 800
    slots, 400 update lanes, five pyramid levels, the coarsest 30 x 47):
    images -> poses over STRESS_FRAMES tracked frames on the card (every
    kernel as often as the path implies, ATE, the acceptance gates), then
    the kernels whose shapes the config changes on tracked frame
    KLT_FRAME's inputs against their plain versions (:func:`measure`):
    K2-K4 on the update's lanes, K6 and K8 at each level, K9 on the
    refill, K13 on the refill's image (K1, K5, K10 and K11 keep the
    default config's shapes); rows ``<kernel>@stress`` with the run's
    launches."""
    from rvio_tpu_torch.bench import bench_config
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.eval.ate import ate_rmse
    from rvio_tpu_torch.ops.checks import (STRESS_ENV, jac_case, lk_case,
                                           lm_case, quadform_case,
                                           shi_nms_case, subpix_case,
                                           tile_case)
    from rvio_tpu_torch.runtime import run_rendered_sequence_scan
    cfg = bench_config(STRESS_ENV)
    levels = cfg.tracker.klt_levels + 1
    sim = simulate_sequence(cfg, duration=STRESS_DURATION_S, static_time=1.5,
                            ramp_time=5.0, seed=7, n_landmarks=2000,
                            motion_scale=0.8, meas_noise=0.001,
                            imu_noise=True)
    k0 = _init_frame(cfg, sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    run_rendered_sequence_scan(cfg, sim, device=dev, max_frames=k0 + 9)
    _zero(kernels)
    t0 = time.perf_counter()
    res = run_rendered_sequence_scan(cfg, sim, device=dev, timing_split=True,
                                     max_frames=k0 + 1 + STRESS_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(kernels)
    n = len(res.timestamps)
    idx = np.searchsorted(sim.frame_t, res.timestamps)
    ate = ate_rmse(res.positions, sim.gt_p[idx])
    acc = res.acceptance_stats()
    usable = float(res.diag["n_usable"].mean())
    active = float(res.active_slots.sum(-1).mean())
    print(f"stress image path ({cfg.tracker.num_features} slots, "
          f"{cfg.tracker.max_update_features} update lanes, {levels} pyramid "
          f"levels): {n} frames, {n / wall:.1f} frames/s images -> poses "
          f"({wall:.2f} s, host rendering included); front-end "
          f"{float(res.frontend_ms.mean()):.3f} ms/frame, back-end "
          f"{float(res.backend_ms.mean()):.3f} ms/frame on the card; active "
          f"slots mean {active:.1f}; ATE {ate:.4f} m (limit {ATE_LIMIT_M}); "
          f"acceptance {json.dumps(acc)}, n_usable mean {usable:.1f}; "
          f"launches {launches}", flush=True)
    want = expected_launches(n, True, levels)
    if n != STRESS_FRAMES or launches != want:
        raise AssertionError(f"stress launches {launches} over {n} frames, "
                             f"expected {want}")
    if not (np.isfinite(res.positions).all() and ate < ATE_LIMIT_M):
        raise AssertionError(f"stress ATE {ate:.4f} m")
    for key, (op, lim) in ACCEPT_GATES.items():
        if not (acc[key] > lim if op == ">" else acc[key] < lim):
            raise AssertionError(f"stress {key} {acc[key]:.3f} fails {op} "
                                 f"{lim}")
    if not usable > N_USABLE_MIN:
        raise AssertionError(f"stress n_usable mean {usable:.1f}")

    t0 = time.perf_counter()
    filters = {}
    captured, _, subpix, nms_img = capture_klt_frame(
        dev, sim, cfg=cfg, filters=filters)
    print(f"stress: tracked frame {KLT_FRAME}'s inputs captured on the card "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    what = f" (stress, frame {KLT_FRAME})"
    z, Rc, tc, tl = filters["lm_triangulate"]
    F = len(tl)
    checks = [(lm_case(dev, z, Rc, tc, tl, cfg.camera.sigma_image, what=what),
               f", {F} lanes", None),
              (jac_case(dev, filters["jac_project"], what=what),
               f", {F} lanes", None),
              (quadform_case(dev, *filters["batched_quadform"], what=what),
               f", {F} lanes", None)]
    for lvl, tmpl, search, args, kw in captured:
        hw = f"{tmpl[0].shape[0]}x{tmpl[0].shape[1]}"
        at = f" (stress, frame {KLT_FRAME}, level {lvl}, {hw})"
        checks += [(tile_case(dev, *tmpl, what=at), f", level {lvl}, {hw}",
                    lvl),
                   (lk_case(dev, args, kw, what=at, well_posed=True),
                    f", level {lvl}, {hw}, {len(args[0])} lanes", lvl)]
    (tiles, origin, pts), kw = subpix
    checks += [(subpix_case(dev, tiles, origin, pts, **kw, what=what),
                f", {len(pts)} refill corners", None),
               (shi_nms_case(dev, nms_img, what=what), "", None)]
    for chk, label, lvl in checks:
        rec = measure(chk, f"@stress{label}")
        rec.update(name=f"{chk.name}@stress", launches=launches[chk.name],
                   features=cfg.tracker.num_features)
        if lvl is not None:
            rec["level"] = lvl
        records.append((chk.kernel, rec))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.eval.ate import ate_rmse
    from rvio_tpu_torch.ops import _lib
    from rvio_tpu_torch.ops.checks import kernel_checks
    from rvio_tpu_torch.runtime import SequenceDriver, batches_from_sim

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind} x{count}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {smi}", flush=True)

    # ---- build: one nvcc per source, all started together ----
    t0 = time.perf_counter()
    logs = _lib.build()
    print(f"build: {len(logs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- kernel phase: kernel vs plain on the card, times, bounds ----
    dev = torch.device("cuda", 0)
    records = [(chk.kernel, measure(chk)) for chk in kernel_checks(dev)]
    kernels = {rec["name"]: kernel for kernel, rec in records}

    # ---- main path: SequenceDriver on the card, bench.py's workload ----
    cfg = RVIOConfig()
    t0 = time.perf_counter()
    sim = workload_sim()
    batches = batches_from_sim(sim)
    print(f"workload: {len(sim.frame_t)} frames simulated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    args = (sim.imu_t, sim.imu_w, sim.imu_a)
    driver = SequenceDriver(cfg, dtype=torch.float32, device=dev)
    driver.run(*args, sim.frame_t[:100], batches[:100])   # warm-up: handles
    _zero(kernels)
    t0 = time.perf_counter()
    res = driver.run(*args, sim.frame_t, batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kernels[name].launches for name in FILTER_KERNELS}
    if any(k.launches for name, k in kernels.items()
           if name not in FILTER_KERNELS):
        raise AssertionError(f"the feature path launched kernels off its "
                             f"path: {_launches(kernels)}")
    for kernel, rec in records:
        if rec["name"] in FILTER_KERNELS:
            rec["launches"] = kernel.launches
    n = len(res.timestamps)
    idx = np.searchsorted(sim.frame_t, res.timestamps)
    ate = ate_rmse(res.positions, sim.gt_p[idx])
    backend_s = float(res.backend_ms.sum()) / 1e3
    print(f"main path: {n} frames, {n / wall:.1f} frames/s end to end "
          f"({wall:.2f} s), {n / backend_s:.1f} frames/s in the frame loop, "
          f"n_good mean {res.n_good.mean():.1f}, ATE {ate:.4f} m "
          f"(limit {ATE_LIMIT_M}), wider ridge on "
          f"{int(res.diag['ridge_fallback'].sum())} frames, launches "
          f"{launches}", flush=True)
    if any(v != n for v in launches.values()):
        raise AssertionError(f"every kernel must launch once per frame "
                             f"({n}): {launches}")
    if not (np.isfinite(res.positions).all() and res.positions.shape == (n, 3)
            and np.isfinite(res.quaternions).all()):
        raise AssertionError("non-finite or misshapen trajectory")
    if not ate < ATE_LIMIT_M:
        raise AssertionError(f"ATE {ate:.4f} m over {ATE_LIMIT_M} m")

    # ---- the first frames again through the plain path on the CPU, which
    # captures a frame's K1, K3 and K5 inputs ----
    k_end = int(np.searchsorted(sim.frame_t, res.timestamps[CPU_FRAMES - 1])) + 1
    t0 = time.perf_counter()
    cpu, prop_inputs, tail_inputs, jac_inputs = capture_frame_inputs(
        cfg, args, sim.frame_t[:k_end], batches[:k_end])
    m = len(cpu.timestamps)
    if m != CPU_FRAMES or not np.array_equal(cpu.timestamps, res.timestamps[:m]):
        raise AssertionError("the CPU run filtered other frames")
    dp = float(np.abs(cpu.positions - res.positions[:m]).max())
    dq = rotation_gap(cpu.quaternions, res.quaternions[:m])
    print(f"cpu plain path, first {m} frames ({time.perf_counter() - t0:.1f} s)"
          f": max position gap {dp:.3e} m (limit {CPU_GAP_POS_M}), max "
          f"attitude gap {dq:.3e} rad (limit {CPU_GAP_ROT_RAD})", flush=True)
    if not (dp < CPU_GAP_POS_M and dq < CPU_GAP_ROT_RAD):
        raise AssertionError("card kernel path and CPU plain path disagree")

    filter_frame_phase(dev, records, prop_inputs, jac_inputs)
    ekf_tail_phase(dev, records, tail_inputs)
    library_chain_phase(dev, sim, batches, kernels, res, driver)
    for phase, call in (
            ("QR", lambda: qr_phase(dev, sim, kernels)),
            ("wide window", lambda: wide_window_phase(dev, kernels,
                                                      records)),
            ("sweep", lambda: sweep_phase(dev, kernels))):
        t0 = time.perf_counter()
        call()
        print(f"{phase} phase: {time.perf_counter() - t0:.1f} s", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # set-up: the folder, and the native PNG loader built before the
        # timed replay
        from rvio_tpu_torch.dataio.native_loader import get_lib
        t0 = time.perf_counter()
        root = os.path.join(tmp, "asl")
        seq, sim_f = write_asl(root, cfg, sim)
        get_lib()
        print(f"ASL folder: {len(seq.cam_files)} frames rendered and written "
              f"as PNG in {time.perf_counter() - t0:.1f} s "
              f"({WRITE_THREADS} threads)", flush=True)

        graph_vs_eager_phase(dev, sim, sim_f, kernels)
        image_phase(dev, sim_f, kernels, records, equalizer=False,
                    n_frames=IMG_OFF_FRAMES)
        scan = image_phase(dev, sim_f, kernels, records, equalizer=True)
        klt_cap = klt_frame_phase(dev, sim_f, records)
        t0 = time.perf_counter()
        wide_lk_phase(dev, sim_f, kernels, records)
        print(f"wide LK window phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        past_lk_phase(dev, sim_f, kernels, records)
        print(f"LK window past 31 phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        drv = online_phase(dev, sim_f, kernels, scan)
        entries_phase(dev, sim_f, kernels, records, drv)
        replay_phase(dev, root, seq, kernels, records, tmp)
        replay_checks(dev, seq, kernels, scan, tmp)

    batch_launches = batched_phase(dev, sim, kernels)
    batch_cap = batch_kernel_phase(dev, sim, records, batch_launches)
    warm = warm_split_phase(dev, kernels)
    t0 = time.perf_counter()
    mesh_phase(dev, sim, kernels, records, batch_cap, klt_cap, warm)
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    set_sims, set_seqs = set_sequences()
    print(f"set: {SET_B} sequences of {[len(s.cam_t) for s in set_seqs]} "
          f"frames simulated and rendered in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    set_launches = set_replay_phase(dev, set_sims, set_seqs, kernels)
    batch_image_kernel_phase(dev, set_sims, set_seqs, records, set_launches)
    t0 = time.perf_counter()
    stress_phase(dev, kernels, records)
    print(f"stress phase: {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(smi)
    print(json.dumps({"kernels": [rec for _, rec in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
