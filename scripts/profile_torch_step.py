#!/usr/bin/env python3
"""Where the port's per-frame path spends its time on a CUDA card.

    python3 scripts/profile_torch_step.py [--graph] [--image
        [--no-equalizer]] [--batch B] [--frames 200] [--trace PATH]
        [--tracking-length L]

Without ``--image``: ``SequenceDriver`` (rvio_tpu_torch, f32,
``RVIOConfig()``) on the 60 s synthetic workload of bench.py, the
feature-level filter.  With ``--image``: ``run_rendered_sequence_scan`` on
the same workload's rendered 752 x 480 frames, images -> poses at
``RVIOConfig()`` (CLAHE on; ``--no-equalizer`` turns it off), with its
front-end/back-end split.  With ``--batch B``: B copies of the feature
workload through ``make_batched_sequence_scan`` (bench.py's batched
rate), a frame of the B segments per step; with ``--image --batch B``:
B copies of the first ``--frames`` + 100 tracked frames of the rendered
workload through ``make_batched_image_chunk_scan`` (the set replay's
frame: tracker and filter over the B images).  With ``--graph`` both
batched forms also time the graph's replays alone (the host's enqueue
time against the device's time a frame).  The frames run eagerly, one launch after
another from the host (chip_smoke.eager_frames), unless ``--graph``: then
as the drivers run them, replays of captured CUDA graphs
(rvio_tpu_torch/runtime/graph.py), whose capture happens in the whole run
and not in the profiled window.  Either runs once whole, timed on
the host clock (each run ends in a readback), then a window of
``--frames`` frames under ``torch.profiler``.  Prints the card, the
frames/s, the device busy time per frame and its share of the unprofiled
frame loop (for the image path: of the front-end + back-end time; the
host renders the frames outside it), the CUDA kernel launches per frame, and the device
time per launch of the port's kernels and of the other kernels by total
time.  ``--trace`` writes the window's Chrome trace.  ``--tracking-length
L`` sets ``tracker.max_tracking_length`` (a window of L - 1 clones; the
feature path at L = 17 and 65 takes the filter kernels' wide forms).
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# profiler names of the port's kernels on the paths (K6 is
# gather_narrow_kernel, K13 shi_strip_kernel<6, true>; K5's wide route is
# its factor_kernel, solve_kernel, product_kernel and joseph_kernel)
PORT_KERNELS = ("propagate_block_kernel", "lm_kernel", "jac_project_kernel",
                "jac_project_wide_kernel", "quadform_kernel",
                "quadform_wide_kernel", "ekf_tail_kernel", "factor_kernel",
                "solve_kernel", "product_kernel", "joseph_kernel",
                "clahe_luts_kernel", "clahe_apply_kernel",
                "gather_narrow_kernel", "lk_level_kernel", "subpix_kernel",
                "shi_strip_kernel")


def _image_runner(cfg, sim, equalizer: bool):
    """``run(max_frames)``: images -> poses, timing split."""
    import dataclasses

    from rvio_tpu_torch.runtime import run_rendered_sequence_scan

    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, enable_equalizer=equalizer))

    def run(k_end=None):
        return run_rendered_sequence_scan(cfg, sim, device="cuda",
                                          max_frames=k_end, timing_split=True)
    return run


@contextlib.contextmanager
def _scans_kept():
    """The image driver's chunk scans built once and reused by every run
    (a run builds its own, so each would capture anew)."""
    from unittest import mock

    import rvio_tpu_torch.runtime.image_driver as image_driver
    names = ("make_image_chunk_scan", "make_frontend_chunk_scan",
             "make_backend_chunk_scan")
    built = {}

    def keep(name, build):
        def get(*args, **kw):
            if name not in built:
                built[name] = build(*args, **kw)
            return built[name]
        return get

    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(mock.patch.object(
                image_driver, name, keep(name, getattr(image_driver, name))))
        yield


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", action="store_true",
                    help="profile images -> poses instead of the filter")
    ap.add_argument("--no-equalizer", action="store_true",
                    help="with --image: CLAHE off (the PR 3 workload)")
    ap.add_argument("--graph", action="store_true",
                    help="the drivers' graphed frames (default: eager)")
    ap.add_argument("--batch", type=int, default=0,
                    help="B copies of the feature workload in the batched "
                    "scan (with --image: of the rendered frames in the "
                    "batched image scan)")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--tracking-length", type=int, default=0,
                    help="tracker.max_tracking_length (default: "
                    "RVIOConfig()'s 15)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    print("workload: " + ("images -> poses, CLAHE "
                          + ("off" if a.no_equalizer else "on")
                          if a.image else "feature-level filter")
          + (f", {a.batch} segments a frame" if a.batch else "")
          + (f", max_tracking_length {a.tracking_length}"
             if a.tracking_length else "")
          + ("; frames graphed" if a.graph else "; frames eager"),
          flush=True)
    from chip_smoke import eager_frames
    with _scans_kept() if a.graph else eager_frames():
        if a.batch and a.image:
            return _profile_batched_image(a)
        return _profile_batched(a) if a.batch else _profile(a)


def _config(a):
    """``RVIOConfig()``, with ``--tracking-length`` where given."""
    import dataclasses

    from rvio_tpu_torch import RVIOConfig
    cfg = RVIOConfig()
    if a.tracking_length:
        cfg = cfg.replace(tracker=dataclasses.replace(
            cfg.tracker, max_tracking_length=a.tracking_length))
    return cfg


def _workload(cfg):
    from rvio_tpu_torch.dataio import simulate_sequence
    return simulate_sequence(cfg, duration=60.0, static_time=1.5,
                             ramp_time=5.0, seed=7, n_landmarks=2000,
                             motion_scale=0.8, meas_noise=0.001,
                             imu_noise=True)


def _profile_batched(a) -> int:
    """The batched feature path: whole runs timed, then a window of the
    first ``--frames`` batched frames profiled."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from rvio_tpu_torch.bench import batch_copies, feature_bundles
    from rvio_tpu_torch.ops import _lib
    from rvio_tpu_torch.runtime import make_batched_sequence_scan
    from rvio_tpu_torch.state import stack_states
    from rvio_tpu_torch.state.filter_state import map_fields
    _lib.build()
    cfg = _config(a)
    state0, bundles, _ = feature_bundles(cfg, _workload(cfg), "cuda")
    T = int(bundles.imu.w.shape[0])
    states = stack_states([state0] * a.batch)
    bb = batch_copies(bundles, a.batch)
    run = make_batched_sequence_scan(cfg, "cuda")

    def timed(b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = run(states, b)
        float(out["p_Gk"].sum())
        return time.perf_counter() - t0

    timed(bb)                                                # warm-up
    walls = [timed(bb) for _ in range(4)]
    wall = min(walls)
    loop_ms = wall * 1e3 / T
    print(f"whole run: {a.batch} x {T} frames, best {wall:.3f} s = "
          f"{a.batch * T / wall:.1f} frames/s end to end "
          f"({', '.join(f'{a.batch * T / w:.1f}' for w in walls)}); "
          f"{loop_ms:.3f} ms a batched frame", flush=True)
    if a.graph:
        _replays_alone(run.frame_scan, T)
    m = min(a.frames, T)
    win = dataclasses.replace(
        bb, imu=map_fields(lambda x: x[:, :m], bb.imu),
        batch=map_fields(lambda x: x[:, :m], bb.batch))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w = timed(win)
    _report(a, prof, w, m, loop_ms)
    return 0


def _replays_alone(fs, T: int) -> None:
    """The graph's replays alone: the host's time to enqueue one against
    the device's time a frame (CUDA events on the graph stream)."""
    from rvio_tpu_torch.runtime.graph import device_stream
    stream, _ = device_stream(torch.device("cuda", 0))
    for _ in range(3):
        fs._cursor.zero_()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.cuda.stream(stream):
            e0.record()
            t0 = time.perf_counter()
            for _ in range(T):
                fs._replay(1)
            t1 = time.perf_counter()
            e1.record()
        torch.cuda.synchronize()
        print(f"replays: {(t1 - t0) / T * 1e3:.4f} ms of host time to "
              f"enqueue one, {e0.elapsed_time(e1) / T:.4f} ms of device "
              f"time a batched frame", flush=True)


def _profile_batched_image(a) -> int:
    """The batched image frame: B copies of the workload's first tracked
    frames (rendered once, held on the host) as one chunk through
    make_batched_image_chunk_scan, whole runs timed, then a window of the
    first ``--frames`` batched frames profiled."""
    from torch.profiler import ProfilerActivity, profile

    from rvio_tpu_torch.dataio.synthetic import render_frame
    from rvio_tpu_torch.frontend import make_tracker, stack_tracker_states
    from rvio_tpu_torch.ops import _lib
    from rvio_tpu_torch.runtime import (bundle_imu,
                                        make_batched_image_chunk_scan)
    from rvio_tpu_torch.runtime.image_driver import (_find_init_frame,
                                                     _imu_chunk_arrays,
                                                     uniform_table)
    from rvio_tpu_torch.state import stack_states
    _lib.build()
    cfg = _config(a)
    sim = _workload(cfg)
    B, dev = a.batch, torch.device("cuda", 0)
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    fs0, k0 = _find_init_frame(cfg, groups, len(sim.frame_t), torch.float32,
                               dev)
    T = a.frames + 100
    ks = list(range(k0 + 1, k0 + 1 + T))
    t0 = time.perf_counter()
    u8 = np.stack([np.clip(render_frame(cfg, sim, k), 0, 255)
                   for k in [k0] + ks]).astype(np.uint8)
    print(f"rendered {T + 1} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    init_fn, _ = make_tracker(cfg, dev)
    ts0, _ = init_fn(torch.as_tensor(u8[0]))
    ch = _imu_chunk_arrays(groups, ks, cfg.tpu.imu_block, torch.float32, dev)
    ch["image"] = torch.as_tensor(u8[1:]).to(dev)
    ch["u"] = uniform_table(0, T, cfg.tracker.num_features).to(dev).float()
    chunk = {k: v.expand((B,) + tuple(v.shape)) for k, v in ch.items()}
    carry = (stack_tracker_states([ts0] * B), stack_states([fs0] * B))
    scan = make_batched_image_chunk_scan(cfg, dev)

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = scan(carry, {k: v[:, :n] for k, v in chunk.items()})
        float(out["p_Gk"].sum())
        return time.perf_counter() - t0

    timed(T)                                                 # warm-up
    walls = [timed(T) for _ in range(3)]
    wall = min(walls)
    loop_ms = wall * 1e3 / T
    print(f"whole run: {B} x {T} frames, best {wall:.3f} s = "
          f"{B * T / wall:.1f} frames/s end to end "
          f"({', '.join(f'{B * T / w:.1f}' for w in walls)}); "
          f"{loop_ms:.3f} ms a batched frame; captures "
          f"{[(c['frames'], round(c['seconds'], 4), c['reserved_growth_bytes']) for c in scan.frame_scan.captures]}",
          flush=True)
    if a.graph:
        _replays_alone(scan.frame_scan, T)
    m = a.frames
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w = timed(m)
    _report(a, prof, w, m, loop_ms)
    return 0


def _profile(a) -> int:
    from torch.profiler import ProfilerActivity, profile

    from rvio_tpu_torch.eval.ate import ate_rmse
    from rvio_tpu_torch.ops import _lib
    from rvio_tpu_torch.runtime import SequenceDriver, batches_from_sim
    _lib.build()
    cfg = _config(a)
    sim = _workload(cfg)
    if a.image:
        run = _image_runner(cfg, sim, not a.no_equalizer)
    else:
        batches = batches_from_sim(sim)
        imu = (sim.imu_t, sim.imu_w, sim.imu_a)
        drv = SequenceDriver(cfg, dtype=torch.float32, device="cuda")

        def run(k_end=None):
            return drv.run(*imu, sim.frame_t[:k_end], batches[:k_end])
    run(len(sim.frame_t) // 10)                              # warm-up

    walls = []
    for _ in range(1 if a.image else 2):
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
    n = len(res.timestamps)
    idx = np.searchsorted(sim.frame_t, res.timestamps)
    # the frame loop: the filter's, or the tracker's and the filter's
    loop_ms = float(res.backend_ms.sum()
                    + (res.frontend_ms.sum() if a.image else 0.0)) / n
    split = (f" (front-end {res.frontend_ms.mean():.3f}, back-end "
             f"{res.backend_ms.mean():.3f})" if a.image else "")
    print(f"whole run: {n} frames, best {min(walls):.3f} s = "
          f"{n / min(walls):.1f} frames/s end to end; frame loop "
          f"{loop_ms:.3f} ms/frame{split}; ATE "
          f"{ate_rmse(res.positions, sim.gt_p[idx]):.4f} m", flush=True)

    # profiled window: the first frames after init, run as their own sequence
    k_end = int(np.searchsorted(sim.frame_t, res.timestamps[a.frames - 1])) + 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        win = run(k_end)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(a, prof, wall, len(win.timestamps), loop_ms)
    return 0


def _report(a, prof, wall: float, m: int, loop_ms: float) -> None:
    """The profiled window of ``m`` frames that took ``wall`` s: device
    busy time and launches a frame, the port's kernels, the top rows."""
    # device-side rows only (kernels, memcpy, memset); the aten rows carry
    # their kernels' device time too and would count it twice
    dev_us = {e.key: (e.device_time_total, e.count)
              for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.count}
    busy = sum(t for k, (t, c) in dev_us.items())
    launches = sum(c for k, (t, c) in dev_us.items()
                   if not k.startswith(("Memcpy", "Memset")))
    print(f"profiled window: {m} frames in {wall * 1e3:.1f} ms "
          f"({wall * 1e3 / m:.3f} ms/frame under the profiler); device busy "
          f"{busy / 1e3:.1f} ms = {busy / (wall * 1e6):.1%} of the window; "
          f"{launches / m:.1f} kernel launches per frame", flush=True)
    print(f"device busy per frame {busy / 1e3 / m:.3f} ms = "
          f"{busy / 1e3 / m / loop_ms:.1%} of the unprofiled frame loop "
          f"({loop_ms:.3f} ms/frame)", flush=True)
    for name in PORT_KERNELS:
        hit = [(k, t, c) for k, (t, c) in dev_us.items() if name in k]
        for k, t, c in hit:
            print(f"  port kernel {name}: {c} launches, {t / c:.2f} us/launch "
                  f"device, {t / busy:.1%} of device busy time")
        if not hit:
            print(f"  port kernel {name}: not seen by the profiler")
    print("  top device rows by total time:")
    for k, (t, c) in sorted(dev_us.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"    {t / 1e3:8.2f} ms  {c:6d} x {t / c:7.2f} us  {k[:90]}")
    if a.trace:
        Path(a.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(a.trace)
        print(f"trace: {a.trace}")


if __name__ == "__main__":
    sys.exit(main())
