"""Benchmark of the port on one CUDA card: filter frames/s at the EuRoC
operating point, and the image pipeline's rates and latency.

Port of bench.py's single-sequence measurements.  Run from the repository
root on a machine with a CUDA card:

    python -m rvio_tpu_torch.bench

The workload is bench.py's: ``RVIOConfig()`` (200 features, 15-frame
tracks, 20 Hz camera, 200 Hz IMU, CLAHE on, f32) on the 60 s synthetic
sequence of seed 7 (2000 landmarks), with bench.py's knobs
(:func:`bench_config`): ``BENCH_FEATURES`` (the slot budget),
``BENCH_KLT_LEVELS`` (the pyramid's top level) and ``BENCH_COMPRESSION``
(``cholesky`` or ``qr``).  BASELINE.json's high-rate stress config is

    BENCH_FEATURES=800 BENCH_KLT_LEVELS=4 python -m rvio_tpu_torch.bench

(800 slots, 400 update lanes, five pyramid levels).  Prints ONE JSON line with bench.py's
keys (``value`` is the feature path's frames/s through the graphed
``make_sequence_scan``, best of 3, each run ending in a readback of a sum
over every frame's pose; ``vs_baseline`` against the reference's 20 Hz
real-time rate) and the card's name and power limit.  ``batched_fps`` is
bench.py's segment-batched rate: ``batch`` = 16 (``BENCH_BATCH``) copies
of the feature workload through the graphed
``make_batched_sequence_scan``, B·T frames over the wall of the best of 2
runs, each ending in a readback of a sum over every frame's pose;
``pipeline_batched_fps`` is bench.py's batched image rate: ``pipeline_batch``
= 8 (``BENCH_PIPELINE_BATCH``) copies of the image rates' first two chunks
through the graphed ``make_batched_image_chunk_scan``, BP·2·32 frames over
the wall of the best of 2 runs, each ending in a readback of a sum over
every frame's position.
``BENCH_PIPELINE_ATE=0``, ``BENCH_STRESS=0`` and
``BENCH_LATENCY=0`` skip those parts, as in bench.py.  Without a CUDA
device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REFERENCE_FPS = 20.0  # the reference's real-time operating point (camera)
PB, NCHUNK = 32, 4    # the image rates: chunks of 32 frames, 4 of them


def bench_config(environ=None):
    """The benchmark's config from bench.py's knobs (bench.py:81-95):
    ``RVIOConfig()`` with ``BENCH_FEATURES`` slots and ``BENCH_KLT_LEVELS``
    as the pyramid's top level where set (non-zero), and a ``TpuConfig``
    of defaults with ``BENCH_COMPRESSION`` (default ``cholesky``)."""
    import dataclasses

    from rvio_tpu_torch import RVIOConfig
    environ = os.environ if environ is None else environ
    compression = environ.get("BENCH_COMPRESSION", "cholesky")
    cfg = RVIOConfig()
    n_feat = int(environ.get("BENCH_FEATURES", "0"))
    klt_lvl = int(environ.get("BENCH_KLT_LEVELS", "0"))
    if n_feat or klt_lvl:
        trk = dataclasses.replace(
            cfg.tracker,
            **({"num_features": n_feat} if n_feat else {}),
            **({"klt_levels": klt_lvl} if klt_lvl else {}))
        cfg = cfg.replace(tracker=trk)
    return cfg.replace(tpu=cfg.tpu.__class__(compression=compression))


def _sim(cfg):
    from rvio_tpu_torch.dataio.synthetic import simulate_sequence
    return simulate_sequence(cfg, duration=float(os.environ.get(
        "BENCH_DURATION_S", "60")), static_time=1.5, ramp_time=5.0, seed=7,
        n_landmarks=2000, motion_scale=0.8, meas_noise=0.001, imu_noise=True)


def feature_bundles(cfg, sim, dev, dtype=torch.float32):
    """The init state and the stacked bundles of every frame after it
    (bench.py's ``build_bundles``), in ``dtype`` on ``dev``."""
    from rvio_tpu_torch.filter.propagation import pad_imu
    from rvio_tpu_torch.runtime import (InitializationGate, SequenceDriver,
                                        bundle_imu)
    gate = InitializationGate(cfg, dtype, dev)
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    state, idx0 = None, None
    for k, (w, a, dts) in enumerate(groups):
        if len(w) < 2:
            continue
        state = gate.feed(w, a, dts)
        if state is not None:
            idx0 = k
            break
    if state is None:
        raise RuntimeError("no motion in the benchmark sequence")
    rows = [(pad_imu(*groups[k], cfg.tpu.imu_block),
             (sim.feat_meas[k], sim.feat_len[k], sim.feat_type2[k],
              sim.feat_valid[k])) for k in range(idx0, len(sim.frame_t))]
    return state, SequenceDriver(cfg, dtype=dtype, device=dev)._stack(rows), idx0


def batch_copies(bundles, B: int):
    """B copies of stacked bundles, (B, T, ...) on their device (the
    batched rate's workload, as bench.py stacks it)."""
    from rvio_tpu_torch.filter.propagation import ImuBlock
    from rvio_tpu_torch.filter.update import UpdateBatch
    from rvio_tpu_torch.runtime import FrameBundle

    def rep(x):
        return x[None].expand((B,) + tuple(x.shape)).contiguous()

    i, b = bundles.imu, bundles.batch
    return FrameBundle(
        imu=ImuBlock(w=rep(i.w), a=rep(i.a), dt=rep(i.dt), valid=rep(i.valid)),
        batch=UpdateBatch(meas=rep(b.meas), track_len=rep(b.track_len),
                          is_type2=rep(b.is_type2), valid=rep(b.valid)))


def _sync_s() -> float:
    """The least time of a bare readback of a device scalar."""
    x = torch.zeros((), device="cuda")
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        float(x)
        best = min(best, time.perf_counter() - t0)
    return best


def feature_path(cfg, sim, dev) -> dict:
    from rvio_tpu_torch.eval.ate import ate_rmse
    from rvio_tpu_torch.runtime import make_sequence_scan
    state0, bundles, idx0 = feature_bundles(cfg, sim, dev)
    n = int(bundles.imu.w.shape[0])
    run = make_sequence_scan(cfg, dev)
    t0 = time.perf_counter()
    _, out = run(state0, bundles)
    float(out["p_Gk"].sum())
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, out = run(state0, bundles)
        float(out["p_Gk"].sum() + out["q_kG"].sum())   # every frame's pose
        times.append(time.perf_counter() - t0)
    best = min(times)
    caps = run.frame_scan.captures
    return {"fps": n / best, "frames": n, "wall_s": best,
            "step_us_sync_delta": max(best - _sync_s(), 1e-9) / n * 1e6,
            "first_run_s": first_s,
            "capture_s": sum(c["seconds"] for c in caps),
            "unroll": run.frame_scan.unroll,
            "synthetic_ate_m": ate_rmse(out["p_Gk"].cpu().numpy(),
                                        sim.gt_p[idx0:]),
            "n_good_mean": float(out["n_good"].double().mean())}


def batched_path(cfg, sim, dev, B: int) -> dict:
    """bench.py's batched rate: B copies of the feature workload through
    ``make_batched_sequence_scan`` (every filter kernel once a frame for
    the batch), B·T frames over the wall of the best of 2 runs, each
    ending in a readback of a sum over every frame's pose."""
    from rvio_tpu_torch.runtime import make_batched_sequence_scan
    from rvio_tpu_torch.state import stack_states
    state0, bundles, _ = feature_bundles(cfg, sim, dev)
    n = int(bundles.imu.w.shape[0])
    run = make_batched_sequence_scan(cfg, dev)
    states, bb = stack_states([state0] * B), batch_copies(bundles, B)
    t0 = time.perf_counter()
    _, out = run(states, bb)
    float(out["p_Gk"].sum())
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        _, out = run(states, bb)
        float(out["p_Gk"].sum() + out["q_kG"].sum())   # every frame's pose
        times.append(time.perf_counter() - t0)
    caps = run.frame_scan.captures
    return {"fps": B * n / min(times), "batch": B,
            "ms_per_batched_frame": min(times) / n * 1e3,
            "first_run_s": first_s,
            "capture_s": sum(c["seconds"] for c in caps),
            "reserved_growth_bytes": max(
                (c["reserved_growth_bytes"] for c in caps), default=0)}


def image_rates(cfg, sim, dev, idx0) -> dict:
    """The fused chunk scan and the front-end chunk scan over NCHUNK chunks
    of PB frames after a tracker-init frame, with bench.py's synthetic IMU
    (no rotation, gravity, 10 samples a frame), each ended by a readback."""
    from rvio_tpu_torch.dataio.synthetic import render_frame
    from rvio_tpu_torch.frontend import make_tracker, stack_tracker_states
    from rvio_tpu_torch.runtime import (make_batched_image_chunk_scan,
                                        make_frontend_chunk_scan,
                                        make_image_chunk_scan)
    from rvio_tpu_torch.state import stack_states
    K = cfg.tpu.imu_block
    N = cfg.tracker.num_features
    init_fn, _ = make_tracker(cfg, dev)
    ts0, _ = init_fn(torch.as_tensor(np.clip(render_frame(
        cfg, sim, idx0 + 5), 0, 255).astype(np.uint8)))
    state0, _, _ = feature_bundles(cfg, sim, dev)
    u8 = np.stack([np.clip(render_frame(cfg, sim, idx0 + 6 + k), 0, 255)
                   for k in range(PB * NCHUNK)]).astype(np.uint8)
    gen = torch.Generator().manual_seed(0)
    f32 = dict(dtype=torch.float32, device=dev)
    chunks = [{"image": torch.as_tensor(u8[c * PB:(c + 1) * PB], device=dev),
               "imu_w": torch.zeros(PB, K, 3, **f32),
               "imu_a": torch.tensor([0.0, 0.0, cfg.imu.gravity],
                                     **f32).expand(PB, K, 3).contiguous(),
               "imu_dt": torch.full((PB, K), 1.0 / cfg.imu.rate_hz, **f32),
               "imu_valid": (torch.arange(K, device=dev) < 10).expand(
                   PB, K).contiguous(),
               "ok": torch.ones(PB, dtype=torch.bool, device=dev),
               "u": torch.rand(PB, N, generator=gen).to(dev)}
              for c in range(NCHUNK)]
    fused = make_image_chunk_scan(cfg, dev)
    front = make_frontend_chunk_scan(cfg, dev)

    def run_fused(n=NCHUNK):
        carry = (ts0, state0)
        for ch in chunks[:n]:
            carry, out = fused(carry, ch)
        return float(out["p_Gk"].sum())

    def run_front(n=NCHUNK):
        ts = ts0
        for ch in chunks[:n]:
            ts, out = front(ts, ch)
        return float(out["meas"].sum())

    res = {}
    for name, fn in (("pipeline", run_fused), ("frontend", run_front)):
        fn()
        one, every = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            fn(1)
            one.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            fn()
            every.append(time.perf_counter() - t0)
        res[f"{name}_fps"] = PB * NCHUNK / min(every)
        res[f"{name}_inscan_ms"] = ((min(every) - min(one)) * 1e3
                                    / (PB * (NCHUNK - 1)))

    # bench.py's segment-batched pipeline: BP copies of the first two
    # chunks through tracker + filter in lockstep
    BP = int(os.environ.get("BENCH_PIPELINE_BATCH", "8"))
    bscan = make_batched_image_chunk_scan(cfg, dev)
    bcarry = (stack_tracker_states([ts0] * BP), stack_states([state0] * BP))
    bchunks = [{k: v.expand((BP,) + tuple(v.shape)) for k, v in ch.items()}
               for ch in chunks[:2]]

    def run_batched():
        carry = bcarry
        for ch in bchunks:
            carry, out = bscan(carry, ch)
        return float(out["p_Gk"].sum())

    run_batched()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        run_batched()
        walls.append(time.perf_counter() - t0)
    res["pipeline_batched_fps"] = BP * PB * len(bchunks) / min(walls)
    res["pipeline_batch"] = BP
    res["pipeline_batched_capture_s"] = sum(
        c["seconds"] for c in bscan.frame_scan.captures)
    return res


def rendered_ates(cfg, sim, dev) -> dict:
    """bench.py's image-level accuracy: the full pipeline on the rendered
    sequence, and a 30 s slice under the combined photometric stress."""
    from rvio_tpu_torch.dataio.synthetic import PhotometricStress
    from rvio_tpu_torch.eval.ate import ate_rmse
    from rvio_tpu_torch.runtime import run_rendered_sequence_scan
    out = {}
    if os.environ.get("BENCH_PIPELINE_ATE", "1") == "1":
        res = run_rendered_sequence_scan(cfg, sim, device=dev, chunk_size=32)
        idx = np.searchsorted(sim.frame_t, res.timestamps)
        out["pipeline_ate_m"] = ate_rmse(res.positions, sim.gt_p[idx])
        out.update({k: v for k, v in res.acceptance_stats().items()
                    if k != "n_good_mean"})
    if os.environ.get("BENCH_STRESS", "1") == "1":
        stress = PhotometricStress(exposure_gains=(1.0, 0.55, 1.5),
                                   exposure_period_s=2.5,
                                   vignette_strength=0.35, blur_px=3.0,
                                   noise_sigma=4.0, burst_period_s=2.0,
                                   burst_sigma=18.0)
        res = run_rendered_sequence_scan(
            cfg, sim, device=dev, chunk_size=32,
            max_frames=int(30 * cfg.camera.fps), photometric=stress)
        idx = np.searchsorted(sim.frame_t, res.timestamps)
        out["pipeline_ate_stress_m"] = ate_rmse(res.positions, sim.gt_p[idx])
    return out


def latency(cfg, sim, dev, idx0, n_lat: int = 60) -> dict:
    """The live driver one frame at a time (push to pose), then pipelined
    (frame k-1's readback while frame k runs), as bench.py measures them."""
    from rvio_tpu_torch.dataio.synthetic import render_frame
    from rvio_tpu_torch.runtime import OnlineDriver
    k0 = max(idx0 - 2, 0)
    ks = range(k0, min(k0 + n_lat + 10, len(sim.frame_t)))
    frames = {k: np.clip(render_frame(cfg, sim, k), 0, 255).astype(np.uint8)
              for k in ks}
    out = {}
    for mode in ("single", "pipelined"):
        drv = OnlineDriver(cfg, device=dev)
        imu_done, lats = 0, []
        for k in ks:
            end = int(np.searchsorted(sim.imu_t, sim.frame_t[k],
                                      side="right"))
            for j in range(imu_done, end):
                drv.push_imu(sim.imu_t[j], sim.imu_w[j], sim.imu_a[j], seq=j)
            imu_done = end
            t0 = time.perf_counter()
            drv.push_image(sim.frame_t[k], frames[k], seq=k)
            got = (drv.spin_once() if mode == "single"
                   else drv.spin_once_pipelined())
            if got is not None:
                lats.append(time.perf_counter() - t0)
        drv.drain()
        warm = np.asarray(lats[5:]) * 1e3
        if mode == "single":
            out["latency_ms_p50"] = float(np.percentile(warm, 50))
            out["latency_ms_p99"] = float(np.percentile(warm, 99))
        else:
            out["latency_ms_pipelined"] = float(np.percentile(warm, 50))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("rvio_tpu_torch.bench: no CUDA device; the benchmark measures "
              "the card", file=sys.stderr)
        return 1
    from rvio_tpu_torch.ops import _lib
    dev = torch.device("cuda", 0)
    _lib.build()
    cfg = bench_config()
    sim = _sim(cfg)
    feat = feature_path(cfg, sim, dev)
    bat = batched_path(cfg, sim, dev, int(os.environ.get("BENCH_BATCH", "16")))
    idx0 = len(sim.frame_t) - feat["frames"]
    img = image_rates(cfg, sim, dev, idx0)
    ates = rendered_ates(cfg, sim, dev)
    lat = latency(cfg, sim, dev, idx0) if os.environ.get(
        "BENCH_LATENCY", "1") == "1" else {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "metric": "filter_frames_per_sec_per_chip",
        "value": feat["fps"], "unit": "frames/s",
        "vs_baseline": feat["fps"] / REFERENCE_FPS,
        "frames": feat["frames"], "wall_s": feat["wall_s"],
        "step_us_sync_delta": feat["step_us_sync_delta"],
        "first_run_s": feat["first_run_s"], "capture_s": feat["capture_s"],
        "unroll": feat["unroll"],
        "synthetic_ate_m": feat["synthetic_ate_m"],
        "pipeline_ate_m": ates.get("pipeline_ate_m"),
        "pipeline_ate_stress_m": ates.get("pipeline_ate_stress_m"),
        "n_good_mean": feat["n_good_mean"],
        "batched_fps": bat["fps"], "batch": bat["batch"],
        "batched_ms_per_frame": bat["ms_per_batched_frame"],
        "batched_capture_s": bat["capture_s"],
        "batched_reserved_growth_bytes": bat["reserved_growth_bytes"],
        "frontend_fps": img["frontend_fps"],
        "frontend_inscan_ms": img["frontend_inscan_ms"],
        "pipeline_fps": img["pipeline_fps"],
        "pipeline_inscan_ms": img["pipeline_inscan_ms"],
        "pipeline_batched_fps": img["pipeline_batched_fps"],
        "pipeline_batch": img["pipeline_batch"],
        "pipeline_batched_capture_s": img["pipeline_batched_capture_s"],
        "latency_ms_p50": lat.get("latency_ms_p50"),
        "latency_ms_p99": lat.get("latency_ms_p99"),
        "latency_ms_pipelined": lat.get("latency_ms_pipelined"),
        **{k: v for k, v in ates.items() if not k.startswith("pipeline_ate")},
        "compression": cfg.tpu.compression,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "config": (f"euroc_{cfg.tracker.num_features}feat_window"
                   f"{cfg.tracker.max_tracking_length}"),
        "klt_levels": cfg.tracker.klt_levels,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
