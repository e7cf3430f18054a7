"""The set replay: B image sequences through ``run_sequence_set``
(runtime/replay_set.py, the body of ``run --set``), frames as in-memory u8
arrays, one pass one call over the whole set: a user's replay job (init
gates, init frames, captures, chunks and readbacks).  The window runs
passes back to back and starts none once its seconds are up.

Traffic parameters: ``durations_s`` (one sequence each), ``chunk_size``,
``sim`` (the simulator's arguments), ``warmup_frames`` (the set-up's short
pass), ``trace_chunks`` ([first, count] of the traced pass's chunks) and
``check_frames`` (the frames after each init frame the reference
recomputes).
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.drivers import common
from benchmark.gen import render, sim
from benchmark.reference import pipeline


def setup(run):
    from rvio_tpu_torch.ops import _lib
    p = run.traffic
    if run.device.type == "cuda":
        _lib.build()
    seqs = []
    for i, dur in enumerate(p["durations_s"]):
        s = sim.simulate(run.cfg, duration=float(dur),
                         seed=common.sim_seed(run.seed, i), features=False,
                         **p["sim"])
        frames = render.render(run.cfg, s, range(len(s.frame_t)), run.device)
        seqs.append(SimpleNamespace(imu_t=s.imu_t, imu_w=s.imu_w,
                                    imu_a=s.imu_a, cam_t=s.frame_t,
                                    images=frames))
    _pass(run, seqs, max_frames=p["warmup_frames"])
    gc.collect()
    return {"seqs": seqs}


def _pass(run, seqs, max_frames=None):
    from rvio_tpu_torch.runtime import run_sequence_set
    return run_sequence_set(run.cfg, seqs, device=run.device,
                            chunk_size=run.traffic["chunk_size"],
                            seed=common.draw_seed(run.seed),
                            max_frames=max_frames)


def _traced_pass(run, seqs):
    """One pass with the profiler over chunks ``trace_chunks`` of it."""
    import rvio_tpu_torch.runtime.replay_set as replay_set
    from benchmark.trace import Tracer
    first, count = run.traffic["trace_chunks"]
    tracer = Tracer(run.device)
    poses = [0]
    orig = replay_set.make_batched_image_chunk_scan

    def factory(*args, **kwargs):
        scan = orig(*args, **kwargs)
        calls = [0]

        def traced(carry, chunk):
            i = calls[0]
            calls[0] += 1
            if i == first:
                tracer.start()
            if i == first + count and tracer.active:
                tracer.stop(poses[0])
            if tracer.active:
                poses[0] += int(chunk["ok"].sum())
            return scan(carry, chunk)
        return traced

    replay_set.make_batched_image_chunk_scan = factory
    try:
        res = _pass(run, seqs)
    finally:
        replay_set.make_batched_image_chunk_scan = orig
    if tracer.active:
        tracer.stop(poses[0])
    return res, tracer


def window(run, state):
    seqs = state["seqs"]
    passes = []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        res = _pass(run, seqs)
        te = time.perf_counter()
        passes.append((ts, te, res))
        # the pass's CUDA graphs are freed here, never by a collection
        # that falls inside the next pass's capture
        gc.collect()
        if te - t0 >= run.seconds:
            break
    ok = [sum(len(r.timestamps) for r in res) for _, _, res in passes]
    span = passes[-1][1] - passes[0][0]
    expected = sum(len(s.cam_t) - int(np.searchsorted(s.cam_t, r.timestamps[0]))
                   for s, r in zip(seqs, passes[0][2]))
    bad = sum(int((~np.isfinite(r.positions).all(axis=1)).sum())
              for _, _, res in passes for r in res)
    host = [((te - ts) * 1e3 - sum(float(r.backend_ms.sum()) for r in res))
            / n for (ts, te, res), n in zip(passes, ok)]
    run.counters.update(passes=len(passes), poses=sum(ok),
                        replay_host_ms_per_frame=float(np.mean(host)),
                        batch=len(seqs))
    if run.trace:
        res, tracer = _traced_pass(run, seqs)
        passes.append((None, None, res))
        from benchmark.trace import summarize
        run.trace_summary = summarize(tracer, run.cfg, len(seqs))
        run.trace_summary["kind"] = "image"
    return {"end_to_end": {"image_frames_per_s": sum(ok) / span},
            "attempted": expected * len(ok), "failed": expected * len(ok)
            - sum(ok) + bad, "results": [res for _, _, res in passes]}


def outputs(out) -> list:
    """The window's answers: every pass's sequences as dicts of stamps,
    positions and tracker slot flags."""
    return [[{"t": r.timestamps, "p": r.positions,
              "active": r.active_slots.astype(bool)} for r in res]
            for res in out.pop("results")]


def reference(run, state, tf32: bool = False) -> list:
    """The reference's first ``check_frames`` frames of each sequence
    (with ``tf32``: the control)."""
    seqs = [pipeline.ImageSeq(s.imu_t, s.imu_w, s.imu_a, s.cam_t, s.images)
            for s in state["seqs"]]
    with pipeline.precision(tf32):
        return pipeline.image_frames(run.ref_cfg, seqs,
                                     common.draw_seed(run.seed),
                                     run.traffic["check_frames"], "cpu")


def answers(ref) -> list:
    """The reference's (or the control's) frames as the answers of one
    pass, for :func:`judge`."""
    return [ref]


def judge(run, passes, ref) -> dict:
    """Every number the check can compare, of every pass's first frames of
    each sequence against the reference (common.Gaps), each sequence also
    on its own over its first ``tracker.max_tracking_length`` frames (no
    tracker decision has parted there yet, so a sound sequence stays at
    rounding); ``nonfinite_poses`` counts every frame of
    every pass; ``slot_flags_differing``, the largest share of tracker
    slot flags (active or not) that differ, is shown, not compared."""
    gaps, flags = common.Gaps(run.cfg.tracker.max_tracking_length), 0.0
    for seqs in passes:
        for r, f in zip(seqs, ref):
            gaps.add(r["t"], r["p"], f["t"], f["p"])
            n = min(len(r["t"]), len(f["t"]))
            if n and np.array_equal(r["t"][:n], f["t"][:n]):
                flags = max(flags, float(np.mean(r["active"][:n]
                                                 != f["active"][:n])))
    nonfinite = sum(int((~np.isfinite(np.asarray(r["p"], np.float64))
                         .all(axis=-1)).sum()) for seqs in passes
                    for r in seqs)
    return {**gaps.numbers(), "nonfinite_poses": float(nonfinite),
            "slot_flags_differing": flags}


def check(run, state, out):
    passes = outputs(out)
    common.free_device(run.device)
    return common.compared(judge(run, passes, reference(run, state)),
                           run.limits)
