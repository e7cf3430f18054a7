"""The feature-level filter batch: B distinct feature-track sequences
through ``make_batched_sequence_scan`` (runtime/step.py), every filter
kernel once a frame for the batch; the tracker is bypassed.  Each
sequence has its own init gate in set-up and is cut to the shortest
tracked length.  One pass is one call plus a readback of every frame's
pose; the window runs passes back to back.

Traffic parameters: ``batch``, ``duration_s``, ``sim`` (the simulator's
arguments), ``trace_frames`` (the traced call's frames) and
``check_frames`` (the frames the reference recomputes).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.drivers import common
from benchmark.gen import sim
from benchmark.reference import pipeline


def _bundles(cfg, seqs, dev, dtype=torch.float32):
    """The init states and the (B, T, ...) bundles of every frame from
    each sequence's init frame, cut to the shortest (the port's
    bench.feature_bundles, stacked over B distinct sequences)."""
    from rvio_tpu_torch.filter.propagation import ImuBlock, pad_imu
    from rvio_tpu_torch.filter.update import UpdateBatch
    from rvio_tpu_torch.runtime import (FrameBundle, InitializationGate,
                                        bundle_imu)
    from rvio_tpu_torch.state import stack_states
    states, rows = [], []
    for s in seqs:
        gate = InitializationGate(cfg, dtype, dev)
        groups = bundle_imu(s.imu_t, s.imu_w, s.imu_a, s.frame_t)
        for k, (w, a, dts) in enumerate(groups):
            if len(w) < 2:
                continue
            st = gate.feed(w, a, dts)
            if st is not None:
                break
        else:
            raise RuntimeError("a sequence never initialized")
        states.append(st)
        rows.append((groups, k))
    T = min(len(s.frame_t) - k for s, (_, k) in zip(seqs, rows))

    def put(x, t):
        return torch.as_tensor(np.stack(x), device=dev).to(t)

    imu = [[pad_imu(*g[k0 + j], cfg.tpu.imu_block) for j in range(T)]
           for g, k0 in rows]
    feats = [[(s.feat_meas[k0 + j], s.feat_len[k0 + j], s.feat_type2[k0 + j],
               s.feat_valid[k0 + j]) for j in range(T)]
             for s, (_, k0) in zip(seqs, rows)]

    def field(src, i, t):
        return put([np.stack([r[i] for r in seq]) for seq in src], t)

    bundles = FrameBundle(
        imu=ImuBlock(w=field(imu, 0, dtype), a=field(imu, 1, dtype),
                     dt=field(imu, 2, dtype), valid=field(imu, 3, torch.bool)),
        batch=UpdateBatch(meas=field(feats, 0, dtype),
                          track_len=field(feats, 1, torch.int64),
                          is_type2=field(feats, 2, torch.bool),
                          valid=field(feats, 3, torch.bool)))
    return stack_states(states), bundles, T


def setup(run):
    from rvio_tpu_torch.ops import _lib
    from rvio_tpu_torch.runtime import make_batched_sequence_scan
    p = run.traffic
    if run.device.type == "cuda":
        _lib.build()
    seqs = [sim.simulate(run.cfg, duration=float(p["duration_s"]),
                         seed=common.sim_seed(run.seed, i), features=True,
                         **p["sim"]) for i in range(p["batch"])]
    states, bundles, T = _bundles(run.cfg, seqs, run.device)
    scan = make_batched_sequence_scan(run.cfg, run.device)
    _pass(scan, states, bundles)
    return {"seqs": seqs, "states": states, "bundles": bundles, "T": T,
            "scan": scan}


def _pass(scan, states, bundles):
    _, out = scan(states, bundles)
    return out["p_Gk"].cpu().numpy(), out["q_kG"].cpu().numpy()


def window(run, state):
    from benchmark.trace import Tracer, summarize
    scan, states, bundles = state["scan"], state["states"], state["bundles"]
    B, T = bundles.imu.w.shape[:2]
    poses = []
    t0 = time.perf_counter()
    while True:
        poses.append(_pass(scan, states, bundles))
        if time.perf_counter() - t0 >= run.seconds:
            break
    span = time.perf_counter() - t0
    bad = sum(int((~np.isfinite(p).all(axis=-1)).sum()) for p, _ in poses)
    run.counters.update(passes=len(poses), poses=B * T * len(poses), batch=B)
    if run.trace:
        from rvio_tpu_torch.state.filter_state import map_fields
        m = min(run.traffic["trace_frames"], T)
        part = type(bundles)(imu=map_fields(lambda x: x[:, :m], bundles.imu),
                             batch=map_fields(lambda x: x[:, :m],
                                              bundles.batch))
        tracer = Tracer(run.device)
        tracer.start()
        _pass(scan, states, part)
        tracer.stop(B * m)
        run.trace_summary = summarize(tracer, run.cfg, B)
        run.trace_summary["kind"] = "filter"
    return {"end_to_end": {"filter_frames_per_s": B * T * len(poses) / span},
            "attempted": B * T * len(poses), "failed": bad,
            "positions": [p for p, _ in poses]}


def outputs(out) -> list:
    """The window's answers: every pass's (B, T, 3) positions."""
    return out.pop("positions")


def reference(run, state, tf32: bool = False):
    """The reference's first ``check_frames`` frames of every sequence
    (with ``tf32``: the control), (B, n, 3) positions."""
    with pipeline.precision(tf32):
        return pipeline.feature_frames(run.ref_cfg, state["seqs"],
                                       run.traffic["check_frames"], "cpu")


def answers(ref) -> list:
    """The reference's (or the control's) positions as one pass's."""
    return [ref]


def judge(run, passes, ref) -> dict:
    """Every number the check can compare, of every pass's first frames of
    each sequence against the reference (common.Gaps)."""
    gaps = common.Gaps()
    n = ref.shape[1]
    t = np.arange(n)
    for p in passes:
        for b in range(ref.shape[0]):
            gaps.add(t, p[b, :n], t, ref[b])
    return gaps.numbers()


def check(run, state, out):
    passes = outputs(out)
    for k in ("scan", "states", "bundles"):
        state.pop(k, None)
    common.free_device(run.device)
    return common.compared(judge(run, passes, reference(run, state)),
                           run.limits)
