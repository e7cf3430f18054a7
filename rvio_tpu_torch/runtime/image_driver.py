"""Full-pipeline driver: images -> tracker -> filter (the EuRoC path).

Port of rvio_tpu/runtime/image_driver.py's chunked replay (the reference
node's per-image callback chain, rvio_mono.cc:54-79 -> System::MonoVIO,
System.cc:173-437): frames are rendered or loaded on the host, copied to
the device a chunk at a time as u8 with that chunk's IMU blocks and
RANSAC draws, and each frame runs ``track_fn`` then the filter step.  The
frame loop reads nothing back; each chunk's outputs come back in one go.

RANSAC draws: the JAX package splits a ``jax.random`` key per frame, a
stream torch cannot reproduce.  Here a run draws one (T, N) table of
uniforms from ``torch.Generator("cpu").manual_seed(seed)``, row i for the
i-th frame of the loop, so a card run and a CPU run with one seed use the
same hypotheses; ``uniforms`` replaces the table (the tests pass the JAX
chain's draws through it).

Not carried yet: checkpoint save/resume, the EuRoC file replay, the
photometric stress option and the per-frame ``ImagePipeline``.
"""

from __future__ import annotations

import time
from dataclasses import fields, replace
from typing import Optional

import numpy as np
import torch

from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.device import resolve_device
from rvio_tpu_torch.filter.propagation import ImuBlock
from rvio_tpu_torch.frontend.tracker import make_tracker
from rvio_tpu_torch.runtime.driver import (DriverResult, InitializationGate,
                                           bundle_imu)
from rvio_tpu_torch.runtime.step import FrameBundle, make_filter_step

# per-frame acceptance counters (see DriverResult.acceptance_stats)
_DIAG_KEYS = ("n_tracked", "n_lost", "n_new", "n_usable", "tl_good_sum",
              "ridge_fallback")
_POSE_KEYS = ("p_Gk", "q_kG", "v_k", "n_good")


def _find_init_frame(cfg: RVIOConfig, groups, n: int, dtype, device):
    """Host-side init gate: the first frame index with a built filter state."""
    gate = InitializationGate(cfg, dtype, device)
    for k in range(n):
        w, a, dts = groups[k]
        if len(w) < 2:
            continue
        st = gate.feed(w, a, dts)
        if st is not None:
            return st, k
    raise RuntimeError("sequence never initialized")


def _imu_chunk_arrays(groups, ks, K: int, dtype, device):
    """One chunk's IMU groups padded to K samples, stacked, on the device;
    ``ok`` is False for frames with < 2 samples (InputBuffer.cc:75-76)."""
    B = len(ks)
    cw = np.zeros((B, K, 3))
    ca = np.zeros((B, K, 3))
    cdt = np.zeros((B, K))
    cv = np.zeros((B, K), bool)
    ok = np.zeros(B, bool)
    for i, k in enumerate(ks):
        w, a, dts = groups[k]
        m = min(len(w), K)
        cw[i, :m] = w[:m]
        ca[i, :m] = a[:m]
        cdt[i, :m] = dts[:m]
        cv[i, :m] = True
        ok[i] = len(w) >= 2

    def put(x, dt):
        return torch.as_tensor(x).to(device=device, dtype=dt)

    return {"imu_w": put(cw, dtype), "imu_a": put(ca, dtype),
            "imu_dt": put(cdt, dtype), "imu_valid": put(cv, torch.bool),
            "ok": put(ok, torch.bool)}


def uniform_table(seed: int, T: int, N: int) -> torch.Tensor:
    """(T, N) f64 RANSAC draws on the CPU: row i is the i-th draw of N
    uniforms from a CPU generator seeded with ``seed`` (so a shorter run's
    table is a prefix of a longer one's)."""
    gen = torch.Generator("cpu").manual_seed(seed)
    rows = [torch.rand(N, generator=gen, dtype=torch.float64)
            for _ in range(T)]
    return torch.stack(rows) if rows else torch.zeros((0, N), dtype=torch.float64)


def _select(ok: torch.Tensor, new, old):
    """``new`` where the 0-d bool ``ok`` holds, else ``old``, field by field
    (a TrackerState or FilterState), without a host sync."""
    def sel(a, b):
        if isinstance(a, tuple):
            return tuple(sel(x, y) for x, y in zip(a, b))
        return torch.where(ok, a, b)
    return replace(new, **{f.name: sel(getattr(new, f.name),
                                       getattr(old, f.name))
                           for f in fields(new)})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _replay_chunks(cfg: RVIOConfig, device, dtype, chunk_size: int, table,
                   groups, cam_t, frame_ids, track_fn, tracker_state,
                   filter_state, get_images, timing_split: bool
                   ) -> DriverResult:
    """The chunked replay loop.

    With ``timing_split`` each chunk runs the tracker over its frames, then
    the filter over them, with a device synchronization after each half:
    the per-frame front-end/back-end split the reference writes to
    time_cost.dat (System.cc:376-379).  Otherwise the two alternate per
    frame and the chunk's whole time goes to the back-end column.  Frames
    with ``ok`` False leave both states untouched (``torch.where``).
    """
    K = cfg.tpu.imu_block
    step = make_filter_step(cfg, device, dtype)
    ts, fs = tracker_state, filter_state
    rows = []
    for c0 in range(0, len(frame_ids), chunk_size):
        ks = frame_ids[c0:c0 + chunk_size]
        B = len(ks)
        ch = _imu_chunk_arrays(groups, ks, K, dtype, device)
        images = torch.as_tensor(get_images(ks)).to(device)
        u = table[c0:c0 + B].to(device=device, dtype=dtype)
        ok = ch["ok"]

        def front(i, ts):
            new_ts, batch, dbg = track_fn(ts, images[i], ch["imu_w"][i],
                                          ch["imu_dt"][i], ch["imu_valid"][i],
                                          u[i])
            return _select(ok[i], new_ts, ts), batch, dbg

        def back(i, fs, batch):
            imu = ImuBlock(w=ch["imu_w"][i], a=ch["imu_a"][i],
                           dt=ch["imu_dt"][i], valid=ch["imu_valid"][i])
            new_fs, out = step(fs, FrameBundle(imu=imu, batch=batch))
            return _select(ok[i], new_fs, fs), out

        outs, dbgs, actives = [], [], []
        t0 = time.perf_counter()
        if timing_split:
            batches = []
            for i in range(B):
                ts, batch, dbg = front(i, ts)
                batches.append(batch)
                dbgs.append(dbg)
                actives.append(ts.active)
            _sync(device)
            t1 = time.perf_counter()
            for i in range(B):
                fs, out = back(i, fs, batches[i])
                outs.append(out)
        else:
            t1 = t0
            for i in range(B):
                ts, batch, dbg = front(i, ts)
                fs, out = back(i, fs, batch)
                dbgs.append(dbg)
                actives.append(ts.active)
                outs.append(out)
        _sync(device)
        t2 = time.perf_counter()
        host = {k: torch.stack([o[k] for o in outs]).cpu().numpy()
                for k in _POSE_KEYS + ("n_usable", "tl_good_sum",
                                       "ridge_fallback")}
        host.update({k: torch.stack([d[k] for d in dbgs]).cpu().numpy()
                     for k in ("n_tracked", "n_lost", "n_new")})
        host["active"] = torch.stack(actives).cpu().numpy()
        ok_h = ok.cpu().numpy()
        fe_ms = (t1 - t0) * 1e3 / B
        be_ms = (t2 - t1) * 1e3 / B
        for i, k in enumerate(ks):
            if ok_h[i]:
                rows.append((cam_t[k], host["p_Gk"][i], host["q_kG"][i],
                             host["v_k"][i], int(host["n_good"][i]), fe_ms,
                             be_ms, {d: int(host[d][i]) for d in _DIAG_KEYS},
                             host["active"][i]))
    if not rows:
        raise RuntimeError("no frames processed")
    t, p, q, v, g, fe, be, dg, act = zip(*rows)
    diag = {k: np.asarray([d[k] for d in dg]) for k in _DIAG_KEYS}
    return DriverResult(np.asarray(t), np.asarray(p), np.asarray(q),
                        np.asarray(v), np.asarray(g), np.asarray(fe),
                        np.asarray(be), diag=diag,
                        active_slots=np.asarray(act))


def run_rendered_sequence_scan(cfg: RVIOConfig, sim, dtype=torch.float32,
                               device=None, seed: int = 0,
                               chunk_size: int = 32,
                               max_frames: Optional[int] = None,
                               timing_split: bool = False,
                               uniforms=None) -> DriverResult:
    """Run the full image pipeline on simulator-rendered frames.

    The flagship accuracy workload: frames are rendered at the configured
    resolution from the synthetic sequence's landmarks (u8, on the host)
    and replayed through pyramid, KLT, RANSAC, lifecycle and the filter.
    ``device=None`` means the CUDA device (raises without one).
    ``uniforms``: optional (>= T, N) RANSAC draws, row i for the i-th frame
    after the init frame; default: :func:`uniform_table` of ``seed``.
    """
    from rvio_tpu_torch.dataio.synthetic import render_frame

    device = resolve_device(device)
    init_fn, track_fn = make_tracker(cfg, device, dtype)
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t,
                        time_offset=cfg.camera.time_offset)
    n = len(sim.frame_t) if max_frames is None else min(max_frames,
                                                        len(sim.frame_t))
    filter_state, k0 = _find_init_frame(cfg, groups, n, dtype, device)

    def render_u8(k):
        return np.clip(render_frame(cfg, sim, k), 0, 255).astype(np.uint8)

    tracker_state, _ = init_fn(torch.as_tensor(render_u8(k0)))
    frame_ids = list(range(k0 + 1, n))
    N = cfg.tracker.num_features
    if uniforms is None:
        table = uniform_table(seed, len(frame_ids), N)
    else:
        table = torch.as_tensor(np.asarray(uniforms, np.float64))
        if table.shape[0] < len(frame_ids) or table.shape[1:] != (N,):
            raise ValueError(f"uniforms has shape {tuple(table.shape)}; the "
                             f"run needs ({len(frame_ids)}, {N})")

    def get_images(ks):
        return np.stack([render_u8(k) for k in ks])

    return _replay_chunks(cfg, device, dtype, chunk_size, table, groups,
                          sim.frame_t, frame_ids, track_fn, tracker_state,
                          filter_state, get_images, timing_split)
