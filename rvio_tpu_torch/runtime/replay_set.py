"""Batched multi-sequence replay: a dataset set through one card in lockstep.

Port of rvio_tpu/runtime/replay_set.py.  The reference evaluates EuRoC one
``rosbag play`` at a time (reference: README.md:70-86); replaying the set
is the natural batched workload (BASELINE.json: "EuRoC V1/V2 easy+medium
set, fixed 200-feature window, single chip").  B sequences advance frame
by frame through :func:`make_batched_image_chunk_scan`, so every image and
filter kernel launches once a frame for the B sequences.

Sequences may differ in length and initialization time: each has its own
init gate and first frame, and a sequence that runs out is padded with
``ok = False`` frames, whose carries stay frozen and whose rows are
dropped (the masking the single scan uses for degenerate frames).  A chunk
of B·T frames is copied to the device once and its outputs read back once.

Draws: the JAX function gives every sequence the same seed's key chain, so
here sequence i's j-th frame after its init frame takes row j of
``uniform_table(seed, ...)``, the row its own ``run_euroc_sequence_scan``
with that seed uses: each sequence's result is its single replay's.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.device import resolve_device
from rvio_tpu_torch.frontend.tracker import make_tracker, stack_tracker_states
from rvio_tpu_torch.runtime.driver import DriverResult, bundle_imu
from rvio_tpu_torch.runtime.image_driver import (
    _driver_result, _find_init_frame, _FrameReader, _host_outputs,
    _imu_chunk_host, _row, _to_device, make_batched_image_chunk_scan,
    uniform_table)
from rvio_tpu_torch.state.filter_state import stack_states
from rvio_tpu_torch.utils import profiling
from rvio_tpu_torch.utils.profiling import span


def run_sequence_set(cfg: RVIOConfig, seqs: Sequence, dtype=torch.float32,
                     device=None, chunk_size: int = 32, seed: int = 0,
                     progress: bool = False,
                     max_frames: Optional[int] = None) -> List[DriverResult]:
    """Replay B sequences batched on one card; one DriverResult each.

    ``seqs`` entries need imu_t/imu_w/imu_a/cam_t plus frames as either
    in-memory ``images`` (a bag, or frames held in memory) or
    ``cam_files`` (an ASL folder).  All sequences share the camera
    geometry of ``cfg``.  ``device=None`` means the CUDA device (raises
    without one).  A result's ``backend_ms`` is its chunk's wall time over
    the chunk's ok frames of all sequences, and ``image_s`` the host
    seconds spent producing that sequence's frames.

    Spans (utils/profiling.py; ``pass_no`` the process's count of passes
    before this one, ``chunk`` the chunk's index): ``replay.init`` up to
    the first chunk (init gates, first frames, the scan built), then a
    chunk's ``replay.assemble`` (host arrays), ``replay.upload``,
    ``replay.scan`` (the host's call), ``replay.readback`` (the outputs to
    the host, which waits for the card) and ``replay.rows``, and once more
    ``replay.rows`` for the results; the count ``replay.poses`` adds the
    ok frames returned, and the call ends with the mark ``replay.pass``.
    """
    device = resolve_device(device)
    B = len(seqs)
    if B == 0:
        return []
    K = cfg.tpu.imu_block
    H, W = cfg.camera.height, cfg.camera.width
    N = cfg.tracker.num_features
    pass_no = profiling.count("replay.init")
    groups_l, frames_l, t_states, f_states = [], [], [], []
    readers: List[_FrameReader] = []
    image_s = [0.0] * B
    try:
        with span("replay.init", pass_no=pass_no):
            init_fn, _ = make_tracker(cfg, device, dtype)
            readers += [_FrameReader(seq) for seq in seqs]
            for i, (seq, reader) in enumerate(zip(seqs, readers)):
                groups = bundle_imu(seq.imu_t, seq.imu_w, seq.imu_a,
                                    seq.cam_t,
                                    time_offset=cfg.camera.time_offset)
                n = len(seq.cam_t)
                if max_frames is not None:
                    n = min(n, max_frames)
                fs, k0 = _find_init_frame(cfg, groups, n, dtype, device)
                t0 = time.perf_counter()
                first = reader.one(k0)
                image_s[i] += time.perf_counter() - t0
                ts, _ = init_fn(torch.as_tensor(first))
                groups_l.append(groups)
                frames_l.append(list(range(k0 + 1, n)))
                t_states.append(ts)
                f_states.append(fs)

            L = max(len(f) for f in frames_l)
            table = uniform_table(seed, L, N)
            scan = make_batched_image_chunk_scan(cfg, device, dtype)
            carry = (stack_tracker_states(t_states), stack_states(f_states))
            rows: List[list] = [[] for _ in range(B)]
        for c0 in range(0, L, chunk_size):
            at = dict(pass_no=pass_no, chunk=c0 // chunk_size)
            with span("replay.assemble", **at):
                T = min(chunk_size, L - c0)
                # the B sequences' frames c0 .. c0 + T (zeros and ok =
                # False past a sequence's end), copied to the device once;
                # an empty chunk gives each IMU leaf's shape and type
                imgs = np.zeros((B, T, H, W), np.uint8)
                empty = _imu_chunk_host(groups_l[0], [], K)
                imu = {k: np.zeros((B, T) + v.shape[1:], v.dtype)
                       for k, v in empty.items()}
                for i in range(B):
                    ks = frames_l[i][c0:c0 + T]
                    if not ks:
                        continue
                    for k, v in _imu_chunk_host(groups_l[i], ks, K).items():
                        imu[k][i, :len(ks)] = v
                    t0 = time.perf_counter()
                    imgs[i, :len(ks)] = readers[i](ks)
                    image_s[i] += time.perf_counter() - t0
            with span("replay.upload", **at):
                chunk = {"image": torch.as_tensor(imgs).to(device),
                         **_to_device(imu, dtype, device),
                         "u": table[c0:c0 + T].to(device=device, dtype=dtype)
                         .expand(B, T, N)}
            t0 = time.perf_counter()
            with span("replay.scan", **at):
                carry, outs = scan(carry, chunk)
            with span("replay.readback", **at):
                host = _host_outputs(outs)
            be_ms = ((time.perf_counter() - t0) * 1e3
                     / max(int(imu["ok"].sum()), 1))
            with span("replay.rows", **at):
                for i in range(B):
                    for j, k in enumerate(frames_l[i][c0:c0 + T]):
                        if host["ok"][i, j]:
                            rows[i].append(_row(host, (i, j),
                                                seqs[i].cam_t[k], 0.0, be_ms))
            if progress:
                print(f"chunk {c0 // chunk_size}: {c0 + T}/{L} frames x {B} "
                      f"sequences", flush=True)
    finally:
        for reader in readers:
            reader.close()

    with span("replay.rows", pass_no=pass_no):
        results = []
        for i in range(B):
            if not rows[i]:
                raise RuntimeError(f"sequence {i} produced no frames")
            res = _driver_result(cfg, rows[i], image_s[i])
            res.decoder = readers[i].decoder
            results.append(res)
        profiling.add("replay.poses", sum(len(r) for r in rows))
    profiling.mark("replay.pass")
    return results
