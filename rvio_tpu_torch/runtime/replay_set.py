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
Chunk k + 1 is assembled and sent up while the card runs chunk k: nothing
of a chunk's inputs depends on the chunk before it.

Draws: the JAX function gives every sequence the same seed's key chain, so
here sequence i's j-th frame after its init frame takes row j of
``uniform_table(seed, ...)``, the row its own ``run_euroc_sequence_scan``
with that seed uses: each sequence's result is its single replay's.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.device import resolve_device
from rvio_tpu_torch.frontend.tracker import make_tracker, stack_tracker_states
from rvio_tpu_torch.runtime.driver import DriverResult, bundle_imu
from rvio_tpu_torch.runtime.image_driver import (
    _driver_result, _find_init_frame, _FrameReader, _host_outputs,
    _imu_chunk_host, _row, make_batched_image_chunk_scan, uniform_table)
from rvio_tpu_torch.state.filter_state import stack_states
from rvio_tpu_torch.utils import profiling
from rvio_tpu_torch.utils.profiling import span


# device index -> the stream a set replay's chunks go up on: one a device,
# made at first use (torch hands streams out from a small pool in turn, so a
# stream a pass would in time be the graphs' own stream)
_copy_streams: Dict[int, torch.cuda.Stream] = {}


def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    got = _copy_streams.get(index)
    if got is None:
        got = _copy_streams[index] = torch.cuda.Stream(index)
    return got


class _Staging:
    """Two sets of host buffers that a pass's chunks are assembled into in
    turn, and their uploads.  ``leaves`` maps a name to the (B, T, ...)
    shape of the longest chunk and a dtype; each leaf is one flat tensor,
    of which a chunk of T frames takes the contiguous prefix.

    On a CUDA device the buffers are page-locked, and a chunk goes up on
    the device's copy stream without blocking the host; an event marks its
    copies done, and a buffer is rewritten only once the copies from it
    have completed.  On the CPU a chunk's tensors are the buffers."""

    def __init__(self, leaves: Dict[str, tuple], device: torch.device):
        self.leaves = leaves
        self.device = device
        cuda = device.type == "cuda"
        self.bufs = [{k: torch.empty(math.prod(shape), dtype=dt,
                                     pin_memory=cuda)
                      for k, (shape, dt) in leaves.items()} for _ in range(2)]
        self.copied: List[Optional[torch.cuda.Event]] = [None, None]
        self.stream = _copy_stream(device) if cuda else None
        self.turn = 0

    def take(self, T: int) -> Dict[str, torch.Tensor]:
        """The next buffer set, each leaf (B, T, ...), once the copies
        from it have completed."""
        if self.copied[self.turn] is not None:
            self.copied[self.turn].synchronize()
        out = {}
        for k, (shape, _) in self.leaves.items():
            s = (shape[0], T) + shape[2:]
            out[k] = self.bufs[self.turn][k][:math.prod(s)].view(s)
        return out

    def upload(self, host: Dict[str, torch.Tensor]):
        """The buffer set :meth:`take` gave, on the device: returns the
        tensors and the event the caller's stream must wait for before it
        reads them (None on the CPU)."""
        i, self.turn = self.turn, 1 - self.turn
        if self.stream is None:
            return host, None
        with torch.cuda.stream(self.stream):
            dev = {k: v.to(self.device, non_blocking=True)
                   for k, v in host.items()}
        ev = self.copied[i] = torch.cuda.Event()
        ev.record(self.stream)
        caller = torch.cuda.current_stream(self.device)
        for v in dev.values():
            v.record_stream(caller)
        return dev, ev


def _read_into(reader: _FrameReader, ks, out: np.ndarray) -> None:
    """Frames ``ks`` into ``out`` (len(ks), H, W): frames held in memory
    copied straight in, an ASL folder's as the reader decodes them."""
    if reader.mem is None:
        out[...] = reader(ks)
        return
    for j, k in enumerate(ks):
        out[j] = reader.mem[k]


def run_sequence_set(cfg: RVIOConfig, seqs: Sequence, dtype=torch.float32,
                     device=None, chunk_size: int = 32, seed: int = 0,
                     progress: bool = False,
                     max_frames: Optional[int] = None) -> List[DriverResult]:
    """Replay B sequences batched on one card; one DriverResult each.

    ``seqs`` entries need imu_t/imu_w/imu_a/cam_t plus frames as either
    in-memory ``images`` (a bag, or frames held in memory) or
    ``cam_files`` (an ASL folder).  All sequences share the camera
    geometry of ``cfg``.  ``device=None`` means the CUDA device (raises
    without one).  A result's ``backend_ms`` is its chunk's wall time,
    from the chunk's scan call to its outputs on the host, over the
    chunk's ok frames of all sequences (the next chunk's assembly and
    upload lie inside it), and ``image_s`` the host seconds spent
    producing that sequence's frames.

    Chunks are staged one ahead: after chunk k's scan is launched, chunk
    k + 1 is assembled into page-locked host buffers (two, taken in turn)
    and its copies to the device are enqueued, then chunk k's outputs are
    read back; chunk k + 1's scan is launched next, so the card holds one
    chunk at a time, and chunk k's rows are built while it runs.

    Spans (utils/profiling.py; ``pass_no`` the process's count of passes
    before this one, ``chunk`` the chunk's index): ``replay.init`` up to
    the first chunk (init gates, first frames, the draws uploaded, the
    scan built, the staging buffers), then a chunk's ``replay.assemble``
    (its inputs into a staging buffer), ``replay.upload`` (its copies
    enqueued), ``replay.scan`` (the host's call), ``replay.readback`` (the
    outputs to the host, which waits for the card) and ``replay.rows``,
    and once more ``replay.rows`` for the results; the count
    ``replay.ahead`` adds each chunk staged while the card held the chunk
    before it (chunks - 1 a pass), ``replay.poses`` the ok frames
    returned, and the call ends with the mark ``replay.pass``.
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
            u = uniform_table(seed, L, N).to(device=device, dtype=dtype)
            scan = make_batched_image_chunk_scan(cfg, device, dtype)
            carry = (stack_tracker_states(t_states), stack_states(f_states))
            rows: List[list] = [[] for _ in range(B)]
            # a chunk's frames and IMU groups, floats in dtype
            Tc = min(chunk_size, L)
            empty = _imu_chunk_host(groups_l[0], [], K)
            staging = _Staging(
                {"image": ((B, Tc, H, W), torch.uint8),
                 **{k: ((B, Tc) + v.shape[1:],
                        torch.bool if v.dtype == bool else dtype)
                    for k, v in empty.items()}}, device)

        def stage(c: int):
            """Chunk c's inputs, the B sequences' frames c0 .. c0 + T
            (zeros and ok = False past a sequence's end), assembled into
            the next staging buffers and sent up; returns the chunk, its
            ok frames and the event its copies end with."""
            at = dict(pass_no=pass_no, chunk=c)
            c0 = c * chunk_size
            T = min(chunk_size, L - c0)
            with span("replay.assemble", **at):
                host = staging.take(T)
                arrs = {k: v.numpy() for k, v in host.items()}
                for i in range(B):
                    ks = frames_l[i][c0:c0 + T]
                    for v in arrs.values():
                        v[i, len(ks):] = 0
                    if not ks:
                        continue
                    for k, v in _imu_chunk_host(groups_l[i], ks, K).items():
                        arrs[k][i, :len(ks)] = v
                    t0 = time.perf_counter()
                    _read_into(readers[i], ks, arrs["image"][i, :len(ks)])
                    image_s[i] += time.perf_counter() - t0
                n_ok = int(arrs["ok"].sum())
            with span("replay.upload", **at):
                chunk, copied = staging.upload(host)
                chunk["u"] = u[c0:c0 + T].expand(B, T, N)
            return chunk, n_ok, copied

        def launch(c: int, staged):
            """Chunk c's scan; returns its start, its ok frames and its
            outputs (on the device)."""
            nonlocal carry
            chunk, n_ok, copied = staged
            if copied is not None:
                torch.cuda.current_stream(device).wait_event(copied)
            t0 = time.perf_counter()
            with span("replay.scan", pass_no=pass_no, chunk=c):
                carry, outs = scan(carry, chunk)
            return t0, n_ok, outs

        n_chunks = -(-L // chunk_size)
        launched = launch(0, stage(0)) if n_chunks else None
        for c in range(n_chunks):
            at = dict(pass_no=pass_no, chunk=c)
            if c + 1 < n_chunks:
                # while the card runs chunk c
                staged = stage(c + 1)
                profiling.add("replay.ahead")
            t0, n_ok, outs = launched
            with span("replay.readback", **at):
                host = _host_outputs(outs)
            be_ms = (time.perf_counter() - t0) * 1e3 / max(n_ok, 1)
            if c + 1 < n_chunks:
                launched = launch(c + 1, staged)
            c0 = c * chunk_size
            with span("replay.rows", **at):
                for i in range(B):
                    for j, k in enumerate(frames_l[i][c0:c0 + chunk_size]):
                        if host["ok"][i, j]:
                            rows[i].append(_row(host, (i, j),
                                                seqs[i].cam_t[k], 0.0, be_ms))
            if progress:
                print(f"chunk {c}: {min(c0 + chunk_size, L)}/{L} frames x "
                      f"{B} sequences", flush=True)
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
