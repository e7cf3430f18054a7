"""Full-pipeline drivers: images -> tracker -> filter (the EuRoC path).

Port of rvio_tpu/runtime/image_driver.py (the reference node's per-image
callback chain, rvio_mono.cc:54-79 -> System::MonoVIO, System.cc:173-437):

- the chunk scans: ``make_image_chunk_scan`` runs a chunk of frames,
  tracker then filter a frame, as the JAX package's one-dispatch scan
  does; ``make_frontend_chunk_scan`` and ``make_backend_chunk_scan`` run
  the same frames' two halves one after the other, for the front/back
  time split; ``make_batched_image_chunk_scan`` runs B segments (or
  sequences) in lockstep, a frame of the B one step of the batched
  tracker and filter bodies.  The single scans are those bodies at B = 1.
  On a CUDA device each frame is a replay of a captured CUDA graph
  (runtime/graph.py), on the CPU the same body runs eagerly;
- the chunked replay: frames come to the host (rendered by the simulator,
  ``run_rendered_sequence_scan``, or read from an EuRoC ASL folder or a
  rosbag, ``run_euroc_sequence_scan``), are copied to the device a chunk at
  a time as u8 with that chunk's IMU blocks and RANSAC draws, and run
  through the chunk scans.  The frame loop reads nothing back; each
  chunk's outputs come back in one go.  A file replay can save the session
  after its last chunk and resume from it (runtime/checkpoint.py);
- the per-frame ``ImagePipeline`` the live driver (runtime/online.py) and
  ``run_euroc_sequence`` feed: one frame in (a replay of the same graphed
  frame), one packed pose vector out.

RANSAC draws: the JAX package splits a ``jax.random`` key per frame, a
stream torch cannot reproduce.  Here a run draws one (T, N) table of
uniforms from ``torch.Generator("cpu").manual_seed(seed)``, row i for the
i-th frame of the loop, so a card run and a CPU run with one seed use the
same hypotheses; ``uniforms`` replaces the table (the tests pass the JAX
chain's draws through it).  The chunk scans take the draws as the chunk's
``u`` where the JAX package carries a key.
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import fields, replace
from typing import Optional

import numpy as np
import torch

from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.device import resolve_device
from rvio_tpu_torch.filter.propagation import ImuBlock, pad_imu, propagate
from rvio_tpu_torch.filter.update import UpdateBatch
from rvio_tpu_torch.frontend.tracker import (add_tracker_axis,
                                             drop_tracker_axis,
                                             make_batched_tracker,
                                             make_tracker)
from rvio_tpu_torch.parallel.mesh import klt_splitter, needs_eager
from rvio_tpu_torch.runtime.driver import (DriverResult, InitializationGate,
                                           bundle_imu, landmark_cloud)
from rvio_tpu_torch.runtime.graph import EagerFrameScan, FrameScan
from rvio_tpu_torch.runtime.step import (FrameBundle, _segment_body,
                                         make_filter_step)
from rvio_tpu_torch.state.filter_state import (add_segment_axis,
                                               drop_segment_axis)

# per-frame acceptance counters (see DriverResult.acceptance_stats)
_DIAG_KEYS = ("n_tracked", "n_lost", "n_new", "n_usable", "tl_good_sum",
              "ridge_fallback")
_POSE_KEYS = ("p_Gk", "q_kG", "v_k", "n_good")
_LANDMARK_KEYS = ("landmarks", "landmark_ok", "rho")
_IMU_KEYS = ("imu_w", "imu_a", "imu_dt", "imu_valid")
_BATCH_KEYS = ("meas", "track_len", "is_type2", "valid")


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


def _imu_chunk_host(groups, ks, K: int) -> dict:
    """One chunk's IMU groups padded to K samples, stacked, as host
    arrays (f64, and bool masks); ``ok`` is False for frames with < 2
    samples (InputBuffer.cc:75-76)."""
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
    return {"imu_w": cw, "imu_a": ca, "imu_dt": cdt, "imu_valid": cv,
            "ok": ok}


def _to_device(arrays: dict, dtype, device) -> dict:
    """Host arrays on the device: floats in ``dtype``, masks as bool."""
    return {k: torch.as_tensor(v).to(
        device=device, dtype=torch.bool if v.dtype == bool else dtype)
        for k, v in arrays.items()}


def _imu_chunk_arrays(groups, ks, K: int, dtype, device):
    """:func:`_imu_chunk_host` on the device."""
    return _to_device(_imu_chunk_host(groups, ks, K), dtype, device)


def uniform_table(seed: int, T: int, N: int) -> torch.Tensor:
    """(T, N) f64 RANSAC draws on the CPU: row i is the i-th draw of N
    uniforms from a CPU generator seeded with ``seed`` (so a shorter run's
    table is a prefix of a longer one's)."""
    gen = torch.Generator("cpu").manual_seed(seed)
    rows = [torch.rand(N, generator=gen, dtype=torch.float64)
            for _ in range(T)]
    return torch.stack(rows) if rows else torch.zeros((0, N), dtype=torch.float64)


def _draw_table(seed: int, uniforms, T: int, N: int, start: int = 0):
    """The (T, N) draws of a run's T frames: rows ``start:start + T`` of
    :func:`uniform_table` of ``seed``, or the first T rows of
    ``uniforms``."""
    if uniforms is None:
        return uniform_table(seed, start + T, N)[start:]
    table = torch.as_tensor(np.asarray(uniforms, np.float64))
    if table.shape[0] < T or table.shape[1:] != (N,):
        raise ValueError(f"uniforms has shape {tuple(table.shape)}; the run "
                         f"needs ({T}, {N})")
    return table


def _select(ok: torch.Tensor, new, old):
    """``new`` where ``ok`` holds, else ``old``, field by field (a
    TrackerState or FilterState), without a host sync; ``ok`` is (B,), one
    flag a segment of a state with a leading segment axis."""
    def sel(a, b):
        if isinstance(a, tuple):
            return tuple(sel(x, y) for x, y in zip(a, b))
        return torch.where(ok.reshape(ok.shape + (1,) * (a.dim() - ok.dim())),
                           a, b)
    return replace(new, **{f.name: sel(getattr(new, f.name),
                                       getattr(old, f.name))
                           for f in fields(new)})


def _batched_halves(cfg: RVIOConfig, device, dtype, klt=None):
    """One frame's two halves for B segments (every state field and frame
    leaf (B, ...)), each keeping a segment's old state where its ``ok`` is
    False: ``front(ts, frame) -> (ts, batch, debug)`` (the tracker body,
    its KLT stage ``klt`` where given: make_batched_tracker) and
    ``back(fs, frame, batch) -> (fs, outputs)`` (the filter body, its
    window chain in the form ``tpu.parallel_propagation`` picks, as the
    single step's)."""
    _, track_fn = make_batched_tracker(cfg, device, dtype, klt)
    step = _segment_body(cfg, device, dtype, cfg.tpu.parallel_propagation)

    def front(ts, f):
        new_ts, batch, dbg = track_fn(ts, f["image"], f["imu_w"], f["imu_dt"],
                                      f["imu_valid"], f["u"])
        return _select(f["ok"], new_ts, ts), batch, dbg

    def back(fs, f, batch):
        imu = ImuBlock(w=f["imu_w"], a=f["imu_a"], dt=f["imu_dt"],
                       valid=f["imu_valid"])
        new_fs, out = step(fs, FrameBundle(imu=imu, batch=batch))
        return _select(f["ok"], new_fs, fs), out

    return front, back


def _frame_halves(cfg: RVIOConfig, device, dtype, klt=None):
    """The halves of :func:`_batched_halves` for one sequence: the bodies
    at B = 1, the segment axis added and removed as views."""
    front_b, back_b = _batched_halves(cfg, device, dtype, klt)

    def one(f):
        return {k: v[None] for k, v in f.items()}

    def front(ts, f):
        ts, batch, dbg = front_b(add_tracker_axis(ts), one(f))
        return (drop_tracker_axis(ts), drop_segment_axis(batch),
                {k: v[0] for k, v in dbg.items()})

    def back(fs, f, batch):
        fs, out = back_b(add_segment_axis(fs), one(f), add_segment_axis(batch))
        return drop_segment_axis(fs), {k: v[0] for k, v in out.items()}

    return front, back


def _filter_outputs(out, ok):
    """The chunk outputs of the filter half (JAX's keys, the wider-ridge
    flag and the landmarks)."""
    return {"q_kG": out["q_kG"], "p_Gk": out["p_Gk"], "v_k": out["v_k"],
            "n_good": out["n_good"], "ok": ok, "n_usable": out["n_usable"],
            "tl_good_sum": out["tl_good_sum"],
            "ridge_fallback": out["ridge_fallback"],
            **{k: out[k] for k in _LANDMARK_KEYS}}


def _tracker_outputs(ts, dbg):
    return {"n_tracked": dbg["n_tracked"], "n_lost": dbg["n_lost"],
            "n_new": dbg["n_new"], "active": ts.active}


def make_image_chunk_scan(cfg: RVIOConfig, device=None, dtype=torch.float32,
                          mesh=None):
    """Fused tracker + filter scan over a chunk of frames.

    Port of rvio_tpu/runtime/image_driver.py make_image_chunk_scan.
    Returns ``scan(carry, chunk) -> (carry, outputs)`` with

    - carry = (TrackerState, FilterState);
    - chunk = dict of tensors stacked over B frames: ``image`` (B, H, W)
      u8, ``imu_w``/``imu_a`` (B, K, 3), ``imu_dt``/``imu_valid`` (B, K),
      ``ok`` (B,) and ``u`` (B, N), the frames' RANSAC draws (JAX's key
      chain); ``ok`` False frames (fewer than 2 IMU samples,
      InputBuffer.cc:75-76) leave the carry untouched;
    - outputs = per-frame q_kG, p_Gk, v_k, n_good, ok, n_tracked, n_lost,
      n_new, n_usable, tl_good_sum (JAX's keys), ridge_fallback, the
      landmarks (landmarks, landmark_ok, rho) and the tracker's ``active``
      slots, stacked over B.

    ``device=None`` means the CUDA device, where each frame is a replay of
    a captured graph; on the CPU the same body runs eagerly.  The returned
    carry and outputs are copies that later calls leave alone.

    ``mesh``: an optional (seg, feat) mesh (parallel/mesh.py) whose
    ``feat`` axis splits the tracker's KLT stage (frontend/tracker.py);
    the filter runs replicated, as in the JAX function.  With feat > 1 the
    frames run eagerly (the KLT's ``all_reduce`` is not captured).
    """
    device = resolve_device(device)
    front, back = _frame_halves(cfg, device, dtype,
                                klt_splitter(mesh, cfg.tracker.num_features))

    def body(carry, f):
        ts, fs = carry
        ts, batch, dbg = front(ts, f)
        fs, out = back(fs, f, batch)
        return (ts, fs), {**_filter_outputs(out, f["ok"]),
                          **_tracker_outputs(ts, dbg)}

    return (EagerFrameScan if needs_eager(mesh) else FrameScan)(body, device)


def make_frontend_chunk_scan(cfg: RVIOConfig, device=None,
                             dtype=torch.float32):
    """Tracker-only chunk scan: ``scan(ts, chunk) -> (ts, outputs)`` over
    the chunk of :func:`make_image_chunk_scan` (its ``imu_a`` unused).
    Outputs: the stacked UpdateBatches (meas, track_len, is_type2, valid),
    the tracker's counters and ``active`` slots.  The same per-frame math
    and draws as the fused scan, so this then
    :func:`make_backend_chunk_scan` gives the fused scan's trajectory: the
    front-end/back-end split the reference writes to time_cost.dat
    (System.cc:376-379)."""
    device = resolve_device(device)
    front, _ = _frame_halves(cfg, device, dtype)

    def body(ts, f):
        ts, batch, dbg = front(ts, f)
        return ts, {"meas": batch.meas, "track_len": batch.track_len,
                    "is_type2": batch.is_type2, "valid": batch.valid,
                    **_tracker_outputs(ts, dbg)}

    return FrameScan(body, device)


def make_backend_chunk_scan(cfg: RVIOConfig, device=None,
                            dtype=torch.float32):
    """Filter-only chunk scan: ``scan(fs, chunk) -> (fs, outputs)`` where
    the chunk holds ``imu_w``, ``imu_a``, ``imu_dt``, ``imu_valid``, ``ok``
    and the front-end scan's stacked batches (meas, track_len, is_type2,
    valid); outputs are the fused scan's filter keys."""
    device = resolve_device(device)
    _, back = _frame_halves(cfg, device, dtype)

    def body(fs, f):
        batch = UpdateBatch(**{k: f[k] for k in _BATCH_KEYS})
        fs, out = back(fs, f, batch)
        return fs, _filter_outputs(out, f["ok"])

    return FrameScan(body, device)


def make_batched_image_chunk_scan(cfg: RVIOConfig, device=None,
                                  dtype=torch.float32):
    """:func:`make_image_chunk_scan` over a leading segment axis B: B
    independent sequences (or segments) advance in lockstep
    (rvio_tpu/runtime/image_driver.py make_batched_image_chunk_scan).

    Returns ``scan(carry, chunk) -> (carry, outputs)`` with

    - carry = (TrackerState, FilterState), every leaf (B, ...)
      (``stack_tracker_states``, ``stack_states``);
    - chunk leaves (B, T, ...): ``image`` (B, T, H, W) u8, ``imu_w`` /
      ``imu_a`` (B, T, K, 3), ``imu_dt`` / ``imu_valid`` (B, T, K), ``ok``
      (B, T) and ``u`` (B, T, N), the draws, where the JAX function carries
      a key a segment; a segment's ``ok`` False frame leaves that segment's
      carry untouched;
    - outputs: :func:`make_image_chunk_scan`'s keys at (B, T, ...).

    A frame of the B segments is one replay of a captured graph on a CUDA
    device: every image and filter kernel launches once a frame for the
    batch.  Segments never interact; segment b's outputs are those of
    :func:`make_image_chunk_scan` on segment b, which is this body at
    B = 1.  ``device`` ``None`` means the CUDA device; ``scan.frame_scan``
    is the :class:`FrameScan`.  The returned carry and outputs are copies
    that later calls leave alone.
    """
    device = resolve_device(device)
    front, back = _batched_halves(cfg, device, dtype)

    def body(carry, f):
        ts, fs = carry
        ts, batch, dbg = front(ts, f)
        fs, out = back(fs, f, batch)
        return (ts, fs), {**_filter_outputs(out, f["ok"]),
                          **_tracker_outputs(ts, dbg)}

    frames = FrameScan(body, device)

    def scan(carry, chunk):
        carry, outs = frames(carry, {k: v.transpose(0, 1)
                                     for k, v in chunk.items()})
        return carry, {k: v.transpose(0, 1).contiguous()
                       for k, v in outs.items()}

    scan.frame_scan = frames
    return scan


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _replay_chunks(cfg: RVIOConfig, device, dtype, chunk_size: int, table,
                   groups, cam_t, frame_ids, tracker_state, filter_state,
                   get_images, timing_split: bool,
                   checkpoint_path: Optional[str] = None,
                   draws=None) -> DriverResult:
    """The chunked replay loop, through the chunk scans.

    With ``timing_split`` each chunk runs the front-end scan over its
    frames, then the back-end scan over them, with a device
    synchronization after each: the per-frame front-end/back-end split the
    reference writes to time_cost.dat (System.cc:376-379).  Otherwise the
    fused scan runs the chunk and its whole time goes to the back-end
    column.

    ``checkpoint_path``: save the session (filter, tracker, draws, frame
    cursor) after the last chunk; ``draws`` is (seed, row of ``table[0]``)
    where the table comes from a seed, None where it was given.
    """
    K = cfg.tpu.imu_block
    if timing_split:
        front = make_frontend_chunk_scan(cfg, device, dtype)
        back = make_backend_chunk_scan(cfg, device, dtype)
    else:
        fused = make_image_chunk_scan(cfg, device, dtype)
    ts, fs = tracker_state, filter_state
    rows = []
    image_s = 0.0
    for c0 in range(0, len(frame_ids), chunk_size):
        ks = frame_ids[c0:c0 + chunk_size]
        B = len(ks)
        ch = _imu_chunk_arrays(groups, ks, K, dtype, device)
        t_img = time.perf_counter()
        images = get_images(ks)
        image_s += time.perf_counter() - t_img
        ch["image"] = torch.as_tensor(images).to(device)
        ch["u"] = table[c0:c0 + B].to(device=device, dtype=dtype)
        t0 = time.perf_counter()
        if timing_split:
            ts, fo = front(ts, ch)
            _sync(device)
            t1 = time.perf_counter()
            fs, out = back(fs, {**{k: ch[k] for k in _IMU_KEYS + ("ok",)},
                                **{k: fo[k] for k in _BATCH_KEYS}})
            out.update({k: fo[k] for k in ("n_tracked", "n_lost", "n_new",
                                           "active")})
        else:
            t1 = t0
            (ts, fs), out = fused((ts, fs), ch)
        _sync(device)
        t2 = time.perf_counter()
        host = _host_outputs(out)
        fe_ms = (t1 - t0) * 1e3 / B
        be_ms = (t2 - t1) * 1e3 / B
        for i, k in enumerate(ks):
            if host["ok"][i]:
                rows.append(_row(host, i, cam_t[k], fe_ms, be_ms))
    if checkpoint_path and frame_ids:
        from rvio_tpu_torch.runtime.checkpoint import save_checkpoint
        last = frame_ids[-1]
        save_checkpoint(checkpoint_path, fs, tracker_state=ts,
                        draws=None if draws is None else
                        (draws[0], draws[1] + len(frame_ids)),
                        frame_cursor=last, timestamp=float(cam_t[last]))
    if not rows:
        raise RuntimeError("no frames processed")
    return _driver_result(cfg, rows, image_s)


def _host_outputs(out) -> dict:
    """The chunk outputs a replay keeps, read back to the host."""
    return {k: out[k].cpu().numpy() for k in _POSE_KEYS + _LANDMARK_KEYS
            + _DIAG_KEYS + ("active", "ok")}


def _row(host, i, t, fe_ms: float, be_ms: float) -> tuple:
    """Frame ``i`` of the host outputs as a row of :func:`_driver_result`
    (index ``i`` is (frame,) or (segment, frame))."""
    return (t, host["p_Gk"][i], host["q_kG"][i], host["v_k"][i],
            int(host["n_good"][i]), fe_ms, be_ms,
            {d: int(host[d][i]) for d in _DIAG_KEYS}, host["active"][i],
            tuple(host[x][i] for x in _LANDMARK_KEYS))


def _driver_result(cfg: RVIOConfig, rows, image_s: float) -> DriverResult:
    """A replay's DriverResult from its rows (:func:`_row`)."""
    t, p, q, v, g, fe, be, dg, act, lm = zip(*rows)
    diag = {k: np.asarray([d[k] for d in dg]) for k in _DIAG_KEYS}
    cloud = dict(zip(_LANDMARK_KEYS, (np.asarray(x) for x in zip(*lm))),
                 p_Gk=np.asarray(p), q_kG=np.asarray(q))
    return DriverResult(np.asarray(t), np.asarray(p), np.asarray(q),
                        np.asarray(v), np.asarray(g), np.asarray(fe),
                        np.asarray(be), landmarks=landmark_cloud(cfg, cloud),
                        diag=diag, active_slots=np.asarray(act),
                        image_s=image_s)


def run_rendered_sequence_scan(cfg: RVIOConfig, sim, dtype=torch.float32,
                               device=None, seed: int = 0,
                               chunk_size: int = 32,
                               max_frames: Optional[int] = None,
                               timing_split: bool = False,
                               uniforms=None,
                               photometric=None) -> DriverResult:
    """Run the full image pipeline on simulator-rendered frames.

    The flagship accuracy workload: frames are rendered at the configured
    resolution from the synthetic sequence's landmarks (u8, on the host)
    and replayed through pyramid, KLT, RANSAC, lifecycle and the filter.
    ``device=None`` means the CUDA device (raises without one).
    ``uniforms``: optional (>= T, N) RANSAC draws, row i for the i-th frame
    after the init frame; default: :func:`uniform_table` of ``seed``.
    ``photometric``: optional
    :class:`~rvio_tpu_torch.dataio.synthetic.PhotometricStress` applied to
    every rendered frame (exposure steps, vignetting, motion blur along the
    true image motion, noise bursts), as the JAX package applies it.
    """
    from rvio_tpu_torch.dataio.synthetic import (apply_photometric,
                                                 mean_flow, render_frame)

    device = resolve_device(device)
    init_fn, _ = make_tracker(cfg, device, dtype)
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t,
                        time_offset=cfg.camera.time_offset)
    n = len(sim.frame_t) if max_frames is None else min(max_frames,
                                                        len(sim.frame_t))
    filter_state, k0 = _find_init_frame(cfg, groups, n, dtype, device)

    def render_u8(k):
        img = render_frame(cfg, sim, k)
        if photometric is not None:
            img = apply_photometric(img, k, float(sim.frame_t[k]),
                                    photometric, flow=mean_flow(cfg, sim, k),
                                    fps=cfg.camera.fps)
        return np.clip(img, 0, 255).astype(np.uint8)

    tracker_state, _ = init_fn(torch.as_tensor(render_u8(k0)))
    frame_ids = list(range(k0 + 1, n))
    table = _draw_table(seed, uniforms, len(frame_ids),
                        cfg.tracker.num_features)

    def get_images(ks):
        return np.stack([render_u8(k) for k in ks])

    return _replay_chunks(cfg, device, dtype, chunk_size, table, groups,
                          sim.frame_t, frame_ids, tracker_state,
                          filter_state, get_images, timing_split)


class _FrameReader:
    """The frames of a replayed sequence as (B, H, W) u8 host arrays: a
    bag's frames (decoded when the bag was loaded), or an ASL folder's PNGs
    through the native batch loader (threaded C++, native/dataloader.cpp),
    or, where that cannot be built, the pure-python codec.  ``decoder``
    names the choice (DriverResult.decoder)."""

    def __init__(self, seq, n_threads: int = 2):
        self.mem = getattr(seq, "images", None)
        self.files = getattr(seq, "cam_files", None)
        self.loader = None
        if self.mem is not None:
            self.decoder = "bag"
            return
        from rvio_tpu_torch.dataio.native_loader import BatchLoader
        try:
            self.loader = BatchLoader(n_threads=n_threads)
            self.decoder = "native"
        except (OSError, subprocess.CalledProcessError) as e:
            self.decoder = f"python (native loader not built: {e})"

    def one(self, k: int) -> np.ndarray:
        if self.mem is not None:
            return self.mem[k]
        from rvio_tpu_torch.dataio.euroc import load_image
        return load_image(self.files[k], native=self.loader is not None)

    def __call__(self, ks) -> np.ndarray:
        if self.mem is not None:
            return np.stack([self.mem[k] for k in ks])
        first = self.one(ks[0])
        if self.loader is None or len(ks) == 1:
            return np.stack([first] + [self.one(k) for k in ks[1:]])
        self.loader.submit([self.files[k] for k in ks[1:]],
                           width=first.shape[1], height=first.shape[0])
        return np.concatenate([first[None], self.loader.collect()], axis=0)

    def prefetch(self, k: int, like: np.ndarray) -> None:
        """Start decoding frame k (of ``like``'s shape) on the native
        loader's threads; :meth:`take` returns it."""
        if self.loader is not None:
            self.loader.submit([self.files[k]], width=like.shape[1],
                               height=like.shape[0])

    def take(self, k: int) -> np.ndarray:
        """Frame k: the prefetched one where the loader runs."""
        if self.loader is not None:
            return self.loader.collect()[0]
        return self.one(k)

    def close(self) -> None:
        if self.loader is not None:
            self.loader.close()


def run_euroc_sequence_scan(cfg: RVIOConfig, seq, dtype=torch.float32,
                            device=None, chunk_size: int = 32, seed: int = 0,
                            timing_split: bool = False,
                            max_frames: Optional[int] = None,
                            checkpoint_path: Optional[str] = None,
                            resume_from: Optional[str] = None,
                            uniforms=None) -> DriverResult:
    """Replay a loaded sequence (``load_euroc`` or ``load_rosbag``) through
    the chunked pipeline: the same init gate, per-frame work and draws as
    ``run_rendered_sequence_scan``, on the sequence's own frames.
    ``device=None`` means the CUDA device (raises without one).

    ``checkpoint_path`` saves the session after the run; ``resume_from``
    continues a run from its checkpoint (the same sequence): frames up to
    the checkpoint's cursor are skipped, and the draws continue at its row,
    so the two runs together are the uninterrupted run.  A checkpoint
    without draws (one the JAX package wrote) needs ``uniforms``, which
    otherwise replaces the seed's table: row i for the i-th frame this call
    filters.
    """
    device = resolve_device(device)
    init_fn, _ = make_tracker(cfg, device, dtype)
    groups = bundle_imu(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t,
                        time_offset=cfg.camera.time_offset)
    n = len(seq.cam_t) if max_frames is None else min(max_frames,
                                                      len(seq.cam_t))
    start = 0
    if resume_from is not None:
        from rvio_tpu_torch.runtime.checkpoint import load_checkpoint
        filter_state, tracker_state, draws, k0, _ = load_checkpoint(
            resume_from, dtype, device)
        if tracker_state is None:
            raise ValueError(f"{resume_from}: the checkpoint has no tracker "
                             "state (not an image-pipeline session)")
        if draws is not None:
            seed, start = draws
        elif uniforms is None:
            raise ValueError(f"{resume_from}: the checkpoint holds no RANSAC "
                             "draws (written by the JAX package?); pass "
                             "uniforms= with the draws to continue with")
    else:
        filter_state, k0 = _find_init_frame(cfg, groups, n, dtype, device)
    frame_ids = list(range(k0 + 1, n))
    table = _draw_table(seed, uniforms, len(frame_ids),
                        cfg.tracker.num_features, start)
    reader = _FrameReader(seq)
    try:
        t0 = time.perf_counter()
        if resume_from is None:
            tracker_state, _ = init_fn(torch.as_tensor(reader.one(k0)))
        init_s = time.perf_counter() - t0
        res = _replay_chunks(cfg, device, dtype, chunk_size, table, groups,
                             seq.cam_t, frame_ids, tracker_state,
                             filter_state, reader, timing_split,
                             checkpoint_path=checkpoint_path,
                             draws=None if uniforms is not None
                             else (seed, start))
    finally:
        reader.close()
    res.decoder = reader.decoder
    res.image_s += init_s
    return res


def run_euroc_sequence(cfg: RVIOConfig, seq, dtype=torch.float32,
                       device=None, seed: int = 0,
                       max_frames: Optional[int] = None,
                       uniforms=None) -> DriverResult:
    """Replay a loaded sequence frame by frame through ``ImagePipeline``
    (the live path's shape: one frame in, one pose read back), the next
    frame decoded while the current one runs.  Its draws are the scan's
    where every frame has IMU.  ``backend_ms`` is each frame's time from
    the call to its pose on the host."""
    pipe = ImagePipeline(cfg, dtype, seed=seed, device=device,
                         uniforms=uniforms)
    groups = bundle_imu(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t,
                        time_offset=cfg.camera.time_offset)
    n = len(seq.cam_t) if max_frames is None else min(max_frames,
                                                      len(seq.cam_t))
    reader = _FrameReader(seq, n_threads=1)
    rows, image_s = [], 0.0
    try:
        t_img = time.perf_counter()
        img = reader.one(0)
        for k in range(n):
            if k + 1 < n:
                reader.prefetch(k + 1, img)
            image_s += time.perf_counter() - t_img
            t0 = time.perf_counter()
            out = pipe.process_device(seq.cam_t[k], img, *groups[k])
            if out is not None:
                o = pipe.unpack(out)
                rows.append((seq.cam_t[k], o["p_Gk"], o["q_kG"], o["v_k"],
                             o["n_good"], (time.perf_counter() - t0) * 1e3,
                             o["n_usable"], o["tl_good_sum"]))
            t_img = time.perf_counter()
            if k + 1 < n:
                img = reader.take(k + 1)
    finally:
        reader.close()
    if not rows:
        raise RuntimeError("sequence never initialized")
    t, p, q, v, g, be, nu, tl = zip(*rows)
    return DriverResult(np.asarray(t), np.asarray(p), np.asarray(q),
                        np.asarray(v), np.asarray(g), np.zeros(len(t)),
                        np.asarray(be),
                        diag={"n_usable": np.asarray(nu),
                              "tl_good_sum": np.asarray(tl)},
                        image_s=image_s, decoder=reader.decoder)


def upload(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy or tensor) on ``device`` in its own dtype.  From host
    memory to a CUDA device the copy goes through pinned memory and is only
    enqueued (pageable memory would make CUDA wait for the stream); the
    pinned allocator keeps the buffer until the copy is done."""
    t = torch.as_tensor(x)
    if t.device.type != "cpu" or device.type == "cpu":
        return t.to(device)
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.copy_(t)
    return pinned.to(device, non_blocking=True)


_PACK_COUNTERS = ("n_good", "did_update", "n_usable", "tl_good_sum")


class ImagePipeline:
    """Stateful image-in, pose-out pipeline (one instance per sequence).

    Port of rvio_tpu/runtime/image_driver.py:ImagePipeline, on ``device``
    (``None``: the CUDA device; raises without one).  Per frame: the host
    init gate until the filter starts, a detection-only first frame, then
    ``track_fn`` and the filter step as one frame.  A frame whose IMU group overflows
    the static block (a dropped-frame gap) first integrates the surplus
    through propagation-only sub-steps, oldest first.

    RANSAC draws: N f64 uniforms per tracked frame from a CPU generator
    seeded with ``seed``, so the i-th tracked frame gets row i of
    ``uniform_table(seed, T, N)``, as ``run_rendered_sequence_scan`` does
    for a sequence whose every frame has IMU; ``uniforms`` (T, N) replaces
    them (row i for the i-th tracked frame).

    Each frame makes two host-to-device copies, both only enqueued: the
    image (u8 as given) and one packed vector of its IMU block and draws.
    ``track_fn`` and the filter step then run as one replay of a captured
    graph on a CUDA device (runtime/graph.py), eagerly on the CPU; the
    detection-only first frame and the propagation-only sub-steps run
    eagerly.  ``tracker_state`` and ``filter_state`` are the graph's static
    buffers between frames: the next frame overwrites them.
    :meth:`process_device` reads nothing back; :meth:`unpack` reads the
    frame's packed outputs in one copy.
    """

    def __init__(self, cfg: RVIOConfig, dtype=torch.float32, seed: int = 0,
                 device=None, uniforms=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.init_fn, track_fn = make_tracker(cfg, self.device, dtype)
        step = make_filter_step(cfg, self.device, dtype)
        self.gate = InitializationGate(cfg, dtype, self.device)
        self._gen = torch.Generator("cpu").manual_seed(seed)
        self._uniforms = (None if uniforms is None
                          else np.asarray(uniforms, np.float64))
        self.n_tracked = 0
        self.tracker_state = None
        self.filter_state = None
        self._imu_kw = dict(gravity=cfg.imu.gravity,
                            small_angle=cfg.imu.small_angle,
                            sigma_g=cfg.imu.sigma_g, sigma_wg=cfg.imu.sigma_wg,
                            sigma_a=cfg.imu.sigma_a, sigma_wa=cfg.imu.sigma_wa,
                            parallel=cfg.tpu.parallel_propagation)

        def body(carry, f):
            ts, fs = carry
            imu, u = self._unpack_block(f["vec"])
            ts, batch, _ = track_fn(ts, f["image"], imu.w, imu.dt, imu.valid,
                                    u)
            fs, out = step(fs, FrameBundle(imu=imu, batch=batch))
            packed = torch.cat([out["q_kG"], out["p_Gk"], out["v_k"],
                                torch.stack([out[k].to(dtype)
                                             for k in _PACK_COUNTERS])])
            return (ts, fs), {**out, "packed": packed}

        self._frame = FrameScan(body, self.device)

    def upload_image(self, image) -> torch.Tensor:
        """The frame on the device in its own dtype (u8 frames are cast by
        the tracker on the device), the copy enqueued."""
        return upload(image, self.device)

    def _block(self, w, a, dts, draws=None) -> torch.Tensor:
        """One copy of the padded IMU block (and the frame's draws) in the
        working dtype, as one vector on the device."""
        K = self.cfg.tpu.imu_block
        pw, pa, pdt, valid = pad_imu(w, a, dts, K)
        parts = [pw.ravel(), pa.ravel(), pdt, valid.astype(np.float64)]
        if draws is not None:
            parts.append(draws)
        return upload(torch.from_numpy(np.concatenate(parts)).to(self.dtype),
                      self.device)

    def _unpack_block(self, buf: torch.Tensor):
        """The ImuBlock and the draws of a :meth:`_block` vector."""
        K = self.cfg.tpu.imu_block
        imu = ImuBlock(w=buf[:3 * K].view(K, 3), a=buf[3 * K:6 * K].view(K, 3),
                       dt=buf[6 * K:7 * K], valid=buf[7 * K:8 * K] > 0.5)
        return imu, buf[8 * K:]

    def _draws(self) -> np.ndarray:
        if self._uniforms is not None:
            u = self._uniforms[self.n_tracked]
        else:
            u = torch.rand(self.cfg.tracker.num_features, generator=self._gen,
                           dtype=torch.float64).numpy()
        self.n_tracked += 1
        return u

    def _advance(self, image, imu_w, imu_a, imu_dts):
        """Feed one frame; returns its outputs (the graph's static buffers,
        which the next frame overwrites) or None before the first tracked
        frame."""
        cfg = self.cfg
        if len(imu_w) < 2:
            return None
        if self.filter_state is None:
            self.filter_state = self.gate.feed(imu_w, imu_a, imu_dts)
            if self.filter_state is None:
                return None
        img = self.upload_image(image)
        K = cfg.tpu.imu_block
        imu_w, imu_a = np.asarray(imu_w), np.asarray(imu_a)
        imu_dts = np.asarray(imu_dts)
        while len(imu_w) > K:
            blk, _ = self._unpack_block(self._block(imu_w[:K], imu_a[:K],
                                                    imu_dts[:K]))
            self.filter_state = propagate(self.filter_state, blk,
                                          **self._imu_kw)
            imu_w, imu_a, imu_dts = imu_w[K:], imu_a[K:], imu_dts[K:]

        if self.tracker_state is None:
            self.tracker_state, _ = self.init_fn(img)
            return None  # first frame: detection only (Tracker.cc:204-234)

        buf = self._block(imu_w, imu_a, imu_dts, self._draws())
        self._frame.load((self.tracker_state, self.filter_state))
        outs = self._frame.run({"image": img[None], "vec": buf[None]})
        self.tracker_state, self.filter_state = self._frame.carry
        return {k: v[0] for k, v in outs.items()}

    def process(self, t: float, image, imu_w, imu_a, imu_dts):
        """Feed one frame; returns the filter step's outputs (tensors on the
        device, copies later frames leave alone) or None before the first
        tracked frame."""
        out = self._advance(image, imu_w, imu_a, imu_dts)
        if out is None:
            return None
        return {k: v.clone() for k, v in out.items() if k != "packed"}

    def process_device(self, t, image, imu_w, imu_a, imu_dts):
        """Run one frame and return its packed outputs on the device (a
        copy later frames leave alone), with no synchronization (see
        :meth:`unpack`)."""
        out = self._advance(image, imu_w, imu_a, imu_dts)
        if out is None:
            return None
        return out["packed"].clone()

    @staticmethod
    def unpack(v) -> dict:
        """Host dict from a packed output vector (one device-to-host copy)."""
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return {"q_kG": v[0:4], "p_Gk": v[4:7], "v_k": v[7:10],
                "n_good": int(v[10]), "did_update": bool(v[11] > 0.5),
                "n_usable": int(v[12]), "tl_good_sum": int(v[13])}

    def process_packed(self, t, image, imu_w, imu_a, imu_dts):
        """Like :meth:`process` but returns a host dict from one copy (keys
        q_kG, p_Gk, v_k, n_good, did_update, n_usable, tl_good_sum)."""
        dev = self.process_device(t, image, imu_w, imu_a, imu_dts)
        if dev is None:
            return None
        return self.unpack(dev)
