"""The reference's frame loops, in plain PyTorch over the frozen copy.

Each loop works out again, from the benchmark's generated inputs alone,
what the port's set-up and timed path derive from them: the init gate
and its first state, the tracker's first frame, the padded IMU blocks,
the RANSAC draws and every frame's tracker and filter step.  It runs
frame after frame, eagerly, on the CPU, in the configuration's float32
(on the card the plain operations break ties of the tracker's
selections in another order than the kernels and the CPU do, so the
two part from the first frame; the CPU's plain float32 meets the
kernels).  The control, the step below float32 with TF32 off, runs the
same loops with every matrix product's operands rounded to TF32 as the
card's tensor cores take them (:func:`precision`).

The loops follow the port's drivers: ``image_frames`` the set replay
(runtime/replay_set.py, B sequences in lockstep, frame j after each
sequence's init frame drawing row j of the seed's table) and the live
driver at B = 1; ``feature_frames`` the batched feature-level filter
(runtime/step.py make_batched_sequence_scan, sequential propagation).
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, fields, replace
from typing import List, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

from benchmark.reference.rvio_plain.core.so3 import rodrigues_np
from benchmark.reference.rvio_plain.filter.propagation import (ImuBlock,
                                                              pad_imu,
                                                              propagate)
from benchmark.reference.rvio_plain.filter.update import (UpdateBatch,
                                                          msckf_update)
from benchmark.reference.rvio_plain.frontend.tracker import (
    make_batched_tracker, make_tracker, stack_tracker_states)
from benchmark.reference.rvio_plain.state import (augment_window,
                                                  compose_state,
                                                  stack_states,
                                                  static_initialize)


def round_tf32(x):
    """A float32 tensor's values rounded to TF32 (10 mantissa bits, to the
    nearest, ties to even), as a tensor core takes a product's operands;
    anything else as it is."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class _TF32Products(TorchFunctionMode):
    """Every matrix product and convolution with TF32 operands."""

    OPS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
           torch.Tensor.__rmatmul__, torch.mm, torch.Tensor.mm, torch.bmm,
           torch.Tensor.bmm, torch.einsum, torch.addmm, torch.baddbmm,
           torch.nn.functional.linear, torch.nn.functional.conv2d}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.OPS:
            args = tree_map(round_tf32, args)
        return func(*args, **kwargs)


def precision(tf32: bool):
    """The loops run inside in float32 (``tf32`` False) or with TF32
    products (the control)."""
    return _TF32Products() if tf32 else nullcontext()


class InitializationGate:
    """The static-window motion gate and bias initializer (a copy of the
    port's runtime/driver.py InitializationGate)."""

    def __init__(self, cfg, dtype, device):
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.w_sum = np.zeros(3)
        self.a_sum = np.zeros(3)
        self.n_imu = 0
        self.moving = False
        self.cum_dev = np.zeros(3)
        self.frozen = False
        self._frames: list = []
        self.dR = np.eye(3)

    def feed(self, w, a, dts):
        cfg = self.cfg
        if not self.moving:
            ang = np.zeros(3)
            vel = np.zeros(3)
            displ = np.zeros(3)
            for wi, ai, dt in zip(w, a, dts):
                a_c = ai - cfg.imu.gravity * ai / max(np.linalg.norm(ai), 1e-12)
                ang = ang + dt * wi
                vel = vel + dt * a_c
                displ = displ + dt * vel + 0.5 * dt ** 2 * a_c
            if (np.linalg.norm(ang) > cfg.init.threshold_angle
                    or np.linalg.norm(displ) > cfg.init.threshold_displ):
                self.moving = True

        if not self.moving:
            if cfg.init.freeze_bias_average and not self.frozen:
                w_mean = (self.w_sum / self.n_imu if self.n_imu > 0
                          else np.asarray(w[0], float))
                self.cum_dev = self.cum_dev + (
                    dts[:, None] * (np.asarray(w) - w_mean)).sum(axis=0)
                if (np.linalg.norm(self.cum_dev)
                        > 0.5 * cfg.init.threshold_angle):
                    self.frozen = True
                    drop_t = 0.0
                    dropped = []
                    while (self._frames and drop_t < 0.6
                           and self.n_imu - self._frames[-1][2] >= 20):
                        ws, as_, n, dt_f = self._frames.pop()
                        self.w_sum -= ws
                        self.a_sum -= as_
                        self.n_imu -= n
                        drop_t += dt_f
                        dropped.append((ws, n, dt_f))
                    w_mean = (self.w_sum / self.n_imu if self.n_imu > 0
                              else np.zeros(3))
                    for ws, n, dt_f in reversed(dropped):
                        self.dR = self.dR @ rodrigues_np(
                            ws / max(n, 1) - w_mean, dt_f)
            if not self.frozen:
                self.w_sum += w.sum(axis=0)
                self.a_sum += a.sum(axis=0)
                self.n_imu += len(w)
                if cfg.init.freeze_bias_average:
                    self._frames.append((w.sum(axis=0), a.sum(axis=0),
                                         len(w), float(np.sum(dts))))
            else:
                w_mean = (self.w_sum / self.n_imu if self.n_imu > 0
                          else np.zeros(3))
                for wi, dt in zip(w, dts):
                    self.dR = self.dR @ rodrigues_np(wi - w_mean, dt)
            return None

        if self.n_imu == 0:
            w_avg, a_avg, n = w[0], a[0], 1
        else:
            w_avg = self.w_sum / self.n_imu
            a_avg = self.a_sum / self.n_imu
            n = self.n_imu
        dR = (self.dR if (cfg.init.freeze_bias_average
                          and cfg.init.forward_rotate_attitude) else None)
        return static_initialize(
            w_avg, a_avg, n,
            gravity=cfg.imu.gravity, imu_rate=cfg.imu.rate_hz,
            sigma_a=cfg.imu.sigma_a, sigma_wg=cfg.imu.sigma_wg,
            sigma_wa=cfg.imu.sigma_wa,
            enable_alignment=cfg.init.enable_alignment,
            max_clones=cfg.window_size, sigma_v0=cfg.init.sigma_v0,
            use_bias_estimates=n > 1, dR_since_avg=dR,
            dtype=self.dtype, device=self.device)


def bundle_imu(imu_t, imu_w, imu_a, frame_t, time_offset: float = 0.0):
    """Per-frame IMU groups: every sample up to the frame's stamp not taken
    by an earlier frame, dt from consecutive stamps (the first 0); a frame
    with fewer than 2 samples gets an empty group and takes none."""
    dts = np.diff(imu_t, prepend=imu_t[0])
    out = []
    start = 0
    for tf in frame_t:
        end = int(np.searchsorted(imu_t, tf + time_offset, side="right"))
        if end - start < 2:
            out.append((np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0)))
            continue
        out.append((imu_w[start:end], imu_a[start:end], dts[start:end]))
        start = end
    return out


def init_frame(cfg, groups, n: int, dtype, device):
    """The first frame index whose IMU fires the gate, and its state."""
    gate = InitializationGate(cfg, dtype, device)
    for k in range(n):
        w, a, dts = groups[k]
        if len(w) < 2:
            continue
        st = gate.feed(w, a, dts)
        if st is not None:
            return st, k
    raise RuntimeError("sequence never initialized")


def uniform_table(seed: int, T: int, N: int) -> torch.Tensor:
    """(T, N) float64 RANSAC draws: row i the i-th draw of N uniforms from
    a CPU generator seeded with ``seed``."""
    gen = torch.Generator("cpu").manual_seed(seed)
    rows = [torch.rand(N, generator=gen, dtype=torch.float64)
            for _ in range(T)]
    return torch.stack(rows) if rows else torch.zeros((0, N),
                                                      dtype=torch.float64)


@dataclass
class FrameBundle:
    imu: ImuBlock
    batch: UpdateBatch


def filter_body(cfg, device, dtype, parallel: bool):
    """One frame of B filters: propagation, the MSCKF update, clone
    augmentation and the robocentric composition."""
    imu_kw = dict(gravity=cfg.imu.gravity, small_angle=cfg.imu.small_angle,
                  sigma_g=cfg.imu.sigma_g, sigma_wg=cfg.imu.sigma_wg,
                  sigma_a=cfg.imu.sigma_a, sigma_wa=cfg.imu.sigma_wa,
                  parallel=parallel)
    upd_kw = dict(R_bc=torch.as_tensor(cfg.camera.R_bc, device=device).to(dtype),
                  t_bc=torch.as_tensor(cfg.camera.t_bc, device=device).to(dtype),
                  sigma_im=cfg.camera.sigma_image,
                  min_clone_states=cfg.min_clone_states,
                  compression=cfg.tpu.compression, fej=cfg.tpu.fej,
                  adaptive_noise=cfg.tpu.adaptive_noise,
                  adaptive_rampup=cfg.tpu.adaptive_rampup_frames,
                  parallel_chains=parallel, feat_reduce=None)

    def body(states, bundles: FrameBundle):
        st = propagate(states, bundles.imu, **imu_kw)
        st, diag = msckf_update(st, bundles.batch, **upd_kw)
        st = augment_window(st)
        st, (q_kG, p_Gk, vk) = compose_state(st)
        return st, {"q_kG": q_kG, "p_Gk": p_Gk, "n_good": diag["n_good"]}

    return body


def _select(ok: torch.Tensor, new, old):
    """``new`` where ``ok`` (B,) holds, else ``old``, field by field."""
    def sel(a, b):
        if isinstance(a, tuple):
            return tuple(sel(x, y) for x, y in zip(a, b))
        return torch.where(ok.reshape(ok.shape + (1,) * (a.dim() - ok.dim())),
                           a, b)
    return replace(new, **{f.name: sel(getattr(new, f.name),
                                       getattr(old, f.name))
                           for f in fields(new)})


def _imu_frame(groups, k: Optional[int], K: int):
    """One frame's padded IMU block as host arrays and its ok flag (False
    for no frame or fewer than 2 samples)."""
    if k is None:
        return np.zeros((K, 3)), np.zeros((K, 3)), np.zeros(K), \
            np.zeros(K, bool), False
    w, a, dts = groups[k]
    m = min(len(w), K)
    pw, pa, pdt = np.zeros((K, 3)), np.zeros((K, 3)), np.zeros(K)
    pw[:m], pa[:m], pdt[:m] = w[:m], a[:m], dts[:m]
    return pw, pa, pdt, np.arange(K) < m, len(w) >= 2


@dataclass
class ImageSeq:
    """What the reference is given of one image sequence: the IMU stream,
    the frame stamps and the u8 frames (any indexable of (H, W) arrays)."""

    imu_t: np.ndarray
    imu_w: np.ndarray
    imu_a: np.ndarray
    cam_t: np.ndarray
    images: object


def image_frames(cfg, seqs: List[ImageSeq], seed: int, n_frames: int,
                 device, dtype=torch.float32) -> List[dict]:
    """Images -> poses for B sequences in lockstep, the first ``n_frames``
    frames after each sequence's init frame.  Returns, per sequence, the
    ok frames' stamps, positions (n, 3), attitudes (n, 4) and tracker
    slots' active flags (n, N), as host arrays."""
    device = torch.device(device)
    K = cfg.tpu.imu_block
    N = cfg.tracker.num_features
    B = len(seqs)
    init_fn, _ = make_tracker(cfg, device, dtype)
    _, track_fn = make_batched_tracker(cfg, device, dtype)
    body = filter_body(cfg, device, dtype, cfg.tpu.parallel_propagation)
    groups_l, frames_l, t_states, f_states = [], [], [], []
    for seq in seqs:
        groups = bundle_imu(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t,
                            cfg.camera.time_offset)
        fs, k0 = init_frame(cfg, groups, len(seq.cam_t), dtype, device)
        ts, _ = init_fn(torch.as_tensor(np.asarray(seq.images[k0]),
                                        device=device))
        groups_l.append(groups)
        frames_l.append(list(range(k0 + 1, len(seq.cam_t))))
        t_states.append(ts)
        f_states.append(fs)
    n_frames = min(n_frames, max(len(f) for f in frames_l))
    # the port takes the draws in float32: the reference takes the same
    # numbers
    table = uniform_table(seed, n_frames, N).float().to(dtype)
    ts, fs = stack_tracker_states(t_states), stack_states(f_states)
    H, W = cfg.camera.height, cfg.camera.width
    outs = [{"t": [], "p": [], "q": [], "active": []} for _ in range(B)]
    for j in range(n_frames):
        ks = [f[j] if j < len(f) else None for f in frames_l]
        imu = [_imu_frame(g, k, K) for g, k in zip(groups_l, ks)]
        w, a, dt, valid, ok = (np.stack(x) for x in zip(*imu))
        img = np.stack([np.asarray(s.images[k]) if k is not None
                        else np.zeros((H, W), np.uint8)
                        for s, k in zip(seqs, ks)])
        put = lambda x: torch.as_tensor(x, device=device).to(dtype)  # noqa
        okd = torch.as_tensor(ok, device=device)
        blk = ImuBlock(w=put(w), a=put(a), dt=put(dt),
                       valid=torch.as_tensor(valid, device=device))
        u = table[j].to(device).expand(B, N)
        new_ts, batch, _ = track_fn(ts, torch.as_tensor(img, device=device),
                                    blk.w, blk.dt, blk.valid, u)
        ts = _select(okd, new_ts, ts)
        new_fs, out = body(fs, FrameBundle(imu=blk, batch=batch))
        fs = _select(okd, new_fs, fs)
        p = out["p_Gk"].double().cpu().numpy()
        q = out["q_kG"].double().cpu().numpy()
        act = ts.active.cpu().numpy()
        for i in range(B):
            if ok[i]:
                outs[i]["t"].append(seqs[i].cam_t[ks[i]])
                outs[i]["p"].append(p[i])
                outs[i]["q"].append(q[i])
                outs[i]["active"].append(act[i])
    return [{k: np.asarray(v) for k, v in o.items()} for o in outs]


def feature_frames(cfg, seqs, n_frames: int, device,
                   dtype=torch.float32) -> np.ndarray:
    """The feature-level filter for B sequences in lockstep from each
    one's init frame (that frame's update batch included), cut to the
    shortest; returns the first ``n_frames`` frames' positions (B, n, 3).
    ``seqs`` hold imu_t/imu_w/imu_a/frame_t and the feature batches."""
    device = torch.device(device)
    K = cfg.tpu.imu_block
    states, starts = [], []
    for s in seqs:
        groups = bundle_imu(s.imu_t, s.imu_w, s.imu_a, s.frame_t)
        st, k0 = init_frame(cfg, groups, len(s.frame_t), dtype, device)
        states.append(st)
        starts.append((groups, k0))
    T = min(len(s.frame_t) - k0 for s, (_, k0) in zip(seqs, starts))
    n_frames = min(n_frames, T)
    body = filter_body(cfg, device, dtype, False)
    fs = stack_states(states)
    put = lambda x, t=dtype: torch.as_tensor(np.stack(x), device=device).to(t)  # noqa
    pos = []
    for j in range(n_frames):
        imu = [pad_imu(*g[k0 + j], K) for g, k0 in starts]
        w, a, dt, valid = zip(*imu)
        ks = [k0 + j for _, k0 in starts]
        batch = UpdateBatch(
            meas=put([s.feat_meas[k] for s, k in zip(seqs, ks)]),
            track_len=put([s.feat_len[k] for s, k in zip(seqs, ks)],
                          torch.int64),
            is_type2=put([s.feat_type2[k] for s, k in zip(seqs, ks)],
                         torch.bool),
            valid=put([s.feat_valid[k] for s, k in zip(seqs, ks)],
                      torch.bool))
        blk = ImuBlock(w=put(w), a=put(a), dt=put(dt),
                       valid=put(valid, torch.bool))
        fs, out = body(fs, FrameBundle(imu=blk, batch=batch))
        pos.append(out["p_Gk"].double().cpu().numpy())
    return np.stack(pos, 1)
