"""The benchmark's simulator: a copy of the port's ``simulate_sequence``
(rvio_tpu_torch/dataio/synthetic.py), vectorized over samples and over
feature slots.

It draws from the generator in the original's order, so with the same
arguments it gives the original's sequence: the IMU noise two 3-vectors a
sample, the landmarks, then each frame's measurement noise, one uniform a
visible tracked slot and the refill shuffle.  ``features=False`` leaves
out the feature-slot lifecycle (the image mixes' tracker makes its own
features from the rendered frames) and draws nothing for it.  The drift
corridor of the original is not copied: no mix uses it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Sequence:
    """A generated sequence: the IMU stream, frame stamps, ground truth,
    landmarks and, with ``features``, the per-frame update batches."""

    imu_t: np.ndarray          # (Ni,)
    imu_w: np.ndarray          # (Ni, 3)
    imu_a: np.ndarray          # (Ni, 3)
    frame_t: np.ndarray        # (T,)
    gt_p: np.ndarray           # (T, 3)
    gt_R: np.ndarray           # (T, 3, 3) world from body
    landmarks: np.ndarray      # (NL, 3)
    feat_meas: Optional[np.ndarray] = None    # (T, F, L, 2)
    feat_len: Optional[np.ndarray] = None     # (T, F)
    feat_type2: Optional[np.ndarray] = None   # (T, F)
    feat_valid: Optional[np.ndarray] = None   # (T, F)


def _smoothstep(t, t0, t1):
    x = np.clip((t - t0) / (t1 - t0), 0.0, 1.0)
    s = x ** 3 * (10 - 15 * x + 6 * x ** 2)
    d = (30 * x ** 2 - 60 * x ** 3 + 30 * x ** 4) / (t1 - t0)
    dd = (60 * x - 180 * x ** 2 + 120 * x ** 3) / (t1 - t0) ** 2
    return s, d, dd


def _euler_to_R(yaw, pitch, roll):
    """(n, 3, 3) world-from-body rotations from ZYX Euler angles (n,)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    o, z = np.ones_like(yaw), np.zeros_like(yaw)
    Rz = np.stack([np.stack([cy, -sy, z], -1), np.stack([sy, cy, z], -1),
                   np.stack([z, z, o], -1)], -2)
    Ry = np.stack([np.stack([cp, z, sp], -1), np.stack([z, o, z], -1),
                   np.stack([-sp, z, cp], -1)], -2)
    Rx = np.stack([np.stack([o, z, z], -1), np.stack([z, cr, -sr], -1),
                   np.stack([z, sr, cr], -1)], -2)
    return Rz @ Ry @ Rx


def simulate(cfg, *, duration: float, static_time: float = 1.5,
             ramp_time: float = 2.0, rotation_lead: float = 0.5,
             seed: int = 0, n_landmarks: int = 600, meas_noise: float = 0.0,
             imu_noise: bool = False, motion_scale: float = 1.0,
             drop_prob: float = 0.0, features: bool = True) -> Sequence:
    """The original's sequence for these arguments (see the module
    docstring); ``cfg`` is an RVIOConfig of the port or of the reference
    (only its numbers are read)."""
    rng = np.random.default_rng(seed)
    G = cfg.imu.gravity
    imu_dt = 1.0 / cfg.imu.rate_hz
    frame_dt = 1.0 / cfg.camera.fps

    amp = np.array([1.2, 0.9, 0.45]) * motion_scale
    om = 2 * np.pi * np.array([0.21, 0.17, 0.31])
    ph = np.array([0.0, 1.1, 2.3])
    e_amp = np.array([0.45, 0.3, 0.25]) * motion_scale
    e_om = 2 * np.pi * np.array([0.13, 0.23, 0.19])
    e_ph = np.array([0.5, 1.7, 0.2])
    rot_t0, rot_t1 = static_time, static_time + ramp_time
    ramp_t0 = static_time + rotation_lead
    ramp_t1 = ramp_t0 + ramp_time

    def pos_vel_acc(t):
        t = t[:, None]
        s, sd, sdd = _smoothstep(t, ramp_t0, ramp_t1)
        q = amp * np.sin(om * t + ph)
        qd = amp * om * np.cos(om * t + ph)
        qdd = -amp * om ** 2 * np.sin(om * t + ph)
        q0 = amp * np.sin(om * ramp_t0 + ph)
        p = s * (q - q0)
        v = sd * (q - q0) + s * qd
        a = sdd * (q - q0) + 2 * sd * qd + s * qdd
        return p, v, a

    def R_wb(t):
        s, _, _ = _smoothstep(t[:, None], rot_t0, rot_t1)
        ang = s * e_amp * np.sin(e_om * t[:, None] + e_ph)
        ang0 = s * e_amp * np.sin(e_om * rot_t0 + e_ph)
        d = ang - ang0
        return _euler_to_R(d[:, 0], d[:, 1], d[:, 2])

    def body_rate(t, h=1e-6):
        R0, Rp, Rm = R_wb(t), R_wb(t + h), R_wb(t - h)
        W = np.swapaxes(R0, 1, 2) @ (Rp - Rm) / (2 * h)
        return np.stack([W[:, 2, 1], W[:, 0, 2], W[:, 1, 0]], 1)

    # --- IMU stream (midpoint sampling, as the original) ---
    n_imu = int(round(duration / imu_dt))
    imu_t = (np.arange(n_imu) + 1) * imu_dt
    bg = np.array([0.003, -0.002, 0.004]) if imu_noise else np.zeros(3)
    ba = np.array([0.02, -0.015, 0.01]) if imu_noise else np.zeros(3)
    tm = imu_t - 0.5 * imu_dt
    _, _, a_w = pos_vel_acc(tm)
    R = R_wb(tm)
    imu_w = body_rate(tm) + bg
    f_w = a_w + G * np.array([0.0, 0.0, 1.0])
    imu_a = np.einsum("nji,nj->ni", R, f_w) + ba
    if imu_noise:
        noise = rng.normal(size=(n_imu, 2, 3))
        imu_w = imu_w + cfg.imu.sigma_g / math.sqrt(imu_dt) * noise[:, 0]
        imu_a = imu_a + cfg.imu.sigma_a / math.sqrt(imu_dt) * noise[:, 1]

    # --- landmarks: a shell around the workspace ---
    centers = rng.uniform(-1, 1, size=(n_landmarks, 3))
    radii = rng.uniform(4.0, 9.0, size=(n_landmarks, 1))
    landmarks = centers / np.linalg.norm(centers, axis=1, keepdims=True) * radii

    n_frames = int(duration * cfg.camera.fps) - 1
    frame_t = (np.arange(n_frames) + 1) * frame_dt
    gt_p, _, _ = pos_vel_acc(frame_t)
    gt_R = R_wb(frame_t)
    seq = Sequence(imu_t=imu_t, imu_w=imu_w, imu_a=imu_a, frame_t=frame_t,
                   gt_p=gt_p, gt_R=gt_R, landmarks=landmarks)
    if features:
        _lifecycle(cfg, seq, rng, meas_noise, drop_prob)
    return seq


def _lifecycle(cfg, seq: Sequence, rng, meas_noise: float,
               drop_prob: float) -> None:
    """The tracker-equivalent slot lifecycle of the original, slots as
    arrays: lost slots first, then tracked ones, in slot order."""
    N = cfg.tracker.num_features
    L = cfg.tracker.max_tracking_length
    Lmin = cfg.tracker.min_tracking_length
    F = cfg.tracker.max_update_features
    keep = L - (math.ceil(0.5 * L) - 1)
    R_bc, t_bc = cfg.camera.R_bc, cfg.camera.t_bc
    c = cfg.camera
    T = len(seq.frame_t)
    slot_lm = -np.ones(N, np.int64)
    hist = np.zeros((N, L, 2))
    hlen = np.zeros(N, np.int64)
    meas = np.zeros((T, F, L, 2))
    flen = np.zeros((T, F), np.int32)
    ftype2 = np.zeros((T, F), bool)
    fvalid = np.zeros((T, F), bool)
    for k in range(T):
        R = seq.gt_R[k]
        pc = (seq.landmarks - (seq.gt_p[k] + R @ t_bc)) @ (R @ R_bc)
        z = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            xn = pc[:, 0] / z
            yn = pc[:, 1] / z
        u = c.fx * xn + c.cx
        v = c.fy * yn + c.cy
        vis = ((z > 0.4) & (z < 25.0) & (u > 10) & (u < c.width - 10)
               & (v > 10) & (v < c.height - 10))
        zn = np.stack([xn, yn], 1)
        if meas_noise > 0:
            zn = zn + meas_noise * rng.normal(size=zn.shape)

        held = slot_lm >= 0
        tracked = held & vis[np.clip(slot_lm, 0, None)]
        draws = rng.uniform(size=int(tracked.sum()))
        tracked[tracked] = draws >= drop_prob

        lost = np.flatnonzero(held & ~tracked)
        out_l = lost[hlen[lost] >= Lmin][:F]
        n = len(out_l)
        for j, s in enumerate(out_l):
            meas[k, j, :hlen[s]] = hist[s, :hlen[s]]
        flen[k, :n] = hlen[out_l]
        fvalid[k, :n] = True
        hlen[lost] = 0
        slot_lm[lost] = -1

        trk = np.flatnonzero(tracked)
        full = trk[hlen[trk] == L]
        out_t = full[:max(F - n, 0)]
        for j, s in enumerate(out_t):
            meas[k, n + j] = hist[s]
        flen[k, n:n + len(out_t)] = L
        ftype2[k, n:n + len(out_t)] = True
        fvalid[k, n:n + len(out_t)] = True
        if len(out_t):
            hist[out_t, :keep] = hist[out_t, L - keep:]
            hlen[out_t] = keep
        rest = full[len(out_t):]
        if len(rest):
            hist[rest, :L - 1] = hist[rest, 1:]
            hlen[rest] = L - 1
        hist[trk, hlen[trk]] = zn[slot_lm[trk]]
        hlen[trk] += 1

        free = np.flatnonzero(slot_lm < 0)
        if len(free):
            taken = np.zeros(len(vis), bool)
            taken[slot_lm[slot_lm >= 0]] = True
            cand = np.flatnonzero(vis & ~taken)
            rng.shuffle(cand)
            m = min(len(free), len(cand))
            slot_lm[free[:m]] = cand[:m]
            hist[free[:m], 0] = zn[cand[:m]]
            hlen[free[:m]] = 1
    seq.feat_meas, seq.feat_len = meas, flen
    seq.feat_type2, seq.feat_valid = ftype2, fvalid
