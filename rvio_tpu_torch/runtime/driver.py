"""Sequence driver: sensor bundling, init gate, and offline execution.

Port of rvio_tpu/runtime/driver.py.  Pairs each image with all IMU samples
up to the image time (+ configurable offset, needing >= 2 samples —
reference: InputBuffer.cc:53-81, per-sample dt from consecutive timestamps
with dt=0 for the first sample, rvio_mono.cc:99-107), runs the static-init
motion gate on the host (System.cc:182-249), then drives the per-frame
step over the rest of the sequence.

The driver runs on the CUDA device unless asked for the CPU.  It stacks
every filtered frame's inputs on the host, copies them to the device once,
runs the frame loop (which reads nothing back), and copies the outputs
back once at the end.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.core.so3 import rodrigues_np
from rvio_tpu_torch.device import resolve_device
from rvio_tpu_torch.filter.propagation import ImuBlock, pad_imu
from rvio_tpu_torch.filter.update import UpdateBatch
from rvio_tpu_torch.runtime.step import FrameBundle, make_sequence_scan
from rvio_tpu_torch.state import FilterState, static_initialize


class InitializationGate:
    """Static-window motion detector + bias initializer (host numpy).

    Replica of the reference's init state machine (System.cc:182-249):
    accumulate the static-window gyro/accel averages; on the first frame
    whose integrated angle/displacement exceeds the thresholds, build the
    initial filter state on ``device`` (``None``: the CUDA device).
    """

    def __init__(self, cfg: RVIOConfig, dtype=torch.float32, device=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.w_sum = np.zeros(3)
        self.a_sum = np.zeros(3)
        self.n_imu = 0
        self.moving = False
        # motion-onset detector for the bias-average freeze
        # (init.freeze_bias_average): detrended cumulative angle
        self.cum_dev = np.zeros(3)
        self.frozen = False
        # per-frame sums so the freeze can retroactively trim the
        # onset-to-detection lag (~0.5 s of sub-threshold rotation)
        self._frames: list = []
        # body rotation between the frozen average window and the gate-fire
        # frame (init.forward_rotate_attitude)
        self.dR = np.eye(3)

    def feed(self, w: np.ndarray, a: np.ndarray, dts: np.ndarray
             ) -> Optional[FilterState]:
        """Feed one frame's IMU; returns the initial state once moving."""
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
                # deviation of this frame's rotation from the running mean
                # rate: a constant gyro bias cancels, a slow motion onset
                # accumulates — freeze the bias averages at onset
                w_mean = (self.w_sum / self.n_imu if self.n_imu > 0
                          else np.asarray(w[0], float))
                self.cum_dev = self.cum_dev + (
                    dts[:, None] * (np.asarray(w) - w_mean)).sum(axis=0)
                if (np.linalg.norm(self.cum_dev)
                        > 0.5 * cfg.init.threshold_angle):
                    self.frozen = True
                    # retroactively drop the ~0.6 s detection lag
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
                    # rotation over the trimmed lag (oldest first), each
                    # trimmed frame at its bias-corrected mean rate
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
                # frozen, gate not yet fired: keep integrating the body
                # rotation sample-by-sample (bias-corrected)
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


def bundle_imu(imu_t: np.ndarray, imu_w: np.ndarray, imu_a: np.ndarray,
               frame_t: np.ndarray, *, time_offset: float = 0.0
               ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Split the IMU stream into per-frame groups (InputBuffer semantics).

    Each frame gets all IMU samples with t <= t_frame + offset that were not
    consumed by an earlier frame; per-sample dt comes from consecutive
    timestamps (first overall sample gets dt 0, rvio_mono.cc:102-107).
    Frames with < 2 samples yield empty groups (skipped upstream).
    """
    dts = np.diff(imu_t, prepend=imu_t[0])
    out = []
    start = 0
    for tf in frame_t:
        end = int(np.searchsorted(imu_t, tf + time_offset, side="right"))
        if end - start < 2:
            out.append((np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0)))
            # do not consume: the reference waits for >=2 samples
            continue
        out.append((imu_w[start:end], imu_a[start:end], dts[start:end]))
        start = end
    return out


@dataclass
class DriverResult:
    timestamps: np.ndarray     # (T,)
    positions: np.ndarray      # (T,3) p_Gk
    quaternions: np.ndarray    # (T,4) q_kG (JPL xyzw)
    velocities: np.ndarray     # (T,3)
    n_good: np.ndarray         # (T,)
    # (T,) per-frame front-end time: host bundling (SequenceDriver), or the
    # tracker's share of its chunk's wall time (image driver, timing_split)
    frontend_ms: np.ndarray
    # (T,) the back-end's wall time (device work included: it ends in a
    # readback) spread evenly over the frames of a run or chunk — the frame
    # loop never synchronizes per frame, so per-frame device times do not
    # exist here
    backend_ms: np.ndarray
    landmarks: Optional[np.ndarray] = None  # (NL,3) world-frame cloud
    # (T,) acceptance counters: n_usable (gate candidates), tl_good_sum
    # (summed track length of accepted features), ridge_fallback (the
    # applied update's compression needed the wider ridge, ops/ekf_tail.py
    # info_cholesky); the image driver adds the tracker's n_tracked, n_lost
    # and n_new
    diag: Optional[dict] = None
    # (T, N) bool: the tracker's slots in use after each frame (image driver)
    active_slots: Optional[np.ndarray] = None
    # image drivers: host seconds spent producing the frames (rendering, or
    # decoding a replayed sequence), inside the run's wall time
    image_s: float = 0.0
    # file replay: which decoder produced the frames ("native", the C++
    # batch loader; "python (...)", the pure-python codec and why; "bag",
    # frames decoded when the bag was loaded)
    decoder: Optional[str] = None

    def acceptance_stats(self) -> dict:
        """Front-end quality rates over the run.

        ransac_inlier_rate: KLT+RANSAC survivors / active features;
        gate_reject_rate: chi2-gate rejections / gate candidates
        (Updater.cc:404-454); track_len_mean: mean track length of accepted
        update features.  A rate whose counters the run lacks is absent
        (feature-level replay has no tracker counters).
        """
        out = {"n_good_mean": float(self.n_good.mean())}
        d = self.diag or {}
        if "n_tracked" in d:
            att = d["n_tracked"] + d["n_lost"]
            out["ransac_inlier_rate"] = float(d["n_tracked"].sum()
                                              / max(att.sum(), 1))
        if "n_usable" in d:
            out["gate_reject_rate"] = float(
                1.0 - self.n_good.sum() / max(d["n_usable"].sum(), 1))
        if "tl_good_sum" in d:
            out["track_len_mean"] = float(d["tl_good_sum"].sum()
                                          / max(self.n_good.sum(), 1))
        return out


def landmark_cloud(cfg: RVIOConfig, host: dict) -> Optional[np.ndarray]:
    """The accepted landmark cloud in the world frame from per-frame host
    outputs (``p_Gk``, ``q_kG``, ``landmarks``, ``landmark_ok``, ``rho``,
    each stacked over the T filtered frames): gate-passing features with
    positive inverse depth (Updater.cc:431: publish only if rho > 0), every
    pub_every-th filtered frame (``landmark.pub_rate``, Updater.cc:79-85)."""
    T = len(host["p_Gk"])
    pub_every = max(1, int(round(
        cfg.camera.fps / max(cfg.landmark.pub_rate, 1e-9))))
    lm_rows = []
    for i in range(pub_every - 1, T, pub_every):
        ok = host["landmark_ok"][i] & (host["rho"][i] > 0)
        if ok.any():
            lm_rows.append(host["p_Gk"][i] + host["landmarks"][i][ok]
                           @ _quat_to_rot_np(host["q_kG"][i]))
    return np.concatenate(lm_rows, axis=0) if lm_rows else None


def _quat_to_rot_np(q: np.ndarray) -> np.ndarray:
    """JPL (x,y,z,w) quaternion -> rotation matrix, host-side numpy."""
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y)],
        [2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x)],
        [2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)],
    ])


class SequenceDriver:
    """Offline sequence executor over pre-bundled frames.

    ``device=None`` means CUDA (raises when CUDA is absent); pass
    ``device="cpu"`` for the CPU path.
    """

    def __init__(self, cfg: RVIOConfig, dtype=torch.float32, device=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.run_sequence = make_sequence_scan(cfg, self.device, dtype)

    def run(self, imu_t, imu_w, imu_a, frame_t, batches,
            progress: bool = False,
            collect_landmarks: bool = False) -> DriverResult:
        """Run a full sequence.

        batches: per-frame UpdateBatch-like records of host arrays.
        collect_landmarks: record the accepted landmark cloud in the world
        frame, decimated to ``landmark.pub_rate`` Hz (Updater.cc:79-85,
        431-447).
        """
        cfg = self.cfg
        gate = InitializationGate(cfg, self.dtype, self.device)
        groups = bundle_imu(imu_t, imu_w, imu_a, frame_t,
                            time_offset=cfg.camera.time_offset)
        state0 = None
        ts, fe, rows = [], [], []
        for k, (tf, (w, a, dts)) in enumerate(zip(frame_t, groups)):
            if len(w) < 2:
                continue
            if state0 is None:
                state0 = gate.feed(w, a, dts)
                if state0 is None:
                    continue
            t0 = time.perf_counter()
            b = batches[k]
            rows.append((pad_imu(w, a, dts, cfg.tpu.imu_block),
                         (b.meas, b.track_len, b.is_type2, b.valid)))
            ts.append(tf)
            fe.append((time.perf_counter() - t0) * 1e3)
        if state0 is None:
            raise RuntimeError("sequence never initialized (no motion?)")

        t0 = time.perf_counter()
        bundles = self._stack(rows)
        state, out = self.run_sequence(state0, bundles)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        wall_ms = (time.perf_counter() - t0) * 1e3
        T = len(ts)
        if progress:
            print(f"{T} frames in {wall_ms:.1f} ms")

        lms = landmark_cloud(cfg, host) if collect_landmarks else None
        return DriverResult(
            np.asarray(ts), host["p_Gk"], host["q_kG"], host["v_k"],
            host["n_good"], np.asarray(fe), np.full(T, wall_ms / T),
            landmarks=lms,
            diag={k: host[k] for k in ("n_usable", "tl_good_sum",
                                        "ridge_fallback")})

    def _stack(self, rows) -> FrameBundle:
        """One host-to-device copy per input field for the whole sequence."""
        dev, dt = self.device, self.dtype

        def put(xs, dtype):
            return torch.as_tensor(np.stack(xs), device=dev).to(dtype)

        imus, feats = zip(*rows)
        w, a, dts, valid = zip(*imus)
        meas, tlen, typ2, ok = zip(*feats)
        return FrameBundle(
            imu=ImuBlock(w=put(w, dt), a=put(a, dt), dt=put(dts, dt),
                         valid=put(valid, torch.bool)),
            batch=UpdateBatch(meas=put(meas, dt), track_len=put(tlen, torch.int64),
                              is_type2=put(typ2, torch.bool),
                              valid=put(ok, torch.bool)))


def batches_from_sim(sim) -> List[UpdateBatch]:
    """Per-frame UpdateBatch records (host arrays) from a SyntheticSequence."""
    return [UpdateBatch(meas=sim.feat_meas[k], track_len=sim.feat_len[k],
                        is_type2=sim.feat_type2[k], valid=sim.feat_valid[k])
            for k in range(len(sim.frame_t))]
