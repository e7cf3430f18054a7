#!/usr/bin/env python3
"""Where images -> poses on the card parts from the CPU plain path.

    python3 scripts/card_vs_cpu.py [--config small|default] [--frames N]
                                   [--dump PATH]
    python3 scripts/card_vs_cpu.py --replay PATH     (CPU only)

For CLAHE off and on it runs ``run_rendered_sequence_scan`` on the card
in f32 (chunks of 32 frames, and twice in chunks of 16) and on the CPU in
f32 (all threads and one) and f64, and prints each run's ATE against the
simulator's ground truth, each run's per-frame position gap to the CPU
f32 run, and the features passing the gate in both at the first frame
where they part by over 1e-3 m.  Then it replays the card's run frame by
frame and, at every frame, gives the card's own tracker and filter states
to the CPU f32 path too:

- tracker: the largest gap between the two paths' new pyramids (CLAHE
  included) and between their tracked positions on slots active in both;
- filter: the CPU step on the card's state and the card's batch, against
  the card's step (position gap, features passing the gate in each);
- kernels: each filter kernel (K1-K4) called by the card's step is held
  against its plain version on the same inputs copied to the CPU: the
  largest error relative to the output's largest entry, NaN mismatches
  and flag flips (for K3, whose rows' basis is free up to a rotation, the
  gap of H^T H, H^T r and r^T r).

``--dump`` saves, for the CLAHE-on replay, the tracker's inputs and both
outputs at every frame whose tracked positions part by over 0.01 px.
``--replay`` reads such a file on the CPU and, for the feature that parts
most in each, prints where it sits at each pyramid level, where ``klt_track``
takes it in f32 and in f64, and where it takes it from start points moved
by 1e-5 to 1e-3 px: how sensitive the tracked function is there.

``small`` is the 320 x 240, 40-slot config of tests/test_torch_cuda.py on
its 6 s sequence (seed 6); ``default`` is ``RVIOConfig()`` on an 8 s
sequence with the settings of chip_smoke.py's workload (seed 7).
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

SHIFTS_PX = (1e-5, -1e-5, 1e-4, -1e-4, 1e-3, -1e-3)


def _setup(name: str, equalizer: bool):
    from rvio_tpu_torch.config import RVIOConfig
    from rvio_tpu_torch.dataio import simulate_sequence
    if name == "small":
        from test_torch_cuda import _small_image_cfg
        cfg = _small_image_cfg(equalizer)
        sim = simulate_sequence(cfg, duration=6.0, static_time=1.0,
                                ramp_time=1.5, seed=6, n_landmarks=400,
                                motion_scale=0.5)
    else:
        cfg = RVIOConfig()
        cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
            cfg.tracker, enable_equalizer=equalizer))
        sim = simulate_sequence(cfg, duration=8.0, static_time=1.5,
                                ramp_time=5.0, seed=7, n_landmarks=2000,
                                motion_scale=0.8, meas_noise=0.001,
                                imu_noise=True)
    return cfg, sim


def _to(x, device):
    """A tensor, tuple or dataclass of tensors on ``device``."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(_to(v, device) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _to(getattr(x, f.name),
                                                     device)
                                         for f in dataclasses.fields(x)})
    return x


def _gap(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(largest |a - b| where both are finite, over the largest |b| there;
    entries finite in one only; bool or integer entries that differ)."""
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.bool or not a.is_floating_point():
        return 0.0, 0, int((a != b).sum())
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    both = fa & fb
    if not both.any():
        return 0.0, int((fa != fb).sum()), 0
    d = (a.double() - b.double()).abs()[both].max()
    scale = b.double().abs()[both].max().clamp(min=1e-30)
    return float(d / scale), int((fa != fb).sum()), 0


def _gram_gap(rk, Hk, rp, Hp) -> float:
    """Largest gap of H^T H, H^T r and r^T r between two projected
    (r, Hx), each over the second's largest entry: what the gate and the
    update use of them, whatever the rows' basis."""
    rk, Hk, rp, Hp = (t.cpu().double() for t in (rk, Hk, rp, Hp))
    worst = 0.0
    for a, b in ((Hk.transpose(1, 2) @ Hk, Hp.transpose(1, 2) @ Hp),
                 ((Hk.transpose(1, 2) @ rk[..., None])[..., 0],
                  (Hp.transpose(1, 2) @ rp[..., None])[..., 0]),
                 ((rk * rk).sum(1), (rp * rp).sum(1))):
        ok = torch.isfinite(a) & torch.isfinite(b)
        if ok.any():
            worst = max(worst, float((a - b).abs()[ok].max()
                                     / b.abs()[ok].max().clamp(min=1e-30)))
    return worst


class KernelShadow:
    """Wraps the filter's kernel wrappers: each call on the card also runs
    the plain version on CPU copies of its inputs, and ``frame`` keeps the
    largest disagreement per kernel since it was last emptied."""

    def __init__(self):
        from rvio_tpu_torch.filter import propagation, update
        from rvio_tpu_torch.ops import (jac_project, lm_triangulate,
                                        propagate_block, spd_solve)
        self.frame = {}
        self._undo = []
        for mod, name, plain in (
                (propagation, "propagate_block",
                 propagate_block.propagate_block_plain),
                (update, "lm_triangulate", lm_triangulate.lm_triangulate_plain),
                (update, "jac_project", jac_project.jac_project_plain),
                (update, "batched_quadform", spd_solve.batched_quadform_plain)):
            kern = getattr(mod, name)
            self._undo.append((mod, name, kern))
            setattr(mod, name, self._wrap(name, kern, plain))

    def _wrap(self, name, kern, plain):
        def call(*args, **kw):
            out = kern(*args, **kw)
            if not any(torch.is_tensor(a) and a.is_cuda for a in args):
                return out
            ref = plain(*_to(args, "cpu"), **_to(kw, "cpu"))
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            err, nan, flips = 0.0, 0, 0
            for o, r in zip(outs, refs):
                e, n, f = _gap(o, r)
                err, nan, flips = max(err, e), nan + n, flips + f
            if name == "jac_project":
                err = max(_gap(outs[2], refs[2])[0],
                          _gram_gap(outs[0], outs[1], refs[0], refs[1]))
            e0, n0, f0 = self.frame.get(name, (0.0, 0, 0))
            self.frame[name] = (max(e0, err), n0 + nan, f0 + flips)
            return out
        return call

    def close(self):
        for mod, name, kern in self._undo:
            setattr(mod, name, kern)


def trajectories(cfg, sim, frames, label, card):
    """ATE of every run; each run's gap to the CPU f32 run per frame.
    Returns the card run in chunks of 32."""
    from rvio_tpu_torch.eval.ate import ate_rmse
    from rvio_tpu_torch.runtime import run_rendered_sequence_scan
    runs = {}
    threads = torch.get_num_threads()
    for tag, dt, dev, chunk, nt in (
            ("card f32", torch.float32, card, 32, threads),
            ("card f32, chunks of 16", torch.float32, card, 16, threads),
            ("card f32, chunks of 16, again", torch.float32, card, 16,
             threads),
            ("CPU f32", torch.float32, "cpu", 32, threads),
            ("CPU f32, one thread", torch.float32, "cpu", 32, 1),
            ("CPU f64", torch.float64, "cpu", 32, threads)):
        torch.set_num_threads(nt)
        r = run_rendered_sequence_scan(cfg, sim, dtype=dt, device=dev,
                                       max_frames=frames, chunk_size=chunk)
        torch.set_num_threads(threads)
        gt = sim.gt_p[np.searchsorted(sim.frame_t, r.timestamps)]
        runs[tag] = r
        st = r.acceptance_stats()
        print(f"{label}: {tag}: {len(r.timestamps)} frames, ATE "
              f"{ate_rmse(r.positions, gt):.6g} m, largest position error "
              f"{float(np.linalg.norm(r.positions - gt, axis=1).max()):.6g} "
              f"m, ransac {st['ransac_inlier_rate']:.4f}, gate reject "
              f"{st['gate_reject_rate']:.4f}, ridge fallbacks "
              f"{int(r.diag['ridge_fallback'].sum())}", flush=True)
    b = runs["CPU f32"]
    for tag, a in runs.items():
        if tag == "CPU f32" or a.positions.shape != b.positions.shape:
            continue
        gap = np.linalg.norm(a.positions - b.positions, axis=1)
        over = np.nonzero(gap > 1e-3)[0]
        first = ("none" if not len(over) else
                 f"{int(over[0])} (features passing the gate {tag} "
                 f"{int(a.n_good[over[0]])}, CPU f32 "
                 f"{int(b.n_good[over[0]])})")
        print(f"{label}: {tag} vs CPU f32: slots agree "
              f"{float((a.active_slots == b.active_slots).mean()):.4f}, "
              f"largest gap {gap.max():.6g} m, first frame over 1e-3 m "
              f"{first}; per frame "
              f"{np.array2string(gap, precision=3, max_line_width=10**6)}",
              flush=True)
    return runs["card f32"]


def lockstep(cfg, sim, frames, label, card_run, card, dump=None):
    """The card's run frame by frame, each frame's step also on the CPU
    from the card's states."""
    from rvio_tpu_torch.dataio.synthetic import render_frame
    from rvio_tpu_torch.filter.propagation import ImuBlock
    from rvio_tpu_torch.frontend import make_tracker
    from rvio_tpu_torch.runtime import bundle_imu, make_filter_step
    from rvio_tpu_torch.runtime.image_driver import (_find_init_frame,
                                                     _imu_chunk_arrays,
                                                     uniform_table)
    from rvio_tpu_torch.runtime.step import FrameBundle
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t,
                        time_offset=cfg.camera.time_offset)
    n = len(sim.frame_t) if frames is None else min(frames, len(sim.frame_t))
    fs, k0 = _find_init_frame(cfg, groups, n, torch.float32, card)
    ks = list(range(k0 + 1, n))
    table = uniform_table(0, len(ks), cfg.tracker.num_features)
    tracker = {d: make_tracker(cfg, d) for d in ("cpu", card)}
    step = {d: make_filter_step(cfg, d) for d in ("cpu", card)}

    def frame(k):
        return torch.as_tensor(np.clip(render_frame(cfg, sim, k), 0,
                                       255).astype(np.uint8))

    ts, _ = tracker[card][0](frame(k0).to(card))
    ch = _imu_chunk_arrays(groups, ks, cfg.tpu.imu_block, torch.float32, card)
    shadow = KernelShadow()
    rows, cases = [], []
    try:
        for i, k in enumerate(ks):
            img, u = frame(k), table[i].float()
            imu = (ch["imu_w"][i], ch["imu_dt"][i], ch["imu_valid"][i])
            new_ts, batch, _ = tracker[card][1](ts, img.to(card), *imu,
                                                u.to(card))
            ts_c, _, _ = tracker["cpu"][1](_to(ts, "cpu"), img,
                                           *_to(imu, "cpu"), u)
            live = new_ts.active.cpu() & ts_c.active
            dpos = (new_ts.pos.cpu() - ts_c.pos).abs().amax(dim=1)
            pos_gap = float(torch.where(live, dpos, torch.zeros(())).max())
            pyr_gap = max(float((a.cpu() - b).abs().max())
                          for a, b in zip(new_ts.pyramid, ts_c.pyramid))
            if pos_gap > 1e-2:
                cases.append({"frame": i, "state": _to(ts, "cpu"),
                              "card": _to(new_ts, "cpu"), "cpu": ts_c})
            bundle = FrameBundle(imu=ImuBlock(
                w=ch["imu_w"][i], a=ch["imu_a"][i], dt=ch["imu_dt"][i],
                valid=ch["imu_valid"][i]), batch=batch)
            shadow.frame = {}
            new_fs, out = step[card](fs, bundle)
            _, out_c = step["cpu"](_to(fs, "cpu"), _to(bundle, "cpu"))
            rows.append((i, pyr_gap, pos_gap,
                         float((out["p_Gk"].cpu() - out_c["p_Gk"]).norm()),
                         int(out["n_good"]), int(out_c["n_good"]),
                         dict(shadow.frame), out["p_Gk"].cpu()))
            ts, fs = new_ts, new_fs
    finally:
        shadow.close()
    replay_gap = max(float((r[-1].double() - torch.as_tensor(p)).norm())
                     for r, p in zip(rows, card_run.positions))
    print(f"{label}: replay vs scan on the card: largest gap "
          f"{replay_gap:.3g} m", flush=True)
    worst = {}
    for i, yg, sg, pg, g, gc, kern, _ in rows:
        for name, (e, nn, f) in kern.items():
            e0, n0, f0 = worst.get(name, (0.0, 0, 0))
            worst[name] = (max(e0, e), n0 + nn, f0 + f)
        ks_ = ", ".join(f"{kk} {e:.2e}/{nn}/{f}"
                        for kk, (e, nn, f) in kern.items())
        print(f"{label}: frame {i}: pyramid gap {yg:.3e} gray, tracked "
              f"position gap {sg:.3e} px; filter step card vs CPU {pg:.3e} "
              f"m, passed {g}/{gc}; kernels (err/NaN/flips) {ks_}",
              flush=True)
    print(f"{label}: over {len(rows)} frames: largest pyramid gap "
          f"{max(r[1] for r in rows):.3e} gray, tracked position gap "
          f"{max(r[2] for r in rows):.3e} px, filter step gap "
          f"{max(r[3] for r in rows):.3e} m, gate decisions differing "
          f"{sum(r[4] != r[5] for r in rows)}; kernels (largest err / NaN "
          f"mismatches / flips) "
          + ", ".join(f"{k} {e:.3g}/{nn}/{f}" for k, (e, nn, f)
                      in worst.items()), flush=True)
    if dump is not None:
        Path(dump).parent.mkdir(parents=True, exist_ok=True)
        torch.save({"config": cfg, "klt_cases": cases}, dump)
        print(f"{label}: saved {len(cases)} tracker cases to {dump}",
              flush=True)


def replay(path: str) -> None:
    """The sensitivity of ``klt_track`` at the saved tracker cases (CPU)."""
    from rvio_tpu_torch.frontend.klt import klt_track
    d = torch.load(path, weights_only=False)
    t = d["config"].tracker
    kw = dict(win=t.klt_window, max_iters=t.klt_max_iters, eps=t.klt_eps,
              min_eig=t.klt_min_eig)

    def track(st, nxt, s, shift, dtype):
        pts = st.pos.to(dtype).clone()
        pts[s, 0] += shift
        p, ok, _ = klt_track([x.to(dtype) for x in st.pyramid],
                             [x.to(dtype) for x in nxt], pts, st.active, **kw)
        return [round(float(v), 4) for v in p[s]], bool(ok[s])

    for c in d["klt_cases"]:
        st, card, cpu = c["state"], c["card"], c["cpu"]
        live = card.active & cpu.active
        gap = torch.where(live, (card.pos - cpu.pos).abs().amax(1),
                          torch.zeros(()))
        s = int(gap.argmax())
        levels = "; ".join(
            f"level {lvl} ({float(p[0]):.2f}, {float(p[1]):.2f}) px, "
            f"{min(float(p[0]), img.shape[1] - 1 - float(p[0]), float(p[1]), img.shape[0] - 1 - float(p[1])):.2f} px from the border"
            for lvl, img in enumerate(st.pyramid)
            for p in [st.pos[s] / 2 ** lvl])
        print(f"frame {c['frame']}, slot {s}: card "
              f"{[round(float(v), 4) for v in card.pos[s]]}, CPU "
              f"{[round(float(v), 4) for v in cpu.pos[s]]} (gap "
              f"{float(gap[s]):.4f} px); from {levels}", flush=True)
        nxt = cpu.pyramid
        for dtype in (torch.float32, torch.float64):
            base = track(st, nxt, s, 0.0, dtype)
            moved = [(sh, *track(st, nxt, s, sh, dtype)) for sh in SHIFTS_PX]
            spread = max(abs(m[1][0] - base[0][0]) + abs(m[1][1] - base[0][1])
                         for m in moved)
            print(f"   klt_track {str(dtype)[6:]}: {base[0]} (status "
                  f"{base[1]}); start moved in x by {SHIFTS_PX} px: "
                  f"{[m[1] for m in moved]}, largest move |dx|+|dy| "
                  f"{spread:.4f} px", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=("small", "default"), default="small")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames of the sequence to run (default: all)")
    ap.add_argument("--dump", default=None,
                    help="torch.save the CLAHE-on replay's tracker cases here")
    ap.add_argument("--replay", default=None,
                    help="analyse a --dump file on the CPU and exit")
    a = ap.parse_args()
    if a.replay is not None:
        torch.set_num_threads(4)
        replay(a.replay)
        return 0
    if not torch.cuda.is_available():
        print("card_vs_cpu: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    torch.set_num_threads(4)
    cuda = torch.device("cuda", 0)
    for equalizer in (False, True):
        cfg, sim = _setup(a.config, equalizer)
        label = f"{a.config}, CLAHE {'on' if equalizer else 'off'}"
        run = trajectories(cfg, sim, a.frames, label, cuda)
        lockstep(cfg, sim, a.frames, label, run, cuda,
                 a.dump if equalizer else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
