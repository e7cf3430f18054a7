#!/usr/bin/env python3
"""Find a filter update whose f32 information factorization needs the wider
ridge, and save its inputs.

    python3 scripts/capture_ridge_case.py OUT.npz [--frames 130] [--duration 60]
        [--seed 7] [--device cpu]

Runs images -> poses (``run_rendered_sequence_scan``, ``RVIOConfig()`` with
the equalizer off, f32) on the first ``--frames`` frames of bench.py's
synthetic workload (60 s and seed 7, or ``--duration`` s and ``--seed``
with the same other settings) and records every ``msckf_update`` call.  At the
first applied update whose Cholesky factorization of C + 1e-8 max(tr C, 1) I
fails (``ridge_fallback``, ops/ekf_tail.py ``info_cholesky``) it saves that
call's filter state and update batch, and those of the two calls before
it, to OUT.npz (keys ``<i>/<field>``, i = 0, 1, 2 oldest first, with
``frame``, the update's index in the run, and ``fallback`` per call).
Prints how many updates needed the wider ridge.  Exits 1 when no update in
the run needed it.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BATCH_FIELDS = ("meas", "track_len", "is_type2", "valid")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--frames", type=int, default=130)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    import rvio_tpu_torch.runtime.step as step_mod
    from rvio_tpu_torch import RVIOConfig
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.runtime import run_rendered_sequence_scan
    from rvio_tpu_torch.state import state_to_numpy

    cfg = RVIOConfig()
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, enable_equalizer=False))
    sim = simulate_sequence(cfg, duration=args.duration, static_time=1.5,
                            ramp_time=5.0, seed=args.seed, n_landmarks=2000,
                            motion_scale=0.8, meas_noise=0.001, imu_noise=True)

    update = step_mod.msckf_update
    recent = collections.deque(maxlen=3)
    saved, n_fallback, n_calls = [], 0, 0

    def recording(state, batch, **kw):
        nonlocal n_fallback, n_calls
        new, diag = update(state, batch, **kw)
        fb = bool(diag["ridge_fallback"])
        n_calls += 1
        n_fallback += fb
        if not saved:
            recent.append((n_calls - 1, fb, state_to_numpy(state),
                           {f: getattr(batch, f).cpu().numpy()
                            for f in BATCH_FIELDS}))
            if fb:
                saved.extend(recent)
        return new, diag

    step_mod.msckf_update = recording
    try:
        run_rendered_sequence_scan(cfg, sim, dtype=torch.float32,
                                   device=args.device, max_frames=args.frames)
    finally:
        step_mod.msckf_update = update
    print(f"{n_calls} updates, {n_fallback} needed the wider ridge")
    if not saved:
        return 1
    out = {}
    for i, (call, fb, st, batch) in enumerate(saved):
        out[f"{i}/frame"] = np.int64(call)
        out[f"{i}/fallback"] = np.bool_(fb)
        out.update({f"{i}/{k}": v for k, v in {**st, **batch}.items()})
    np.savez_compressed(args.out, **out)
    call, _, st, batch = saved[-1]
    print(f"first at update {call}: {int(batch['valid'].sum())} valid lanes; "
          f"saved {len(saved)} updates to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
