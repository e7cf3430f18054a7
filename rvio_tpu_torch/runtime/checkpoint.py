"""Checkpoint / resume of the image pipeline's session.

Port of rvio_tpu/runtime/checkpoint.py.  The reference cannot be resumed
mid-sequence (its state lives in RAM, System.cc:83-88); here the complete
session (filter state, tracker state, where the RANSAC draws stand, the
frame cursor) is a flat .npz, in the JAX package's keys: ``filter.<field>``,
``tracker.pos|hist|length|active|pyr<i>`` and ``meta`` = [frame cursor,
timestamp], integers as int32 as there.

The JAX package stores its ``jax.random`` key (``rng_key``).  The port
draws row i of ``uniform_table(seed, T, N)`` for the i-th frame of a run
(runtime/image_driver.py), so it stores ``draws.seed`` and ``draws.row``,
the next row to use.  ``load_checkpoint`` also reads a JAX-written file
(filter and tracker states, no draws); resuming one needs the draws given
explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from rvio_tpu_torch.device import resolve_device
from rvio_tpu_torch.state.filter_state import (FilterState, state_from_numpy,
                                               state_to_numpy)

_FILTER_FIELDS = [f.name for f in dataclasses.fields(FilterState)]


def save_checkpoint(path: str, state: FilterState, *, tracker_state=None,
                    draws: Optional[Tuple[int, int]] = None,
                    frame_cursor: int = 0, timestamp: float = 0.0) -> None:
    """Write the session to ``path`` (.npz).  ``draws`` is (seed, next
    row) of the run's uniform table; None where the run was given its
    draws (then a resume must be given them too)."""
    arrs = {f"filter.{k}": v for k, v in state_to_numpy(state).items()}
    if tracker_state is not None:
        ts = tracker_state
        arrs["tracker.pos"] = ts.pos.cpu().numpy()
        arrs["tracker.hist"] = ts.hist.cpu().numpy()
        arrs["tracker.length"] = ts.length.cpu().numpy().astype(np.int32)
        arrs["tracker.active"] = ts.active.cpu().numpy()
        for i, lvl in enumerate(ts.pyramid):
            arrs[f"tracker.pyr{i}"] = lvl.cpu().numpy()
    if draws is not None:
        arrs["draws.seed"] = np.asarray(draws[0], np.int64)
        arrs["draws.row"] = np.asarray(draws[1], np.int64)
    arrs["meta"] = np.asarray([frame_cursor, timestamp], np.float64)
    np.savez_compressed(path, **arrs)


def load_checkpoint(path: str, dtype=torch.float32, device=None):
    """Returns (filter_state, tracker_state_or_None, draws_or_None,
    frame_cursor, timestamp), the states on ``device`` (``None``: the CUDA
    device).  ``draws`` is (seed, next row), None for a file without them
    (a JAX-written one).  A file from before the FEJ window or the adaptive
    noise scale gets the JAX package's defaults for them (the clones as
    their first estimates, a scale of 1)."""
    device = resolve_device(device)
    with np.load(path) as z:
        d = {}
        for k in _FILTER_FIELDS:
            key = f"filter.{k}"
            if key in z:
                d[k] = z[key]
            elif k == "sigma2_scale":
                d[k] = np.ones(())
            elif k == "clones_fej":
                d[k] = d["clones"].copy()
            else:
                raise KeyError(f"{path}: no {key}")
        state = state_from_numpy(d, device, dtype)

        tracker = None
        if "tracker.pos" in z:
            from rvio_tpu_torch.frontend.tracker import TrackerState

            def f(x):
                return torch.as_tensor(x.astype(np.float64),
                                       device=device).to(dtype)

            pyr, i = [], 0
            while f"tracker.pyr{i}" in z:
                pyr.append(f(z[f"tracker.pyr{i}"]))
                i += 1
            tracker = TrackerState(
                pos=f(z["tracker.pos"]), hist=f(z["tracker.hist"]),
                length=torch.as_tensor(z["tracker.length"].astype(np.int64),
                                       device=device),
                active=torch.as_tensor(z["tracker.active"].astype(bool),
                                       device=device),
                pyramid=tuple(pyr))

        draws = None
        if "draws.seed" in z:
            draws = (int(z["draws.seed"]), int(z["draws.row"]))
        cursor, ts = z["meta"]
    return state, tracker, draws, int(cursor), float(ts)
