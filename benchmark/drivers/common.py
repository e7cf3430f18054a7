"""What the drivers share: seeds, timing, the checks' arithmetic."""

from __future__ import annotations

import numpy as np
import torch


def sim_seed(seed: int, i: int) -> list:
    """The generator seed of sequence i of a run (any whole ``seed``)."""
    return [seed % 2 ** 64, i]


def draw_seed(seed: int) -> int:
    """The RANSAC draws' seed of a run, in the CPU generator's range."""
    return seed % 2 ** 63


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _quantile(g: np.ndarray, q: float) -> float:
    """The ``q`` quantile of gaps by linear interpolation, as numpy's
    default takes it, where an infinite gap weighs as one."""
    s = np.sort(g)
    h = (len(s) - 1) * q
    lo = int(np.floor(h))
    hi = min(lo + 1, len(s) - 1)
    if h == lo or s[hi] == s[lo]:
        return float(s[lo])
    return float(s[lo] + (s[hi] - s[lo]) * (h - lo))


class Gaps:
    """The position gaps of a window's answers to the reference's, track by
    track (a sequence of a pass).  With ``head``, each track is also held
    on its own over its first ``head`` frames."""

    def __init__(self, head: int = 0):
        self.head = head
        self.tracks = []
        self.nonfinite = 0
        self.missing = False

    def add(self, t, p, t_ref, p_ref) -> None:
        """One track's answers (stamps ``t``, (n, 3) positions ``p``) over
        the reference's frames; a frame missing or out of place marks the
        whole window.  A judged frame without a finite position reads as
        an infinite gap (and is counted); a track is compared up to the
        reference's own first frame without a finite position, and a track
        with no frame compared marks the window too."""
        t, t_ref = np.asarray(t), np.asarray(t_ref)
        m = min(len(t), len(t_ref))
        if not np.array_equal(t[:m], t_ref[:m]) or m < len(t_ref):
            self.missing = True
            return
        p = np.asarray(p, np.float64)[:m].reshape(-1, 3)
        q = np.asarray(p_ref, np.float64)[:m].reshape(-1, 3)
        fin = np.isfinite(p).all(axis=1)
        self.nonfinite += int((~fin).sum())
        ref_ok = np.isfinite(q).all(axis=1)
        stop = int(np.argmin(ref_ok)) if not ref_ok.all() else m
        if stop == 0:
            self.missing = True
            return
        g = np.linalg.norm(p[:stop] - q[:stop], axis=1)
        g[~fin[:stop]] = np.inf
        self.tracks.append(g)

    def numbers(self) -> dict:
        """``pose_gap_m``, the widest gap; ``pose_gap_p60_m``, the 60th
        percentile over every compared frame; with ``head``,
        ``pose_gap_track_head_m``, the largest over the tracks of a
        track's widest gap over its first ``head`` frames;
        ``nonfinite_poses``.  A missing frame reads as infinite gaps."""
        inf = float("inf")
        out = {"nonfinite_poses": float(self.nonfinite)}
        if self.missing or not self.tracks:
            out.update(pose_gap_m=inf, pose_gap_p60_m=inf)
            if self.head:
                out["pose_gap_track_head_m"] = inf
            return out
        g = np.concatenate(self.tracks)
        out.update(pose_gap_m=float(g.max()), pose_gap_p60_m=_quantile(g, 0.6))
        if self.head:
            out["pose_gap_track_head_m"] = max(float(x[:self.head].max())
                                               for x in self.tracks)
        return out


def compared(numbers: dict, limits: dict) -> dict:
    """The numbers the cell's limits file names, each beside its limit.
    A value past any float (a missing or misplaced frame) reads as the
    largest float, so the line stays strict JSON.  Without a limits file
    every number is shown against -1, which no reading meets."""
    names = [k for k in limits if not k.startswith("about")] or list(numbers)
    out = {}
    for k in names:
        v = float(numbers[k])
        if not np.isfinite(v):
            v = float(np.finfo(np.float64).max)
        out[k] = {"value": v, "limit": float(limits.get(k, -1.0))}
    return out


def free_device(device: torch.device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
