"""The front-end: feature lifecycle over fixed-shape slots.

Port of rvio_tpu/frontend/tracker.py (Tracker, reference:
src/rvio/Tracker.cc:179-396).  Every structure is a fixed-shape tensor over
N feature slots, and one ``track_fn`` call runs the whole per-frame
front-end — pyramid, KLT, undistortion, gyro-RANSAC, lifecycle
classification, update-batch assembly, detection refill — without reading
anything back to the host.

Lifecycle rules preserved (Tracker.cc:271-396):
- lost track with history >= nMinTrackingLength  -> type '1' update feature;
- reaching nMaxTrackingLength                    -> type '2' update feature,
  history truncated to the last ceil(L/2) entries if it got into the update
  budget, else popped by one;
- update batch capped at ceil(N/2), lost features first;
- freed slots refilled from spaced Shi-Tomasi detections admitted by the
  chess-grid occupancy test.

The JAX package selects batch rows and pairs refill candidates with
one-hot matmuls (TPU scatters and gathers serialize); the port indexes
directly and gets the same slots, ranks and budget.

There is one tracker body, for B trackers in lockstep (the segments of a
batched replay: a leading axis B on every TrackerState field, image and
IMU block; no ``torch.vmap``, the kernels are ctypes calls).  Every image
kernel launches once for the B images, and every count, rank and
threshold is per segment, as the JAX package's vmapped tracker has them.
:func:`make_batched_tracker` is that body; :func:`make_tracker`'s
single-image entries are it at B = 1, the axis added and removed as views
at their edges.

With a ``mesh`` whose ``feat`` axis has size feat > 1
(parallel/mesh.py), the KLT stage alone is split, as the JAX package's
``shard_map`` splits it (rvio_tpu/frontend/tracker.py:141-153): the
pyramids stay replicated, each rank tracks its N/feat slots (K6 and K8 on
its lanes, so K8's finish applies the T of its own lanes, as each JAX
shard's loop stops at its own), and one ``all_reduce`` of zero-padded
slots gathers the new positions, status and errors; RANSAC, the
lifecycle and the refill run replicated on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from benchmark.reference.rvio_plain.config import RVIOConfig
from benchmark.reference.rvio_plain.device import resolve_device
from benchmark.reference.rvio_plain.filter.update import UpdateBatch
from benchmark.reference.rvio_plain.frontend.detector import (corner_subpix, find_newer,
                                              grid_top_corners,
                                              nms_masked_response)
from benchmark.reference.rvio_plain.frontend.image import build_pyramid, clahe
from benchmark.reference.rvio_plain.frontend.klt import klt_track
from benchmark.reference.rvio_plain.frontend.ransac import (gyro_ransac,
                                            integrate_gyro_rotation)
from benchmark.reference.rvio_plain.frontend.undistort import undistort_normalize
from benchmark.reference.rvio_plain.state.filter_state import drop_segment_axis


@dataclass
class TrackerState:
    """Fixed-shape tracker state carried between frames (each field may
    carry a leading segment axis B: a batched tracker's state)."""

    pos: torch.Tensor       # (N, 2) current distorted pixel positions
    hist: torch.Tensor      # (N, L, 2) undistorted-normalized history
    length: torch.Tensor    # (N,) int64 measurements in history
    active: torch.Tensor    # (N,) bool slot in use
    pyramid: tuple          # previous frame's pyramid (tuple of tensors)


def _tracker_map(fn, ts: TrackerState) -> TrackerState:
    return TrackerState(pos=fn(ts.pos), hist=fn(ts.hist),
                        length=fn(ts.length), active=fn(ts.active),
                        pyramid=tuple(fn(x) for x in ts.pyramid))


def stack_tracker_states(states: Sequence[TrackerState]) -> TrackerState:
    """Stack per-sequence TrackerStates along a new leading segment axis
    (as ``stack_states`` does for FilterStates)."""
    return TrackerState(
        pos=torch.stack([s.pos for s in states]),
        hist=torch.stack([s.hist for s in states]),
        length=torch.stack([s.length for s in states]),
        active=torch.stack([s.active for s in states]),
        pyramid=tuple(torch.stack(level) for level in
                      zip(*(s.pyramid for s in states))))


def add_tracker_axis(ts: TrackerState) -> TrackerState:
    """One tracker's state as a batch of one (views)."""
    return _tracker_map(lambda x: x.unsqueeze(0), ts)


def drop_tracker_axis(ts: TrackerState) -> TrackerState:
    """The only segment of a batch of one, as one tracker's state (views)."""
    return _tracker_map(lambda x: x.squeeze(0), ts)


def _cam_kwargs(cfg: RVIOConfig):
    c = cfg.camera
    return dict(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, k1=c.k1, k2=c.k2,
                p1=c.p1, p2=c.p2, k3=c.k3, fisheye=c.is_fisheye)


def make_tracker(cfg: RVIOConfig, device=None, dtype=torch.float32,
                 mesh=None):
    """Build the front-end entry points on ``device`` (``None``: the CUDA
    device; raises without one):

    init_fn(image) -> (TrackerState, n_active)                (first frame)
    track_fn(state, image, imu_w, imu_dt, imu_valid, u)
        -> (TrackerState, UpdateBatch, debug dict)

    ``image`` is (H, W) gray or (H, W, 3) color of any real dtype (u8 frames
    are cast on the device); ``u`` holds the frame's N uniform RANSAC draws.
    Both are :func:`make_batched_tracker`'s body at B = 1.  ``mesh``:
    an optional (seg, feat) mesh; its ``feat`` axis splits the KLT stage
    (module docstring; parallel/mesh.py ``klt_splitter``).
    """
    klt = None
    if mesh is not None:
        # imported here: the parallel package imports the runtime, which
        # imports this module
        from benchmark.reference.rvio_plain.parallel.mesh import klt_splitter
        klt = klt_splitter(mesh, cfg.tracker.num_features)
    init_b, track_b = make_batched_tracker(cfg, device, dtype, klt)

    def init_fn(image) -> Tuple[TrackerState, torch.Tensor]:
        ts, n = init_b(torch.as_tensor(image)[None])
        return drop_tracker_axis(ts), n[0]

    def track_fn(ts: TrackerState, image, imu_w, imu_dt, imu_valid, u):
        new, batch, debug = track_b(
            add_tracker_axis(ts), torch.as_tensor(image)[None],
            imu_w[None], imu_dt[None], imu_valid[None], u[None])
        return (drop_tracker_axis(new), drop_segment_axis(batch),
                {k: v[0] for k, v in debug.items()})

    return init_fn, track_fn


def make_batched_tracker(cfg: RVIOConfig, device=None, dtype=torch.float32,
                         klt=None):
    """The tracker body for B images in lockstep, on ``device`` (``None``:
    the CUDA device; raises without one):

    init_fn(images) -> (TrackerState, n_active)          (first frames)
    track_fn(state, images, imu_w, imu_dt, imu_valid, u)
        -> (TrackerState, UpdateBatch, debug dict)

    with a leading segment axis B on everything: ``images`` (B, H, W) gray
    or (B, H, W, 3) color, the IMU blocks (B, K, ...), the draws ``u``
    (B, N), every state field, batch field and debug value (B, ...).
    Segment b's results are those of :func:`make_tracker`'s entries on
    segment b's inputs.  ``klt`` replaces ``klt_track`` (same arguments
    and results): the KLT stage split over a mesh's ``feat`` axis
    (parallel/mesh.py ``klt_splitter``), as the update takes its
    ``feat_reduce``.
    """
    device = resolve_device(device)
    klt = klt or klt_track
    N = cfg.tracker.num_features
    L = cfg.tracker.max_tracking_length
    Lmin = cfg.tracker.min_tracking_length
    F = cfg.tracker.max_update_features
    keep_after_t2 = L - (math.ceil(0.5 * L) - 1)
    min_dist = cfg.tracker.min_distance
    cell = max(4, int(min_dist))
    cell2 = max(4, int(2 * min_dist))
    cam = _cam_kwargs(cfg)
    R_bc = torch.as_tensor(cfg.camera.R_bc, device=device).to(dtype)
    levels = cfg.tracker.klt_levels
    klt_kw = dict(win=cfg.tracker.klt_window,
                  max_iters=cfg.tracker.klt_max_iters,
                  eps=cfg.tracker.klt_eps, min_eig=cfg.tracker.klt_min_eig)
    slots = torch.arange(N, device=device)
    ranks = torch.arange(F, device=device)
    steps = torch.arange(L, device=device)

    def preprocess(image):
        img = image.to(device=device, dtype=dtype)
        if img.ndim == 4:
            # color input -> BT.601 luma; Camera.RGB picks the channel order
            # (reference: Tracker.cc:183-202 cvtColor RGB2GRAY/BGR2GRAY)
            r, g, b = ((img[..., 0], img[..., 1], img[..., 2])
                       if cfg.camera.is_rgb
                       else (img[..., 2], img[..., 1], img[..., 0]))
            img = 0.299 * r + 0.587 * g + 0.114 * b
        if cfg.tracker.enable_equalizer:
            img = clahe(img, 3.0, 5)
        return tuple(build_pyramid(img, levels))

    def detect(img, spacing, refine=True):
        resp = nms_masked_response(img)
        pts, valid = grid_top_corners(resp, spacing, N,
                                      cfg.tracker.quality_level)
        if refine:
            pts = corner_subpix(img, pts, win=int(min_dist) // 2,
                                iters=cfg.tracker.subpix_iters)
        return pts, valid

    def rows_of(x, idx):
        """x[b, idx[b, j]] along axis 1 for every segment b."""
        return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                            .expand(idx.shape + tuple(x.shape[2:])))

    def init_fn(images) -> Tuple[TrackerState, torch.Tensor]:
        pyr = preprocess(images)
        B = pyr[0].shape[0]
        pts, valid = detect(pyr[0], cell)
        k = min(N, pts.shape[1])
        pos = torch.zeros((B, N, 2), dtype=dtype, device=device)
        pos[:, :k] = pts[:, :k]
        active = torch.zeros((B, N), dtype=torch.bool, device=device)
        active[:, :k] = valid[:, :k]
        zn = undistort_normalize(pos, **cam).to(dtype)
        hist = torch.zeros((B, N, L, 2), dtype=dtype, device=device)
        hist[:, :, 0, :] = torch.where(active[..., None], zn, 0.0)
        length = active.long()
        return (TrackerState(pos=pos, hist=hist, length=length, active=active,
                             pyramid=pyr), active.sum(dim=1))

    def track_fn(ts: TrackerState, images, imu_w, imu_dt, imu_valid, u):
        pyr = preprocess(images)
        B = pyr[0].shape[0]

        # --- KLT (Tracker.cc:237-244) ---
        new_pos, status, err = klt(list(ts.pyramid), list(pyr), ts.pos,
                                   ts.active, **klt_kw)
        zn = undistort_normalize(new_pos, **cam).to(dtype)

        # --- gyro-aided RANSAC (Tracker.cc:264) ---
        last_step = torch.clamp(ts.length - 1, 0, L - 1)
        prev_zn = torch.gather(ts.hist, 2, last_step[:, :, None, None]
                               .expand(B, N, 1, 2))[:, :, 0]
        ones = torch.ones((B, N, 1), dtype=dtype, device=device)
        p1h = torch.cat([prev_zn, ones], dim=2)
        p2h = torch.cat([zn, ones], dim=2)
        R_cam = integrate_gyro_rotation(imu_w.to(dtype), imu_dt.to(dtype),
                                        imu_valid, R_bc, cfg.imu.small_angle)
        inlier = gyro_ransac(u, p1h, p2h, status & ts.active, R_cam,
                             cfg.tracker.inlier_threshold,
                             n_hypotheses=cfg.tracker.ransac_iterations,
                             use_sampson=cfg.tracker.use_sampson)
        tracked = ts.active & inlier
        lost = ts.active & ~inlier

        # --- update batch assembly (Tracker.cc:271-342) ---
        # type-1 (lost) features first by slot index, then type-2, capped
        # at F; rank F means dropped
        type1 = lost & (ts.length >= Lmin)
        at_max = tracked & (ts.length == L)
        n_type1 = torch.sum(type1.long(), dim=1, keepdim=True)
        r1 = torch.cumsum(type1.long(), 1) - 1
        r2 = n_type1 + torch.cumsum(at_max.long(), 1) - 1
        rank = torch.where(type1, r1, torch.where(at_max, r2, F))
        in_budget_any = (type1 | at_max) & (rank < F)
        n_sel = torch.clamp(n_type1 + torch.sum(at_max.long(), dim=1,
                                                keepdim=True), max=F)
        sel_valid = ranks < n_sel
        # the slot holding each rank (N: none), then its rows
        slot_of = torch.full((B, F + 1), N, dtype=torch.long, device=device)
        slot_of.scatter_(1, torch.where(in_budget_any, rank, F),
                         slots.expand(B, N))
        src = slot_of[:, :F]
        hist_rows = torch.cat([ts.hist.reshape(B, N, L * 2),
                               ts.hist.new_zeros(B, 1, L * 2)], dim=1)
        len_rows = torch.cat([ts.length, ts.length.new_zeros(B, 1)], dim=1)
        batch = UpdateBatch(meas=rows_of(hist_rows, src).reshape(B, F, L, 2),
                            track_len=rows_of(len_rows, src),
                            is_type2=sel_valid & (ranks >= n_type1),
                            valid=sel_valid)
        in_budget = at_max & (rank < F)

        # --- history update (Tracker.cc:305-342) ---
        # type-2 in budget: keep the last keep_after_t2 entries; type-2 over
        # budget: drop one; the tail repeats the last entry
        def shifted(s):
            if s == 0:
                return ts.hist
            tail = ts.hist[:, :, -1:].expand(B, N, s, 2)
            return torch.cat([ts.hist[:, :, s:], tail], dim=2)

        s2 = L - keep_after_t2
        hist = torch.where((at_max & in_budget)[..., None, None], shifted(s2),
                           torch.where(at_max[..., None, None], shifted(1),
                                       ts.hist))
        shift = torch.where(at_max & in_budget, s2,
                            torch.where(at_max, 1, 0))
        new_len = ts.length - shift
        # append the new measurement for tracked slots
        app_here = ((steps == torch.clamp(new_len, 0, L - 1)[..., None])
                    & tracked[..., None])
        hist = torch.where(app_here[..., None], zn[:, :, None, :], hist)
        new_len = torch.where(tracked, new_len + 1, 0)
        active = tracked
        pos = torch.where(tracked[..., None], new_pos, 0.0)

        # --- refill (Tracker.cc:344-387) ---
        cand_pts, cand_valid = detect(pyr[0], cell2,
                                      refine=cfg.tracker.subpix_refill)
        admit = find_newer(cand_pts, cand_valid, pos, active,
                           img_w=cfg.camera.width, img_h=cfg.camera.height,
                           block_w=cfg.tracker.block_size_x,
                           block_h=cfg.tracker.block_size_y,
                           min_dist=min_dist, max_feats=N)
        free = ~active
        n_free = torch.sum(free.long(), dim=1)
        n_admit = torch.sum(admit.long(), dim=1)
        # pair the i-th free slot with the i-th admitted candidate (slot and
        # candidate index order, the reference's FindNewer fill order)
        C = cand_pts.shape[1]
        rf = torch.cumsum(free.long(), 1) - 1
        ra = torch.cumsum(admit.long(), 1) - 1
        cand_of_rank = torch.full((B, C + 1), C, dtype=torch.long,
                                  device=device)
        cand_of_rank.scatter_(1, torch.where(admit, ra, C),
                              torch.arange(C, device=device).expand(B, C))
        fill_slot = free & (rf < n_admit[:, None])
        pick = torch.gather(cand_of_rank, 1, torch.clamp(rf, 0, C))
        # a non-finite candidate must not reach a slot
        cand_f = torch.where(torch.isfinite(cand_pts), cand_pts, 0.0)
        cand_zn = undistort_normalize(cand_f, **cam).to(dtype)
        cand_zn = torch.where(torch.isfinite(cand_zn), cand_zn, 0.0)
        pad = cand_f.new_zeros(B, 1, 2)
        new_pts = rows_of(torch.cat([cand_f.to(dtype), pad], dim=1), pick)
        new_zn = rows_of(torch.cat([cand_zn, pad], dim=1), pick)
        pos = torch.where(fill_slot[..., None], new_pts, pos)
        active = active | fill_slot
        hist = torch.cat([torch.where(fill_slot[..., None], new_zn,
                                      hist[:, :, 0])[:, :, None],
                          hist[:, :, 1:]], dim=2)
        new_len = torch.where(fill_slot, 1, new_len)

        debug = {"n_tracked": torch.sum(tracked.long(), dim=1),
                 "n_lost": torch.sum(lost.long(), dim=1),
                 "n_new": torch.minimum(n_free, n_admit),
                 "klt_err": err}
        return (TrackerState(pos=pos, hist=hist, length=new_len,
                             active=active, pyramid=pyr), batch, debug)

    return init_fn, track_fn
