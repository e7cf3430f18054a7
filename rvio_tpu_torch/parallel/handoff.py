"""Warm-handoff segment parallelism: split ONE long sequence into segments.

Port of rvio_tpu/parallel/handoff.py on one card.  The reference is
strictly sequential-in-time (SURVEY.md section 5) and can only start
filtering from a static initialization (System.cc:182-249), so a long run
(the 9.8 km drive, reference README.md:52) cannot be split.  Here a
mid-sequence segment starts *warm*:

- segment 0 uses the normal static init;
- segment s>0 starts ``warmup`` frames before its body with a **moving
  initialization** (:func:`warm_initialize`): velocity and gravity from a
  closed-form visual-inertial bootstrap (:func:`bootstrap_velocity_gravity`)
  or, failing it, gravity from the accelerometer direction and zero
  velocity, all with inflated covariance.  Gravity, velocity and biases
  are observable in VIO, so the filter converges during the warm-up;
  warm-up outputs are discarded except for the overlap tail used to align
  segment frames.

All segments then run side by side as one segment batch (a frame of every
segment is one replay of a captured CUDA graph on the card, each filter
kernel one launch a frame for the batch: runtime/step.py), and the
per-segment trajectories are joined by the 4-DOF overlap fit + associative
prefix product of :mod:`rvio_tpu_torch.parallel.stitch`.  A segment that
diverged is re-run from the previous segment's final state (the repair
pass).  With a ``mesh`` (parallel/mesh.py) each ``seg`` rank runs its
segments and every rank gathers all of them, then repairs and stitches
as one card would.

The bootstrap, the plan and the stitcher are numpy and copies of the JAX
functions; tests/test_torch_handoff.py holds each to it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from rvio_tpu_torch.config import RVIOConfig
from rvio_tpu_torch.core.quaternion import rot_to_quat
from rvio_tpu_torch.core.so3 import rodrigues_np
from rvio_tpu_torch.device import resolve_device
from rvio_tpu_torch.parallel.mesh import mesh_device, segment_slice
from rvio_tpu_torch.parallel.segment import _step_body, gather_segments
from rvio_tpu_torch.parallel.stitch import fit_yaw_transform, prefix_product
from rvio_tpu_torch.runtime.step import UNROLL, FrameBundle, _segment_scan
from rvio_tpu_torch.state.filter_state import (FilterState,
                                               make_initial_state, map_fields,
                                               stack_states)


def _np(x) -> np.ndarray:
    """A host array of a tensor (on any device) or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def warm_initialize(cfg: RVIOConfig, a0: np.ndarray, dtype=torch.float64,
                    device=None, *, v0: Optional[np.ndarray] = None,
                    g0: Optional[np.ndarray] = None,
                    sigma_g0: float = 0.3, sigma_v0: float = 1.0,
                    sigma_bg0: float = 0.05, sigma_ba0: float = 0.5,
                    sigma2_scale0: float = 6.0) -> FilterState:
    """Moving (mid-sequence) initialization for a warm-up segment start,
    on ``device`` (``None``: the CUDA device).

    Unlike the static init (System.cc:115-170), no rest window exists.
    With ``v0``/``g0`` from :func:`bootstrap_velocity_gravity` the start is
    accurate to ~0.1 m/s / a few degrees; otherwise gravity is seeded from
    the instantaneous specific-force direction (off by up to the platform
    acceleration / g — covered by ``sigma_g0``) and velocity starts at zero
    with a wide prior.  The warm-up frames let the filter collapse the
    remaining error before the segment body begins.

    ``sigma2_scale0``: initial adaptive-noise scale.  Warm convergence is
    the one regime where the EKF's P briefly collapses faster than the
    true error; with nominal measurement noise the chi2 gate then mass-
    rejects and the segment dead-reckons.  Starting conservative (inflated
    R -> soft gate, slow P collapse) and letting the innovation-whitening
    EMA walk the scale down (~5 s, inside the warm-up) avoids that without
    touching steady state.
    """
    device = resolve_device(device)
    a0 = np.asarray(a0, np.float64)
    g = (np.asarray(g0, np.float64) if g0 is not None
         else a0 / max(np.linalg.norm(a0), 1e-12))

    # gravity-aligned {G_s} axes, same construction as the static init
    zv = g
    ex = np.array([1.0, 0.0, 0.0])
    xv = ex - zv * float(np.dot(zv, ex))
    xv = xv / np.linalg.norm(xv)
    yv = np.cross(zv, xv)
    yv = yv / np.linalg.norm(yv)
    R = (np.stack([xv, yv, zv], axis=-1) if cfg.init.enable_alignment
         else np.eye(3))

    M = cfg.window_size
    st = make_initial_state(M, dtype, device)
    diag = np.zeros(24 + 6 * M)
    diag[0:6] = 1e-3 ** 2                 # qG, pG: the segment's own datum
    diag[6:9] = sigma_g0 ** 2             # gravity direction
    diag[15:18] = sigma_v0 ** 2           # velocity
    diag[18:21] = sigma_bg0 ** 2          # gyro bias
    diag[21:24] = sigma_ba0 ** 2          # accel bias

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device
                               ).to(dtype)

    v_R = put(v0) if v0 is not None else st.v_R
    return FilterState(
        q_G=rot_to_quat(put(R)), p_G=st.p_G, g=put(g), q_R=st.q_R,
        p_R=st.p_R, v_R=v_R, bg=st.bg, ba=st.ba, clones=st.clones,
        P=put(np.diag(diag)), n_clones=st.n_clones, frame_idx=st.frame_idx,
        clones_fej=st.clones.clone(),
        sigma2_scale=torch.full((), sigma2_scale0, dtype=dtype,
                                device=device))


def bootstrap_velocity_gravity(cfg: RVIOConfig, imu_w, imu_a, imu_dt,
                               imu_valid, meas, track_len, valid,
                               w0: int, n_frames: int
                               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Closed-form moving initialization: solve v0 and gravity linearly.

    Martinelli-style visual-inertial bootstrap (no reference equivalent —
    the reference can only initialize at rest, System.cc:182-249): over a
    short window starting at frame ``w0``, gyro integration gives the
    rotations R_t; the landmark coincidence constraint between two
    observations i0, i of the same feature,

        v0 (t_i0 - t_i) - 0.5 gvec (t_i0^2 - t_i^2)
            + d_i0 u_i0 - d_i u_i = alpha_i - alpha_i0 + (R_i - R_i0) t_bc

    is LINEAR in v0 (body velocity at the window start, in the start frame),
    gvec = G * g0 (gravity vector in the start frame), and the per-
    observation depths d.  alpha is the accelerometer double integral and
    u = R_t R_bc [z; 1] the bearing in the start frame.  A small dense
    least-squares over all tracks ending inside the window recovers v0/g0.

    All inputs are host numpy slices of the full sequence arrays.  Returns
    (v0, g0_unit, diag) — diag carries the solve's self-estimated accuracy
    {sigma_v, sigma_g_rad, rms_residual, rows} for pre-commit validation —
    or None when there is not enough visual structure.
    """
    T = len(imu_dt)
    G = cfg.imu.gravity
    R_bc, t_bc = cfg.camera.R_bc, cfg.camera.t_bc
    hi = min(w0 + n_frames, T)

    # integrate IMU from the start of frame w0's block: per-frame time,
    # rotation-to-start, and accel double integral
    t = 0.0
    R = np.eye(3)
    alpha = np.zeros(3)
    beta = np.zeros(3)
    times, Rs, alphas = {}, {}, {}
    for g in range(w0, hi):
        for k in range(imu_w.shape[1]):
            if not imu_valid[g, k]:
                continue
            dt = float(imu_dt[g, k])
            f = R @ imu_a[g, k]
            alpha = alpha + beta * dt + 0.5 * f * dt * dt
            beta = beta + f * dt
            R = R @ rodrigues_np(imu_w[g, k], dt)
            t += dt
        i = g - w0
        times[i], Rs[i], alphas[i] = t, R.copy(), alpha.copy()

    # collect tracks observable in the window; a batch emitted at frame g
    # holds measurements ENDING at frame g-1 (the track failed or maxed at
    # g), so measurement j sits at frame g - len + j — matching the filter's
    # clone association (update runs before frame g's clone is augmented)
    n_obs = 0
    # Depths are per-observation nuisance unknowns: solved JOINTLY the
    # dense lstsq grows as (3*n_obs) x (6+n_obs) and its SVD costs
    # minutes per segment at the 200-feature flagship budget (~1200
    # obs).  But each track's depths appear
    # only in that track's rows, so they are eliminated EXACTLY per
    # track by projecting the track's rows onto the nullspace of its
    # depth columns (the same marginalization the MSCKF update uses for
    # landmarks) — leaving a small (rows, 6) system in [v0, gvec] that
    # uses EVERY track at milliseconds of cost, with the identical
    # least-squares solution for v0/gvec.
    obs_tracks = []
    for g in range(w0 + 1, hi):
        for f in range(meas.shape[1]):
            if not valid[g, f]:
                continue
            ln = int(track_len[g, f])
            if ln < 2:
                continue
            start = g - ln
            obs = [(start + j - w0, meas[g, f, j]) for j in range(ln)
                   if start + j >= w0]
            if len(obs) < 2:
                continue
            n_obs += len(obs)
            obs_tracks.append(obs)

    if n_obs == 0:
        return None

    A_rows, b_rows = [], []
    for obs in obs_tracks:
        k = len(obs)
        i0, z0 = obs[0]
        u0 = Rs[i0] @ R_bc @ np.array([z0[0], z0[1], 1.0])
        Bt = np.zeros((3 * (k - 1), 6))
        Dt = np.zeros((3 * (k - 1), k))
        bt = np.zeros(3 * (k - 1))
        for r, (i, z) in enumerate(obs[1:]):
            ui = Rs[i] @ R_bc @ np.array([z[0], z[1], 1.0])
            sl = slice(3 * r, 3 * r + 3)
            Bt[sl, 0:3] = (times[i0] - times[i]) * np.eye(3)
            Bt[sl, 3:6] = -0.5 * (times[i0] ** 2 - times[i] ** 2) * np.eye(3)
            Dt[sl, 0] = u0
            Dt[sl, r + 1] = -ui
            bt[3 * r:3 * r + 3] = (alphas[i] - alphas[i0]
                                   + (Rs[i] - Rs[i0]) @ t_bc)
        Q, _ = np.linalg.qr(Dt, mode="complete")
        N = Q[:, k:]                    # left nullspace of the depth block
        if N.shape[1] == 0:
            continue
        A_rows.append(N.T @ Bt)
        b_rows.append(N.T @ bt)
    if not A_rows:
        return None
    A = np.concatenate(A_rows, axis=0)
    b = np.concatenate(b_rows, axis=0)
    if A.shape[0] < 6:
        return None
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    v0, gvec = sol[0:3], sol[3:6]
    gn = np.linalg.norm(gvec)
    if not (0.5 * G < gn < 1.5 * G):   # structure too weak; fall back
        return None

    # --- pre-commit self-validation ---
    # The linear system's own residuals estimate the solve's accuracy
    # BEFORE the segment trusts it: with row noise sigma_row (estimated
    # from the post-fit residual RMS), Cov(sol) = sigma_row^2 (A^T A)^-1.
    # A warm start diverges when the filter's fixed priors understate a
    # (rare) badly-conditioned bootstrap — these estimates let the caller
    # size the priors honestly or reject.
    r = A @ sol - b
    dofr = max(A.shape[0] - 6, 1)
    sigma_row = float(np.sqrt(float(r @ r) / dofr))
    try:
        cov = sigma_row ** 2 * np.linalg.inv(A.T @ A)
    except np.linalg.LinAlgError:
        return None
    sigma_v = float(np.sqrt(max(np.trace(cov[0:3, 0:3]), 0.0)))
    # gravity-vector std -> direction std in radians (|gvec| = G)
    sigma_g_rad = float(np.sqrt(max(np.trace(cov[3:6, 3:6]), 0.0))) / G
    diag = {"sigma_v": sigma_v, "sigma_g_rad": sigma_g_rad,
            "rms_residual": sigma_row, "rows": int(A.shape[0])}
    return v0, gvec / gn, diag


def make_masked_segment_scan(cfg: RVIOConfig, device=None,
                             dtype=torch.float32):
    """The segment scan with a per-frame ``ok`` mask (the counterpart of
    the JAX function's vmapped masked scan).

    ``run(states, bundles, ok) -> (states, outputs)`` where every leaf has
    a leading segment axis S and ``ok`` is (S, T) bool; frames with
    ok=False leave that segment's state untouched (used to pad segments to
    a common static length).  A frame of the S segments is one replay of a
    captured CUDA graph on the card; the outputs are the sequence scan's
    keys and ``ok``, each (S, T, ...).  ``device`` ``None`` means the CUDA
    device; ``run.frame_scan`` is the :class:`FrameScan`."""
    device = resolve_device(device)
    return _segment_scan(_step_body(cfg, device, dtype), device, dtype,
                         UNROLL, masked=True)


def segment_plan(T: int, n_segments: int, warmup: int
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Frame-index plan: (idx (S, W+B), ok (S, W+B), body_len B).

    Segment s's body covers global frames [s*B, min((s+1)*B, T)); its
    warm-up covers the ``warmup`` frames before the body (clipped at 0, so
    segment 0's warm-up rows are masked out).  Rows outside [0, T) or beyond
    the body end are ok=False.
    """
    S = n_segments
    B = math.ceil(T / S)
    padT = warmup + B
    idx = np.zeros((S, padT), np.int64)
    ok = np.zeros((S, padT), bool)
    for s in range(S):
        start = s * B - warmup
        g = start + np.arange(padT)
        valid = (g >= 0) & (g < min((s + 1) * B, T))
        idx[s] = np.clip(g, 0, T - 1)
        ok[s] = valid
    return idx, ok, B


def warm_segments(cfg: RVIOConfig, state0: FilterState, bundles: FrameBundle,
                  n_segments: int, warmup: int, dtype, device):
    """The inputs of the warm split (the first half of
    :func:`run_segments_warm`): the config with ``adaptive_rampup_frames``
    set to the warm-up, the plan (idx, ok, body_len), the stacked initial
    states (segment 0's static init, the others' warm starts), the
    per-segment bundles (S, W+B, ...) gathered on the device, the (S, W+B)
    mask and each segment's bootstrap diagnostics."""
    T = int(bundles.imu.w.shape[0])
    S = n_segments
    W = warmup
    # warm starts keep their conservative noise scale until converged:
    # downward adaptation ramps over the warm-up (see warm_initialize).
    # The shared config also slows segment 0's (cold-init) early
    # down-steps for its first W frames — a small, accepted deviation
    # from an unsplit run, as in the JAX package.
    cfg = cfg.replace(tpu=dataclasses.replace(cfg.tpu,
                                              adaptive_rampup_frames=W))
    idx, ok, B = segment_plan(T, S, W)

    # per-segment initial states: static init for segment 0, moving init for
    # the rest — closed-form v0/gravity bootstrap from the warm-up window's
    # tracks + IMU, falling back to the raw accel direction if degenerate.
    # Only the per-segment bootstrap windows are read back to the host.
    L = int(bundles.batch.meas.shape[2])
    states = [state0]
    boot_diags = [None]
    # ~3 s of data makes the linear bootstrap accurate to ~0.1 m/s / 0.5 deg
    # (shorter windows are too noise-sensitive); must fit inside the warm-up
    nb = int(np.clip(3.0 * cfg.camera.fps, L + 4, W))
    # pre-commit acceptance bounds on the bootstrap's SELF-ESTIMATED
    # accuracy; candidates failing both windows fall back to the wide-
    # prior accel-direction init instead of a confidently-wrong start
    MAX_SIGMA_V = 0.5              # [m/s]
    MAX_SIGMA_G = np.radians(8.0)  # [rad]
    for s in range(1, S):
        w0 = max(s * B - W, 0)
        # candidate bootstrap windows: the nominal 3 s window, then a
        # longer (2x) window if the first self-reports weak conditioning —
        # a different excitation span usually repairs a degenerate solve
        cands = []
        for nb_c in (nb, min(2 * nb, W)):
            sl = slice(w0, min(w0 + nb_c, T))
            boot = bootstrap_velocity_gravity(
                cfg, _np(bundles.imu.w[sl]), _np(bundles.imu.a[sl]),
                _np(bundles.imu.dt[sl]), _np(bundles.imu.valid[sl]),
                _np(bundles.batch.meas[sl]),
                _np(bundles.batch.track_len[sl]),
                _np(bundles.batch.valid[sl]), 0, nb_c)
            if boot is not None:
                cands.append(boot)
                # stop early only when BOTH self-estimates are tight —
                # a tight sigma_v with weakly-excited gravity must still
                # try the longer window before the joint bound rejects it
                if (boot[2]["sigma_v"] < 0.15
                        and boot[2]["sigma_g_rad"] < np.radians(3.0)):
                    break
            if nb_c >= W:
                break
        v = _np(bundles.imu.valid[w0])
        a_row = _np(bundles.imu.a[w0])
        a0 = a_row[v].mean(axis=0) if v.any() else np.array([0, 0, 1.0])

        def _ok(c):
            return (c[2]["sigma_v"] < MAX_SIGMA_V
                    and c[2]["sigma_g_rad"] < MAX_SIGMA_G)

        # prefer candidates inside the joint acceptance region (a window
        # with the tightest sigma_v may still fail on sigma_g)
        pool = [c for c in cands if _ok(c)] or cands
        best = min(pool, key=lambda c: c[2]["sigma_v"]) if pool else None
        if best is not None and _ok(best):
            v0, g0u, bd = best
            # honest priors: 3x the bootstrap's self-estimated std,
            # floored at the nominal optimistic values
            sv0 = float(np.clip(3 * bd["sigma_v"], 0.3, 1.0))
            sg0 = float(np.clip(3 * bd["sigma_g_rad"], 0.05, 0.3))
            states.append(warm_initialize(cfg, a0, dtype, device, v0=v0,
                                          g0=g0u, sigma_g0=sg0,
                                          sigma_v0=sv0))
            boot_diags.append(bd)
        else:
            states.append(warm_initialize(cfg, a0, dtype, device))
            boot_diags.append({"rejected": True,
                               "cands": [c[2] for c in cands]})
    sstates = stack_states(states)

    # the segment gather stays on the device
    idx_dev = torch.as_tensor(idx, device=device)
    sbundles = FrameBundle(
        imu=dataclasses.replace(bundles.imu, **{
            f.name: getattr(bundles.imu, f.name)[idx_dev]
            for f in dataclasses.fields(bundles.imu)}),
        batch=dataclasses.replace(bundles.batch, **{
            f.name: getattr(bundles.batch, f.name)[idx_dev]
            for f in dataclasses.fields(bundles.batch)}))
    sok = torch.as_tensor(ok, device=device)
    return cfg, (idx, ok, B), sstates, sbundles, sok, boot_diags


def run_segments_warm(cfg: RVIOConfig, state0: FilterState,
                      bundles: FrameBundle, n_segments: int, warmup: int,
                      dtype=None, mesh=None, overlap_fit: Optional[int] = None,
                      device=None):
    """Filter one long bundle-stacked sequence as warm segments side by
    side.

    state0: the static init for segment 0; bundles: (T, ...) stacked
    FrameBundle from the init frame, both on ``device`` (``None``: the
    CUDA device).  ``dtype`` (default state0's) is the warm starts'.
    Returns (stitched_positions (T, 3) numpy, outputs dict of (S, W+B, ...)
    tensors on the device, info dict), as the JAX function does; ``info``
    also holds the segment scan (``scan``) and the repair pass's scan
    (``repair_scan``, None without a repair).

    ``mesh`` (parallel/mesh.py) shards the segments over its ``seg`` axis,
    as the JAX function does: every rank builds the plan and the starts,
    runs the masked scan over its own S/seg segments on its device (the
    mesh's; ranks that differ only in ``feat`` run the same ones),
    gathers every segment's outputs and final states
    (``gather_segments``), and runs the repair pass and the stitch as one
    card would, so every rank returns the same result.  A ValueError where
    seg does not divide S.
    """
    S, W = n_segments, warmup
    if mesh is None:
        device = resolve_device(device)
    else:
        lo, hi = segment_slice(mesh, S)
        device = mesh_device(mesh)
    dtype = state0.dtype if dtype is None else dtype
    T = int(bundles.imu.w.shape[0])
    cfg, (idx, ok, B), sstates, sbundles, sok, boot_diags = warm_segments(
        cfg, state0, bundles, S, W, dtype, device)
    OV = overlap_fit if overlap_fit is not None else max(2, min(W // 2, B))

    run = make_masked_segment_scan(cfg, device, dtype)
    if mesh is None:
        fstates, outs = run(sstates, sbundles, sok)
    else:
        def mine(x):
            return x[lo:hi]

        fstates, outs = run(
            map_fields(mine, sstates),
            FrameBundle(imu=map_fields(mine, sbundles.imu),
                        batch=map_fields(mine, sbundles.batch)), mine(sok))
        fstates, outs = gather_segments((fstates, outs), mesh)

    # --- divergence repair (sequential fallback for failed segments) ---
    # A warm start occasionally lands outside the filter's basin (bad
    # bootstrap geometry): the chi2 gate then rejects everything and the
    # segment dead-reckons away (body n_good ~ 0).  Such segments are
    # re-run from the PREVIOUS segment's exact final state — a perfect
    # checkpoint continuation, so their boundary transform is identity.
    # The re-run is one segment, B = 1: a scan of its own (a graph
    # captured at that shape), built at the first repair.
    ng = _np(outs["n_good"])
    okm = np.asarray(ok)
    body_ng = np.array([ng[s, W:][okm[s, W:]].mean() if okm[s, W:].any()
                        else 0.0 for s in range(S)])
    identity_pairs = set()
    repaired = []
    run1 = None
    for s in range(1, S):
        if body_ng[s] >= 2.0:
            continue
        if run1 is None:
            run1 = make_masked_segment_scan(cfg, device, dtype)
        ok_s = np.array(okm[s])
        ok_s[:W] = False                  # exact continuation: no warm-up
        seg_bundle = FrameBundle(
            imu=dataclasses.replace(sbundles.imu, **{
                f.name: getattr(sbundles.imu, f.name)[s:s + 1]
                for f in dataclasses.fields(sbundles.imu)}),
            batch=dataclasses.replace(sbundles.batch, **{
                f.name: getattr(sbundles.batch, f.name)[s:s + 1]
                for f in dataclasses.fields(sbundles.batch)}))
        st1 = FilterState(**{f.name: getattr(fstates, f.name)[s - 1:s]
                             for f in dataclasses.fields(FilterState)})
        f1, o1 = run1(st1, seg_bundle,
                      torch.as_tensor(ok_s, device=device)[None])
        for f in dataclasses.fields(FilterState):
            getattr(fstates, f.name)[s] = getattr(f1, f.name)[0]
        for k, v in o1.items():
            outs[k][s] = v[0]
        identity_pairs.add(s)
        repaired.append(s)

    stitched = stitch_warm_outputs(outs, W, B, T, OV,
                                   identity_pairs=identity_pairs)
    return stitched, outs, {"body_len": B, "warmup": W, "overlap_fit": OV,
                            "plan_idx": idx, "plan_ok": ok,
                            "repaired_segments": repaired,
                            "bootstrap_diags": boot_diags,
                            "scan": run, "repair_scan": run1}


def _quat_to_rot_np(q: np.ndarray) -> np.ndarray:
    """JPL (..., 4) xyzw quaternion -> rotation matrices, batched numpy."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y + w * z)
    R[..., 0, 2] = 2 * (x * z - w * y)
    R[..., 1, 0] = 2 * (x * y - w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z + w * x)
    R[..., 2, 0] = 2 * (x * z + w * y)
    R[..., 2, 1] = 2 * (y * z - w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def stitch_warm_outputs(outs: dict, W: int, B: int, T: int, OV: int,
                        identity_pairs=frozenset()) -> np.ndarray:
    """Join warm-segment outputs into one (T, 3) global trajectory.

    Alignment data: segment s's last OV warm-up frames cover the same
    global frames as segment s-1's last OV body frames; a 4-DOF fit on
    positions + world-from-body orientations (q_kG is the {G}->body JPL
    quaternion, so R_wb = R(q)^T) gives the pairwise boundary transforms,
    composed by the associative prefix product.

    ``identity_pairs``: segment indices whose trajectory is an EXACT
    continuation of the previous segment's frame (divergence-repaired
    segments) — their boundary transform is identity by construction.
    """
    p = _np(outs["p_Gk"])                    # (S, W+B, 3)
    q = _np(outs["q_kG"])                    # (S, W+B, 4)
    S = p.shape[0]
    R_wb = np.swapaxes(_quat_to_rot_np(q), -1, -2)

    pair = [np.eye(4)]
    for s in range(1, S):
        if s in identity_pairs:
            pair.append(np.eye(4))
            continue
        cur_sl = slice(W - OV, W)
        prev_sl = slice(W + B - OV, W + B)
        Tf = fit_yaw_transform(p[s, cur_sl], p[s - 1, prev_sl],
                               R_wb[s, cur_sl], R_wb[s - 1, prev_sl])
        pair.append(Tf)
    offsets = prefix_product(np.asarray(pair))

    rows = []
    for s in range(S):
        lo, hi = s * B, min((s + 1) * B, T)
        body = p[s, W:W + (hi - lo)]
        cum = offsets[s]
        rows.append((cum[:3, :3] @ body.T).T + cum[:3, 3])
    return np.concatenate(rows, axis=0)
