"""Batched inverse-depth MSCKF update — the filter back-end.

Port of rvio_tpu/filter/update.py (reference: Updater::update,
src/rvio/Updater.cc:72-628), following the JAX package's oracle (CPU)
branches.  The feature axis F is an explicit batch dimension, and a
state with a leading segment axis B updates B filters at once (K2-K4 on
the B·F feature rows, K5 on the B systems, every gate per segment):

1. window-relative pose chains — one composition over the clone window and
   plain per-feature indexing (Updater.cc:118-141);
2. inverse-depth LM triangulation — kernel K2 (ops/lm_triangulate.py);
3. residual/Jacobians + 3-reflection Householder nullspace projection —
   kernel K3 (ops/jac_project.py), emitting absolute clone columns;
4. Mahalanobis gating against chi2(0.95, DOF) — kernel K4
   (ops/spd_solve.py) for D = r^T S^-1 r (Updater.cc:404-454);
5. measurement compression of the stacked system (Updater.cc:460-536):
   Cholesky of the information matrix (default) or one thin QR
   (:func:`tsqr_compress` and :func:`_cholqr2`, the JAX package's blocked
   forms, reduce the rows of several feature shards);
6. EKF update with multiplicative quaternion retraction and Joseph-form
   covariance (Updater.cc:538-619).  With Cholesky compression the tail
   after C = Hw^T Hw, b = Hw^T ro is one launch of kernel K5
   (ops/ekf_tail.py) at every window.

Each kernel wrapper launches its CUDA kernel on a CUDA tensor and runs its
plain version on a CPU tensor.  Gates are ``torch.where`` on device
tensors (never Python branches), so a frame reads nothing back to the
host; rejected lanes are selected away (never multiplied by a mask) so
NaNs from degenerate geometry cannot leak, and a NaN Mahalanobis distance
rejects (NaN < thr is False).  Factorizations keep the JAX package's
NaN-on-failure semantics (ops/ekf_tail.py).

The update is two halves (:func:`update_partials`, :func:`update_tail`):
the first reads the feature lanes and ends in sums over them, the second
reads only those sums and the state.  So the feature axis can be split
over ranks (the ``feat`` axis of parallel/mesh.py): each rank takes its
F/feat lanes through the first half, one ``all_reduce`` joins the sums,
and every rank applies the same tail (``feat_reduce``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.rvio_plain.core.chi2 import chi2_gate_thresholds, chi2_truncated_means
from benchmark.reference.rvio_plain.core.prefix import prefix_scan
from benchmark.reference.rvio_plain.core.quaternion import (quat_mul, quat_to_rot,
                                            small_quat_from_dtheta)
from benchmark.reference.rvio_plain.ops.ekf_tail import (ekf_correction, ekf_tail,
                                         nan_cholesky)
from benchmark.reference.rvio_plain.ops.jac_project import jac_project
from benchmark.reference.rvio_plain.ops.lm_triangulate import (EPS_DEPTH, lm_triangulate,
                                               unit_from_angles)
from benchmark.reference.rvio_plain.ops.spd_solve import batched_quadform
from benchmark.reference.rvio_plain.state.filter_state import (FilterState, add_segment_axis,
                                               drop_segment_axis)


@dataclass
class UpdateBatch:
    """Fixed-shape batch of update features (the tracker's output).

    Mirrors mvFeatTypesForUpdate / mvlFeatMeasForUpdate
    (reference: Tracker.h:65-74) with static shapes: F feature lanes, each
    with up to L undistorted-normalized measurements ordered oldest first.
    """

    meas: torch.Tensor       # (F, L, 2) normalized image points
    track_len: torch.Tensor  # (F,) int — measurements in lane (0 if unused)
    is_type2: torch.Tensor   # (F,) bool — reached-max-length feature ('2')
    valid: torch.Tensor      # (F,) bool — lane holds a real feature
    # (each field with the state's leading segment axis B, where it has one)


@lru_cache(maxsize=16)
def _gate_tables(m: int, dtype: torch.dtype, device: torch.device):
    """chi2(0.95, dof) thresholds and truncated means for dof = 1..m, on the
    device (built once, so a frame copies nothing from the host)."""
    thr = torch.as_tensor(chi2_gate_thresholds(m, np.float64), device=device)
    etr = torch.as_tensor(chi2_truncated_means(m, np.float64), device=device)
    return thr.to(dtype), etr.to(dtype)


def window_pose_chain(clones: torch.Tensor, parallel: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefix-compose the clone window into first-window-frame-relative poses.

    Returns (Rw, tw) of shape (..., M+1, 3, 3)/(..., M+1, 3) for clones
    (..., M, 7) (any leading axes, such as the segment axis): the pose
    transform taking window-frame-0 coordinates into window frame i
    (x_i = Rw_i x_0 + tw_i).  Clone c stores the frame c -> c+1 transition
    (q, p) with x_{c+1} = R(q)(x_c - p) (Updater.cc:125-132).  Slots
    >= n_clones are identity transitions and extend the chain with its
    last value.

    ``parallel`` composes the affine maps A_c: x -> R_c x + t_c
    (t_c = -R_c p_c) as a log-depth doubling scan, (R_l, t_l)∘(R_e, t_e) =
    (R_l R_e, R_l t_e + t_l): the same math in another fp order.
    """
    M = clones.shape[-2]
    lead = clones.shape[:-2]
    kw = dict(dtype=clones.dtype, device=clones.device)
    Rc = quat_to_rot(clones[..., :4])
    pc = clones[..., 4:7]
    if parallel:
        def compose(e, l):
            (Re, te), (Rl, tl) = e, l
            return Rl @ Re, (Rl @ te[..., None])[..., 0] + tl

        Rs, ts = prefix_scan((Rc, -(Rc @ pc[..., None])[..., 0]), compose,
                             dim=len(lead))
    else:
        Rw = torch.eye(3, **kw).expand(lead + (3, 3))
        tw = torch.zeros(lead + (3,), **kw)
        R_list, t_list = [], []
        for c in range(M):
            Rw = Rc[..., c, :, :] @ Rw
            tw = (Rc[..., c, :, :] @ (tw - pc[..., c, :])[..., None])[..., 0]
            R_list.append(Rw)
            t_list.append(tw)
        Rs, ts = torch.stack(R_list, dim=-3), torch.stack(t_list, dim=-2)
    eye = torch.eye(3, **kw).expand(lead + (1, 3, 3))
    zero = torch.zeros(lead + (1, 3), **kw)
    return torch.cat([eye, Rs], dim=-3), torch.cat([zero, ts], dim=-2)


def feature_chains(Rw, tw, c0, L: int):
    """Per-feature chains: pose of measurement frame m relative to frame 0.

    Rw (B, M+1, 3, 3) and tw (B, M+1, 3) are each segment's window chain,
    c0 (B, F) its features' first window frames: measurement frame m of
    feature f is window frame c0[f] + m of its own segment.  Returns
    (Rrel, trel) of shape (B, F, L, 3, 3)/(B, F, L, 3); entry 0 is
    identity, entry m equals the reference's mRelPosesToFirst[m-1]
    (Updater.cc:125-132).
    """
    idx = torch.clamp(c0[..., None] + torch.arange(L, device=c0.device), 0,
                      Rw.shape[-3] - 1)                       # (B, F, L)
    seg = torch.arange(c0.shape[0], device=c0.device)[:, None, None]
    R_m = Rw[seg, idx]         # (B, F, L, 3, 3) window-frame-0 -> frame c0+m
    t_m = tw[seg, idx]
    Rrel = R_m @ R_m[:, :, :1].transpose(-1, -2)
    trel = t_m - (Rrel @ t_m[:, :, :1, :, None])[..., 0]
    return Rrel, trel


def _camera_chains(Rw, tw, c0, L, R_bc, t_bc):
    """(Rrel, trel, Rc, tc): body chains and camera-frame chains
    (Updater.cc:135-141) of every feature of every segment."""
    R_cb = R_bc.T
    t_cb = -R_cb @ t_bc
    Rrel, trel = feature_chains(Rw, tw, c0, L)
    Rc = torch.einsum("ab,...bc,cd->...ad", R_cb, Rrel, R_bc)
    tc = (torch.einsum("ab,...bc,c->...a", R_cb, Rrel, t_bc)
          + torch.einsum("ab,...b->...a", R_cb, trel) + t_cb)
    return Rrel, trel, Rc.contiguous(), tc.contiguous()


def _cholqr2(A: torch.Tensor, r: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tall-skinny QR of one block via two-pass Cholesky (CholeskyQR2).

    Port of rvio_tpu/filter/update.py ``_cholqr2``: (R, Q^T r) for A
    (..., b, C), r (..., b), any leading axes a batch of blocks, with only
    matmuls, Cholesky factorizations and triangular solves.  R^T R = A^T A
    up to rounding for any invertible pass-one factor, so the pass-one
    ridge and the completion of dead columns never bias the EKF.  Exactly
    zero columns (masked-out clones) and columns whose information the
    ridge dominates are completed with unit diagonals and then stripped
    (their rows of R and entries of Q^T r set to 0): a column dead in this
    block but live in a sibling block of the TSQR tree (or another feature
    shard) contributes nothing from this one, as Householder's zero rows.
    A factorization that fails gives NaN, as in the JAX package."""
    dtype, dev = A.dtype, A.device
    C = A.shape[-1]
    eps = torch.finfo(dtype).eps
    one = torch.ones((), dtype=dtype, device=dev)
    At = A.transpose(-1, -2)
    G = At @ A
    dead = torch.diagonal(G, dim1=-2, dim2=-1) == 0
    # identity-complete dead columns + a relative ridge, both repaired by
    # the second pass; the ridge dominates the Gram's rounding noise
    ridge = (100 * C * eps) * torch.clamp(
        torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / C, min=1.0)
    Gc = G + torch.diag_embed(torch.where(dead, one, ridge[..., None]))
    L1 = nan_cholesky(Gc)
    Q1t = torch.linalg.solve_triangular(L1, At, upper=False)     # (..., C, b)
    q1r = torch.linalg.solve_triangular(L1, At @ r[..., None], upper=False)
    G2 = Q1t @ Q1t.transpose(-1, -2)
    # live diag(G2) is about 1; far below it the pass-one ridge dominates
    # (or the column is dead): complete and strip, a rank cut like
    # Updater.cc:516.  An eps-scale ridge keeps the second factorization
    # finite where cross-column rank deficiency leaves zero eigenvalues.
    dead2 = torch.diagonal(G2, dim1=-2, dim2=-1) < 1e-6
    G2c = G2 + torch.diag_embed(torch.where(
        dead2, one, torch.full_like(one, 4 * C * eps)))
    L2 = nan_cholesky(G2c)
    R = L2.transpose(-1, -2) @ L1.transpose(-1, -2)
    rn = torch.linalg.solve_triangular(L2, q1r, upper=False)[..., 0]
    gone = dead | dead2
    R = torch.where(gone[..., None], torch.zeros_like(R), R)
    rn = torch.where(gone, torch.zeros_like(rn), rn)
    return R, rn


def _householder_qr(A: torch.Tensor, r: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, Q^T r) of a thin QR of each block A (..., b, C)."""
    Q, R = torch.linalg.qr(A, mode="reduced")
    return R, (Q.transpose(-1, -2) @ r[..., None])[..., 0]


def tsqr_compress(Hw: torch.Tensor, ro: torch.Tensor, block_rows: int = 0,
                  method: str = "householder"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked TSQR measurement compression: (R, Q^T r) of the stacked
    model Hw (..., N, C), ro (..., N), any leading axes.

    Port of rvio_tpu/filter/update.py ``tsqr_compress``.  Rows are reduced
    in a tree (each level a batch of block factorizations of
    ``block_rows`` rows, default 8 C, whose R factors are stacked for the
    next) down to one block.  R^T R = H^T H and R^T (Q^T r) = H^T r, all
    the EKF update reads, so the result equals one monolithic QR's up to
    an orthogonal left factor.  The same tree is the reduction across
    feature shards: each shard reduces its own rows and the stacked R's of
    the shards go through one more block (:func:`msckf_update` with a
    ``feat_reduce``).  ``method`` "householder" factors a block with
    ``torch.linalg.qr``, "cholqr2" with :func:`_cholqr2`."""
    if method == "householder":
        block_qr = _householder_qr
    elif method == "cholqr2":
        block_qr = _cholqr2
    else:
        raise ValueError(f"unknown method '{method}'")
    C = Hw.shape[-1]
    lead = Hw.shape[:-2]
    b = block_rows if block_rows > 0 else 8 * C
    while Hw.shape[-2] > b:
        N = Hw.shape[-2]
        nb = -(-N // b)
        Hp = torch.nn.functional.pad(Hw, (0, 0, 0, nb * b - N))
        rp = torch.nn.functional.pad(ro, (0, nb * b - N))
        R, rn = block_qr(Hp.reshape(lead + (nb, b, C)),
                         rp.reshape(lead + (nb, b)))
        Hw = R.reshape(lead + (nb * C, C))
        ro = rn.reshape(lead + (nb * C,))
    return block_qr(Hw, ro)


@dataclass
class UpdatePartials:
    """The shard-local half of one update (:func:`update_partials`).

    ``sums`` add up over feature shards (counts, the accepted distances'
    sums and, with Cholesky compression, C = Hw^T Hw and b = Hw^T ro);
    ``stacks`` stack their rows (axis 1) over shards (with QR compression
    the shard's R and Q^T ro); ``lanes`` are the
    shard's per-lane diagnostics; ``shards`` counts the shards merged;
    ``scale`` and ``sig2_eff`` are the state's noise scale and effective
    variance (the same on every shard)."""

    sums: Dict[str, torch.Tensor]
    stacks: Dict[str, torch.Tensor]
    lanes: Dict[str, torch.Tensor]
    scale: torch.Tensor
    sig2_eff: torch.Tensor
    shards: int = 1


def update_partials(state: FilterState, batch: UpdateBatch, *, R_bc, t_bc,
                    sigma_im: float, compression: str = "qr",
                    parallel_chains: bool = False, fej: bool = False,
                    adaptive_noise: bool = False) -> UpdatePartials:
    """Everything of :func:`msckf_update` that reads the feature lanes, on
    the lanes ``batch`` holds (all F of them, or one shard's F/feat): the
    window chains, K2, K3, K4, the χ² gate and the sums the replicated
    tail reads.  ``state`` has a segment axis B."""
    dtype, dev = state.dtype, state.device
    B, F, L, _ = batch.meas.shape
    M = state.max_clones
    n = state.n_clones                                        # (B,)
    R_bc = torch.as_tensor(R_bc, device=dev).to(dtype)
    t_bc = torch.as_tensor(t_bc, device=dev).to(dtype)
    chi2, etrunc = _gate_tables(2 * L, dtype, dev)

    if adaptive_noise:
        scale = torch.clamp(state.sigma2_scale, 0.01, 25.0)
    else:
        scale = torch.ones_like(state.sigma2_scale)
    sig2_eff = (sigma_im ** 2) * scale                        # (B,)

    # ---- window chains (each segment's, shared by its features) ----
    tlen = batch.track_len.long()                             # (B, F)
    c0 = torch.where(batch.is_type2, torch.zeros_like(tlen),
                     n[:, None] - (tlen - 1))
    c0 = torch.clamp(c0, 0, M)
    Rw, tw = window_pose_chain(state.clones, parallel=parallel_chains)
    Rrel_a, trel_a, Rc_a, tc_a = _camera_chains(Rw, tw, c0, L, R_bc, t_bc)
    if fej:
        Rw_j, tw_j = window_pose_chain(state.clones_fej,
                                       parallel=parallel_chains)
        Rrel_j, trel_j, Rc_j, tc_j = _camera_chains(Rw_j, tw_j, c0, L,
                                                    R_bc, t_bc)
    else:
        Rrel_j, trel_j, Rc_j, tc_j = Rrel_a, trel_a, Rc_a, tc_a

    # K2 and K3 take the B·F feature rows (c0 indexes each feature's own
    # segment window, and Hx is per feature)
    BF = B * F

    def rows(x):
        return x.reshape((BF,) + x.shape[2:])

    meas = rows(batch.meas.to(dtype).contiguous())
    phi, psi, rho, ok_lm = lm_triangulate(meas, rows(Rc_a), rows(tc_a),
                                          rows(tlen), sigma_im=sigma_im)

    # Type-2 truncation: only the first half of the track updates
    # (Updater.cc:271-275; Tracker.cc:317-334).
    t_eff = torch.where(batch.is_type2, (tlen + 1) // 2, tlen)
    r_all, Hx_all, hfn = jac_project(
        meas, rows(Rc_j), rows(tc_j), rows(Rrel_j).contiguous(),
        rows(trel_j).contiguous(), rows(Rc_a), rows(tc_a), phi, psi, rho,
        rows(t_eff), rows(c0), R_bc, t_bc, M)
    phi, psi, rho, ok_lm, hfn = (x.reshape(B, F)
                                 for x in (phi, psi, rho, ok_lm, hfn))
    r_all = r_all.reshape(B, F, 2 * L)
    Hx_all = Hx_all.reshape(B, F, 2 * L, 6 * M)
    # rank check on the rho column (Updater.cc:374-378)
    dof = 2 * t_eff - torch.where(hfn < 1e-4, 2, 3)

    # Landmark estimate in the newest window frame (Updater.cc:431-447).
    rho_safe = torch.clamp(rho, min=EPS_DEPTH)
    pf1 = (unit_from_angles(phi, psi) / rho_safe[..., None]) @ R_bc.T + t_bc
    last = torch.clamp(tlen - 1, 0, L - 1)
    seg = torch.arange(B, device=dev)[:, None]
    ar = torch.arange(F, device=dev)[None, :]
    pfk = ((Rrel_a[seg, ar, last] @ pf1[..., None])[..., 0]
           + trel_a[seg, ar, last])

    # ---- Mahalanobis gating (Updater.cc:404-454) ----
    HP = (Hx_all.reshape(B, F * 2 * L, 6 * M) @ state.P[:, 24:, 24:]
          ).reshape(B, F, 2 * L, 6 * M)
    S = HP @ Hx_all.transpose(-1, -2)
    S = S + sig2_eff[:, None, None, None] * torch.eye(2 * L, dtype=dtype,
                                                      device=dev)
    S = 0.5 * (S + S.transpose(-1, -2))
    D_all = torch.abs(batched_quadform(
        S.reshape(BF, 2 * L, 2 * L), r_all.reshape(BF, 2 * L))).reshape(B, F)
    thr = chi2[torch.clamp(dof - 1, 0, 2 * L - 1)]
    # A track of length T spans T-1 transitions; they must all exist in the
    # window (guards front-ends whose tracks predate filter init).
    usable = (batch.valid & ok_lm & (tlen >= 2) & (dof > 0)
              & (tlen - 1 <= n[:, None]))
    passed = usable & (D_all < thr)          # NaN D -> False -> rejected
    sums = {"n_good": torch.sum(passed, dim=-1),              # (B,)
            "n_usable": torch.sum(usable, dim=-1),
            "tl_good_sum": torch.sum(torch.where(
                passed, tlen, torch.zeros_like(tlen)), dim=-1)}
    if adaptive_noise:
        # the whitening EMA's sums: accepted D against the 95 %-truncated
        # chi2 means of their DOFs (core/chi2.py)
        zero = torch.zeros_like(D_all)
        sums["sumD"] = torch.sum(torch.where(passed, D_all, zero), dim=-1)
        sums["denom"] = torch.sum(torch.where(
            passed, etrunc[torch.clamp(dof - 1, 0, 2 * L - 1)], zero),
            dim=-1)

    # ---- stack + compression (Updater.cc:460-536) ----
    Hw = torch.where(passed[..., None, None], Hx_all,
                     torch.zeros_like(Hx_all)).reshape(B, F * 2 * L, 6 * M)
    ro = torch.where(passed[..., None], r_all,
                     torch.zeros_like(r_all)).reshape(B, F * 2 * L, 1)
    stacks = {}
    if compression == "cholesky":
        # information form: the shard's C = Hw^T Hw and b = Hw^T ro
        HwT = Hw.transpose(-1, -2)
        sums["C"] = HwT @ Hw
        sums["b"] = (HwT @ ro)[..., 0]
    elif compression == "qr":
        # one thin QR of the shard's masked stack; R's zero rows (rank
        # deficiency) contribute nothing, like the reference's rank cut
        # (Updater.cc:516)
        Q1, stacks["R"] = torch.linalg.qr(Hw, mode="reduced")
        stacks["rn"] = (Q1.transpose(-1, -2) @ ro)[..., 0]
    else:
        raise ValueError(f"unknown compression '{compression}'")
    lanes = {"passed": passed, "mahalanobis": D_all, "landmarks": pfk,
             "rho": rho}
    return UpdatePartials(sums=sums, stacks=stacks, lanes=lanes, scale=scale,
                          sig2_eff=sig2_eff)


def merge_partials(parts: Sequence[UpdatePartials]) -> UpdatePartials:
    """The partials of several feature shards as one: sums added in shard
    order, stacks' rows concatenated, lanes concatenated (what the
    ``all_reduce`` of parallel/segment.py gives every rank)."""
    first = parts[0]
    sums = {k: functools.reduce(torch.add, [p.sums[k] for p in parts])
            for k in first.sums}
    stacks = {k: torch.cat([p.stacks[k] for p in parts], dim=1)
              for k in first.stacks}
    lanes = {k: torch.cat([p.lanes[k] for p in parts], dim=1)
             for k in first.lanes}
    return UpdatePartials(sums=sums, stacks=stacks, lanes=lanes,
                          scale=first.scale, sig2_eff=first.sig2_eff,
                          shards=sum(p.shards for p in parts))


def update_tail(state: FilterState, parts: UpdatePartials, *,
                min_clone_states: int, compression: str = "qr",
                adaptive_noise: bool = False, adaptive_alpha: float = 0.02,
                adaptive_rampup: int = 0):
    """The replicated half of :func:`msckf_update` on the (summed)
    partials: the EKF correction (K5, :func:`ekf_tail`, on C and b; or,
    with QR compression, the correction on R after one more block QR of
    the shards' stacked R's, :func:`tsqr_compress`), the retraction, the
    gates and the adaptive-noise step.  Returns (new_state,
    diagnostics)."""
    dev = state.device
    dtype = state.dtype
    B = state.P.shape[0]
    M = state.max_clones
    n = state.n_clones
    P = state.P
    sums, scale, sig2_eff = parts.sums, parts.scale, parts.sig2_eff
    n_good = sums["n_good"]
    if compression == "cholesky":
        # C = L L^T, Hn = L^T, rn = L^-1 b, ridge-regularized on the (zero)
        # invalid-clone diagonal: the tail after C and b is K5
        # (ops/ekf_tail.py), one launch for the B systems
        dx, P_new, ridge_fallback = ekf_tail(
            sums["C"], sums["b"], P.contiguous(), sig2_eff.contiguous())
    else:
        Hn_cl, rn = parts.stacks["R"], parts.stacks["rn"]
        if parts.shards > 1:
            Hn_cl, rn = tsqr_compress(Hn_cl, rn)
        dx, P_new = ekf_correction(P, Hn_cl, rn, sig2_eff)
        ridge_fallback = torch.zeros(B, dtype=torch.bool, device=dev)

    # State retraction (Updater.cc:546-613).
    q_G = quat_mul(small_quat_from_dtheta(dx[:, 0:3]), state.q_G)
    p_G = state.p_G + dx[:, 3:6]
    g = state.g + dx[:, 6:9]
    g = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    q_R = quat_mul(small_quat_from_dtheta(dx[:, 9:12]), state.q_R)
    p_R = state.p_R + dx[:, 12:15]
    v_R = state.v_R + dx[:, 15:18]
    bg = state.bg + dx[:, 18:21]
    ba = state.ba + dx[:, 21:24]
    dx_cl = dx[:, 24:].reshape(B, M, 6)
    q_cl = quat_mul(small_quat_from_dtheta(dx_cl[..., :3]),
                    state.clones[..., :4])
    p_cl = state.clones[..., 4:7] + dx_cl[..., 3:6]
    clones = torch.cat([q_cl, p_cl], dim=-1)

    # Gates, per segment: >2 good features (Updater.cc:460) AND enough
    # clones (System.cc:266).  Otherwise pass the propagated state through.
    do_update = (n_good > 2) & (n > min_clone_states)         # (B,)

    if adaptive_noise:
        # whitening EMA: accepted D sums should match the 95 %-truncated
        # chi2 means of their DOFs (core/chi2.py)
        ratio = sums["sumD"] / torch.clamp(sums["denom"], min=1e-6)
        # mass rejection (assumed sigma far below reality): plenty of usable
        # features but the gate passes almost none — walk the scale UP at
        # full rate until features re-engage.  Disabled in warm-start
        # configs (adaptive_rampup > 0), as in the JAX package.
        if adaptive_rampup > 0:
            mass_reject = torch.zeros_like(do_update)
        else:
            mass_reject = (sums["n_usable"] >= 5) & (n_good <= 2)
        ratio = torch.where(mass_reject, torch.full_like(ratio, 4.0), ratio)
        alpha = torch.full_like(ratio, adaptive_alpha)
        if adaptive_rampup > 0:
            # warm-start regime: ramp DOWNWARD adaptation with frame age
            ramp = torch.clamp(state.frame_idx.to(dtype) / adaptive_rampup,
                               max=1.0)
            alpha = torch.where(ratio < 1.0, alpha * ramp, alpha)
        stepped = scale * torch.exp(alpha * torch.log(
            torch.clamp(ratio, 1e-2, 1e2)))
        can_adapt = (n > min_clone_states) & (do_update | mass_reject)
        new_scale = torch.where(can_adapt, torch.clamp(stepped, 0.01, 25.0),
                                state.sigma2_scale).to(dtype)
    else:
        new_scale = state.sigma2_scale

    def sel(a, b):
        return torch.where(do_update.reshape((B,) + (1,) * (a.dim() - 1)),
                           a, b)

    new_state = FilterState(
        q_G=sel(q_G, state.q_G), p_G=sel(p_G, state.p_G), g=sel(g, state.g),
        q_R=sel(q_R, state.q_R), p_R=sel(p_R, state.p_R),
        v_R=sel(v_R, state.v_R), bg=sel(bg, state.bg), ba=sel(ba, state.ba),
        clones=sel(clones, state.clones), P=sel(P_new, state.P),
        n_clones=state.n_clones, frame_idx=state.frame_idx,
        clones_fej=state.clones_fej,  # first estimates are never corrected
        sigma2_scale=new_scale,
    )
    diagnostics = {
        "n_good": n_good, **parts.lanes, "did_update": do_update,
        "n_usable": sums["n_usable"], "tl_good_sum": sums["tl_good_sum"],
        # the applied update's compression needed the wider ridge
        "ridge_fallback": ridge_fallback & do_update,
    }
    return new_state, diagnostics


def msckf_update(state: FilterState, batch: UpdateBatch, *,
                 R_bc, t_bc, sigma_im: float, min_clone_states: int,
                 compression: str = "qr", parallel_chains: bool = False,
                 fej: bool = False, adaptive_noise: bool = False,
                 adaptive_alpha: float = 0.02, adaptive_rampup: int = 0,
                 feat_reduce: Optional[Callable[[UpdatePartials],
                                                UpdatePartials]] = None):
    """Full measurement update; returns (new_state, diagnostics).

    Equivalent to Updater::update (reference: Updater.cc:72-628) plus the
    System-level gate that skips the update until the window has more than
    ``min_clone_states`` clones (System.cc:266).

    ``adaptive_noise``: innovation-based online calibration of the
    image-noise variance (the running ratio of accepted Mahalanobis
    distances to their truncated chi2 means drives a multiplicative EMA on
    ``state.sigma2_scale``), with the mass-rejection escape.  ``fej``:
    first-estimates Jacobians — Hf/Hx linearize the window chain at
    ``state.clones_fej`` while residuals and triangulation use the current
    clones.  Both as in the JAX package; ``fej=False`` and
    ``adaptive_noise=False`` are strict reference parity.

    A state with a segment axis B takes an UpdateBatch with the same
    leading axis ((B, F, L, 2), ...): every gate and selection is per
    segment, K2, K3 and K4 run on the B·F feature rows and K5 on the B
    systems, each in one launch; the diagnostics carry the axis too.  One
    filter's state runs as a batch of one.

    The body is :func:`update_partials` on the lanes of ``batch``, then
    :func:`update_tail`.  ``feat_reduce`` joins the two when the lanes are
    one shard of the feature axis: it takes this shard's partials and
    returns those of every shard merged (:func:`merge_partials`; the
    ``all_reduce`` of parallel/segment.py), identical on every shard, so
    every shard applies the same correction.  The per-lane diagnostics
    (passed, mahalanobis, landmarks, rho) are then the shard's lanes.
    """
    if not state.batched:
        new_state, diag = msckf_update(
            add_segment_axis(state), add_segment_axis(batch), R_bc=R_bc,
            t_bc=t_bc, sigma_im=sigma_im, min_clone_states=min_clone_states,
            compression=compression, parallel_chains=parallel_chains,
            fej=fej, adaptive_noise=adaptive_noise,
            adaptive_alpha=adaptive_alpha, adaptive_rampup=adaptive_rampup,
            feat_reduce=feat_reduce)
        return (drop_segment_axis(new_state),
                {k: v.squeeze(0) for k, v in diag.items()})
    parts = update_partials(state, batch, R_bc=R_bc, t_bc=t_bc,
                            sigma_im=sigma_im, compression=compression,
                            parallel_chains=parallel_chains, fej=fej,
                            adaptive_noise=adaptive_noise)
    if feat_reduce is not None:
        parts = feat_reduce(parts)
    return update_tail(state, parts, min_clone_states=min_clone_states,
                       compression=compression,
                       adaptive_noise=adaptive_noise,
                       adaptive_alpha=adaptive_alpha,
                       adaptive_rampup=adaptive_rampup)
