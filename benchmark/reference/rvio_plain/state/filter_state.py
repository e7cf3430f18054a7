"""The robocentric filter state — the central data structure.

Port of rvio_tpu/state/filter_state.py.  The clone window is held at its
*maximum* size M at all times and masked by ``n_clones`` during the growth
phase, so every per-frame operation has static shapes.  With the EuRoC
config (M=14): x is 124 floats, P is 108x108.

Full state x (structured):
    q_G  (4)  global-frame orientation in current robocentric frame {Rk} (JPL)
    p_G  (3)  global origin position in {Rk}
    g    (3)  unit gravity direction in {Rk} (gravity is a state)
    q_R  (4)  relative rotation {Rk} -> current IMU frame (identity at frame start)
    p_R  (3)  relative translation (zero at frame start)
    v_R  (3)  velocity in current IMU frame
    bg   (3)  gyro bias
    ba   (3)  accel bias
    clones (M, 7)  relative poses (q, p) of the window frames, oldest first

Error state / covariance P (24 + 6M square):
    [dθG, dpG, dg, dθR, dpR, dvR, dbg, dba] (3 each), then 6 per clone.
Invalid clone rows/cols of P are identically zero; invalid clone quats are
identity.

``n_clones`` and ``frame_idx`` are 0-d int64 tensors on the state's device,
so the per-frame step never reads them on the host.

Every field may carry one leading segment axis B (B filters advancing in
lockstep, rvio_tpu_torch/runtime/step.py make_batched_sequence_scan): the
filter stages run on such a state as they run on one filter, and
:func:`stack_states` builds it from B states.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Callable, Sequence

import numpy as np
import torch

from benchmark.reference.rvio_plain.core.quaternion import rot_to_quat
from benchmark.reference.rvio_plain.core.so3 import skew
from benchmark.reference.rvio_plain.device import resolve_device


class StateIndex:
    """Error-state block indices (reference: PreIntegrator.cc:123-131)."""

    TH_G = 0    # dθG
    P_G = 3     # dpG
    G = 6       # dg
    TH_R = 9    # dθR
    P_R = 12    # dpR
    V_R = 15    # dvR
    BG = 18     # dbg
    BA = 21     # dba
    CORE = 24   # clones start here; 6 per clone
    CLONE = 6


@dataclass
class FilterState:
    """Filter state; every field a tensor on one device, each with the
    same leading segment axis B or none (the shapes below are one
    filter's).

    Treated as immutable: the filter stages return new states.
    """

    q_G: torch.Tensor        # (4,)
    p_G: torch.Tensor        # (3,)
    g: torch.Tensor          # (3,)
    q_R: torch.Tensor        # (4,)
    p_R: torch.Tensor        # (3,)
    v_R: torch.Tensor        # (3,)
    bg: torch.Tensor         # (3,)
    ba: torch.Tensor         # (3,)
    clones: torch.Tensor     # (M, 7) [qx qy qz qw px py pz], oldest first
    P: torch.Tensor          # (24+6M, 24+6M)
    n_clones: torch.Tensor   # () int64 — valid clones
    frame_idx: torch.Tensor  # () int64 — images processed since init
    # First-estimate (FEJ) clone values: each slot holds the clone's value
    # at augmentation time, never corrected by EKF updates (tpu.fej).
    clones_fej: torch.Tensor  # (M, 7)
    # Adaptive measurement-noise scale on sigma_im^2 (tpu.adaptive_noise).
    sigma2_scale: torch.Tensor  # () scalar

    @property
    def max_clones(self) -> int:
        return self.clones.shape[-2]

    @property
    def err_dim(self) -> int:
        return self.P.shape[-1]

    @property
    def batched(self) -> bool:
        """Whether the fields carry a leading segment axis."""
        return self.P.dim() == 3

    @property
    def dtype(self):
        return self.P.dtype

    @property
    def device(self):
        return self.P.device


_INT_FIELDS = ("n_clones", "frame_idx")


def map_fields(fn: Callable, obj):
    """``fn`` over every field of a dataclass of tensors (a FilterState,
    an ImuBlock, an UpdateBatch); a new instance."""
    return replace(obj, **{f.name: fn(getattr(obj, f.name))
                           for f in fields(obj)})


def add_segment_axis(obj):
    """One filter's dataclass of tensors as a batch of one (B = 1)."""
    return map_fields(lambda x: x.unsqueeze(0), obj)


def drop_segment_axis(obj):
    """The only segment of a batch of one, as one filter's (views)."""
    return map_fields(lambda x: x.squeeze(0), obj)


def stack_states(states: Sequence[FilterState]) -> FilterState:
    """Stack per-segment FilterStates along a new leading axis (the port
    of rvio_tpu/parallel/segment.py ``stack_states``)."""
    return FilterState(**{f.name: torch.stack([getattr(s, f.name)
                                               for s in states])
                          for f in fields(FilterState)})


def state_from_numpy(d: dict, device, dtype=torch.float32) -> FilterState:
    """FilterState from a dict of arrays keyed by the JAX FilterState's
    field names (rvio_tpu/state/filter_state.py), on ``device``.  The
    arrays may carry a leading segment axis (a stack of JAX states, as
    rvio_tpu/parallel/segment.py ``stack_states`` builds it): the state is
    then a batch of as many filters."""
    kw = {}
    for f in fields(FilterState):
        v = np.asarray(d[f.name])
        if f.name in _INT_FIELDS:
            kw[f.name] = torch.as_tensor(v.astype(np.int64), device=device)
        else:
            kw[f.name] = torch.as_tensor(v.astype(np.float64), device=device
                                         ).to(dtype)
    return FilterState(**kw)


def state_to_numpy(state: FilterState) -> dict:
    """Dict of host arrays with the JAX FilterState's field names
    (integer counters as int32, as there), with the state's segment axis
    where it has one."""
    out = {}
    for f in fields(FilterState):
        v = getattr(state, f.name).detach().cpu().numpy()
        out[f.name] = v.astype(np.int32) if f.name in _INT_FIELDS else v
    return out


def make_initial_state(max_clones: int, dtype=torch.float32,
                       device=None) -> FilterState:
    """Zero state with identity quaternions (pre-initialization placeholder)
    on ``device`` (``None``: the CUDA device)."""
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    qid = torch.zeros(4, **kw)
    qid[3] = 1.0
    clones = torch.zeros(max_clones, 7, **kw)
    clones[:, 3] = 1.0
    g = torch.zeros(3, **kw)
    g[2] = 1.0
    d = 24 + 6 * max_clones
    i64 = dict(dtype=torch.int64, device=device)
    return FilterState(
        q_G=qid, p_G=torch.zeros(3, **kw), g=g, q_R=qid.clone(),
        p_R=torch.zeros(3, **kw), v_R=torch.zeros(3, **kw),
        bg=torch.zeros(3, **kw), ba=torch.zeros(3, **kw), clones=clones,
        P=torch.zeros(d, d, **kw), n_clones=torch.zeros((), **i64),
        frame_idx=torch.zeros((), **i64), clones_fej=clones.clone(),
        sigma2_scale=torch.ones((), **kw),
    )


def static_initialize(w_avg, a_avg, n_imu: int, *, gravity: float,
                      imu_rate: float, sigma_a: float, sigma_wg: float,
                      sigma_wa: float, enable_alignment: bool,
                      max_clones: int, sigma_v0: float = 0.0,
                      use_bias_estimates: bool = True,
                      dR_since_avg=None, dtype=torch.float32,
                      device=None) -> FilterState:
    """Build the initial filter state from a static-window IMU average.

    Mirrors System::initialize (reference: System.cc:115-170):
    - gravity direction g = a_avg / |a_avg| in {R0};
    - optional gravity-aligned {G} axes -> q_G;
    - biases bg = w_avg, ba = a_avg - G*g when >1 static samples were seen;
    - P0 diagonal scaled by the static duration n_imu/imu_rate.

    ``w_avg``/``a_avg``/``dR_since_avg`` are host arrays (the init gate
    runs on the host); the state is built on ``device`` (``None``: the CUDA
    device) in ``dtype``.  ``dR_since_avg`` transports the averaged
    gravity/axes from the frozen average window into the gate-fire frame
    (init.forward_rotate_attitude).
    """
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    w_avg = torch.as_tensor(np.asarray(w_avg, np.float64), device=device).to(dtype)
    a_avg = torch.as_tensor(np.asarray(a_avg, np.float64), device=device).to(dtype)
    g = a_avg / torch.linalg.vector_norm(a_avg)

    # Gravity-aligned {G}: z along g, x = e_x orthogonalized, y = z × x
    # (reference: System.cc:122-140).
    zv = g
    ex = torch.zeros(3, **kw)
    ex[0] = 1.0
    xv = ex - zv * torch.dot(zv, ex)
    xv = xv / torch.linalg.vector_norm(xv)
    yv = skew(zv) @ xv
    yv = yv / torch.linalg.vector_norm(yv)
    R_aligned = torch.stack([xv, yv, zv], dim=-1)
    R = R_aligned if enable_alignment else torch.eye(3, **kw)

    st = make_initial_state(max_clones, dtype, device)
    if use_bias_estimates:
        bg = w_avg
        ba = a_avg - gravity * g
    else:
        bg = torch.zeros(3, **kw)
        ba = torch.zeros(3, **kw)

    if dR_since_avg is not None:
        # v_fire = dR^T v_onset (biases are body-fixed)
        dRT = torch.as_tensor(np.asarray(dR_since_avg, np.float64),
                              device=device).to(dtype).T
        g = dRT @ g
        g = g / torch.linalg.vector_norm(g)
        R = dRT @ R

    n = torch.as_tensor(float(n_imu), **kw)
    dt = 1.0 / imu_rate
    diag = torch.zeros(24 + 6 * max_clones, **kw)
    diag[0:6] = 1e-3 ** 2                          # qG, pG
    diag[6:9] = n * dt * sigma_a ** 2              # g
    diag[15:18] = sigma_v0 ** 2                    # vR (see config)
    diag[18:21] = n * dt * sigma_wg ** 2           # bg
    diag[21:24] = n * dt * sigma_wa ** 2           # ba
    P = torch.diag(diag)

    return FilterState(
        q_G=rot_to_quat(R), p_G=st.p_G, g=g, q_R=st.q_R, p_R=st.p_R,
        v_R=st.v_R, bg=bg, ba=ba, clones=st.clones, P=P,
        n_clones=st.n_clones, frame_idx=st.frame_idx,
        clones_fej=st.clones_fej, sigma2_scale=st.sigma2_scale,
    )


def clone_err_slice(i: int) -> slice:
    """Error-state rows of clone i."""
    return slice(StateIndex.CORE + 6 * i, StateIndex.CORE + 6 * i + 6)
