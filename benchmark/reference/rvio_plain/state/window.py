"""Sliding-window operations: clone augmentation/marginalization, composition.

Port of rvio_tpu/state/window.py.  The reference grows/shrinks x and P
dynamically (System.cc:280-323); here both branches (growth and slide) are
one static-shape gather ``P[src][:, src]``: the reference's Jacobian J has
only elementary unit rows, so J P J^T is a row/column permutation with
duplication.  Branches on the window count are ``torch.where`` on device
tensors, so no step reads state back to the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.rvio_plain.core.quaternion import quat_identity, quat_mul, quat_to_rot
from benchmark.reference.rvio_plain.core.so3 import skew
from benchmark.reference.rvio_plain.state.filter_state import (FilterState, add_segment_axis,
                                               drop_segment_axis)


def augment_window(state: FilterState) -> FilterState:
    """Append a clone of (q_R, p_R); marginalize the oldest if the window is full.

    Mirrors reference System.cc:280-323:
    - growth phase (n < M): new clone slot n gets (q_R, p_R); its covariance
      rows/cols are copies of the dθR/dpR rows (indices 9:15);
    - full window: clones shift left by one (oldest marginalized), the new
      clone lands in the last slot.
    Skipped entirely on the first post-init image (System.cc:280).

    Each segment of a state with a segment axis takes its own branch, slot
    and permutation; one filter's state runs as a batch of one.
    """
    if not state.batched:
        return drop_segment_axis(augment_window(add_segment_axis(state)))
    M = state.max_clones
    D = state.err_dim
    n = state.n_clones                                        # (B,)
    dev = state.device
    nb = n[:, None]

    r = torch.arange(D, device=dev)
    j = torch.div(r - 24, 6, rounding_mode="floor")   # clone of row r (r>=24)
    o = torch.remainder(r - 24, 6)
    growth_src = torch.where(r < 24, r, torch.where(j == nb, 9 + o, r))
    full_src = torch.where(r < 24, r, torch.where(j < M - 1, r + 6, 9 + o))
    src = torch.where(nb < M, growth_src, full_src)           # (B, D)
    seg = torch.arange(n.shape[0], device=dev)[:, None, None]
    P_aug = state.P[seg, src[:, :, None], src[:, None, :]]

    new_clone = torch.cat([state.q_R, state.p_R], dim=-1)[:, None]  # (B,1,7)
    slot = (torch.arange(M, device=dev)[None, :, None]
            == torch.clamp(n, 0, M - 1)[:, None, None])
    grow = (n < M)[:, None, None]

    def _append(window):
        growth = torch.where(slot, new_clone, window)
        full = torch.cat([window[:, 1:], new_clone], dim=1)
        return torch.where(grow, growth, full)

    clones_aug = _append(state.clones)
    # The new clone's FEJ value IS its current (first) estimate; existing
    # FEJ slots shift with the window but are never re-estimated.
    fej_aug = _append(state.clones_fej)
    n_aug = torch.clamp(n + 1, max=M)

    # First post-init image: no augmentation (window still empty).
    do_aug = state.frame_idx > 0                              # (B,)
    do3 = do_aug[:, None, None]
    return FilterState(
        q_G=state.q_G, p_G=state.p_G, g=state.g, q_R=state.q_R,
        p_R=state.p_R, v_R=state.v_R, bg=state.bg, ba=state.ba,
        clones=torch.where(do3, clones_aug, state.clones),
        P=torch.where(do3, P_aug, state.P),
        n_clones=torch.where(do_aug, n_aug, n),
        frame_idx=state.frame_idx,
        clones_fej=torch.where(do3, fej_aug, state.clones_fej),
        sigma2_scale=state.sigma2_scale,
    )


def compose_state(state: FilterState
                  ) -> Tuple[FilterState, Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]]:
    """Robocentric-to-global composition; re-centers the frame of reference.

    Mirrors reference System.cc:325-365: rotates (q_G, p_G, g) into the new
    frame {Rk+1}, resets (q_R, p_R), transforms the covariance by the 24x24
    composition Jacobian Vk, and emits the global pose output
    (q_kG, p_Gk = R_G^T (p_k - p_G)) plus the local velocity.

    A state with a segment axis composes each segment with its own Vk;
    one filter's state runs as a batch of one.
    """
    if not state.batched:
        new_state, out = compose_state(add_segment_axis(state))
        return drop_segment_axis(new_state), tuple(x[0] for x in out)
    kw = dict(dtype=state.dtype, device=state.device)
    qG, pG, gk = state.q_G, state.p_G, state.g
    qk, pk, vk = state.q_R, state.p_R, state.v_R
    B = qk.shape[0]

    def mv(A, x):
        return (A @ x[..., None])[..., 0]

    RG = quat_to_rot(qG)
    Rk = quat_to_rot(qk)

    g_new = mv(Rk, gk)
    g_new = g_new / torch.linalg.vector_norm(g_new, dim=-1, keepdim=True)

    q_kG = quat_mul(qk, qG)
    p_kG = mv(Rk, pG - pk)           # new p_G (global origin in {Rk+1})
    p_Gk = mv(RG.transpose(-1, -2), pk - pG)   # output: IMU position in {G}

    # each segment's Vk, written into a tensor of this call's own
    eye3 = torch.eye(3, **kw)
    Vk = torch.zeros(B, 24, 24, **kw)
    Vk[:, 0:3, 0:3] = Rk
    Vk[:, 0:3, 9:12] = eye3
    Vk[:, 3:6, 3:6] = Rk
    Vk[:, 3:6, 9:12] = skew(p_kG)
    Vk[:, 3:6, 12:15] = -Rk
    Vk[:, 6:9, 6:9] = Rk
    Vk[:, 6:9, 9:12] = skew(g_new)
    Vk[:, 15:24, 15:24] = torch.eye(9, **kw)

    P = state.P
    VkT = Vk.transpose(-1, -2)
    core = Vk @ P[:, :24, :24] @ VkT
    cross = Vk @ P[:, :24, 24:]
    P = torch.cat([torch.cat([core, cross], dim=-1),
                   torch.cat([cross.transpose(-1, -2), P[:, 24:, 24:]],
                             dim=-1)], dim=-2)
    P = 0.5 * (P + P.transpose(-1, -2))

    new_state = FilterState(
        q_G=q_kG, p_G=p_kG, g=g_new,
        q_R=quat_identity(**kw).expand(B, 4).contiguous(),
        p_R=torch.zeros(B, 3, **kw), v_R=vk, bg=state.bg, ba=state.ba,
        clones=state.clones, P=P, n_clones=state.n_clones,
        frame_idx=state.frame_idx + 1, clones_fej=state.clones_fej,
        sigma2_scale=state.sigma2_scale,
    )
    return new_state, (q_kG, p_Gk, vk)
