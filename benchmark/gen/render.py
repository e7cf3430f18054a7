"""The benchmark's renderer: a PyTorch copy of the port's ``render_frame``
(rvio_tpu_torch/dataio/synthetic.py) that paints many frames at once on
the card.

Each visible landmark paints a 2x2 checkerboard tile of 8 x 8 pixels at
its projected pixel (230 on the diagonal quadrants, 20 off it) over a
mildly vignetted background.  Where tiles overlap, the landmark painted
last in the original (the highest index among the visible ones) wins.
The projection runs on the host in float64 with the original's numpy
expressions, so a pixel's tile is the original's; the frames come out as
the u8 frames the original's ``np.clip(...).astype(np.uint8)`` gives.
"""

from __future__ import annotations

import numpy as np
import torch

BLOB = 4


def project(cfg, seq, k: int):
    """Distorted pixels and visibility of every landmark at frame k (the
    original's ``project_landmarks``)."""
    c = cfg.camera
    R = seq.gt_R[k]
    p_cam_w = seq.gt_p[k] + R @ c.t_bc
    R_wc = R @ c.R_bc
    pc = (seq.landmarks - p_cam_w) @ R_wc
    z = pc[:, 2]
    zs = np.where(np.abs(z) < 1e-6, 1e-6, z)
    xn = pc[:, 0] / zs
    yn = pc[:, 1] / zs
    if c.is_fisheye:
        r = np.sqrt(np.maximum(xn * xn + yn * yn, 1e-18))
        theta = np.arctan(r)
        th2 = theta * theta
        theta_d = theta * (1 + th2 * (c.k1 + th2 * (c.k2 + th2 * (
            c.p1 + th2 * c.p2))))
        s = theta_d / r
        xd, yd = xn * s, yn * s
    else:
        r2 = xn * xn + yn * yn
        radial = 1.0 + r2 * (c.k1 + r2 * (c.k2 + r2 * c.k3))
        xd = xn * radial + 2.0 * c.p1 * xn * yn + c.p2 * (r2 + 2.0 * xn * xn)
        yd = yn * radial + c.p1 * (r2 + 2.0 * yn * yn) + 2.0 * c.p2 * xn * yn
    px = np.stack([xd * c.fx + c.cx, yd * c.fy + c.cy], axis=1)
    vis = ((z > 0.4) & (z < 25.0) & (px[:, 0] > 12) & (px[:, 0] < c.width - 12)
           & (px[:, 1] > 12) & (px[:, 1] < c.height - 12))
    return px, vis


def background(H: int, W: int, base: float = 80.0) -> np.ndarray:
    """The original's background as u8."""
    img = np.full((H, W), base, np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    img += 20.0 * np.cos(2 * np.pi * xx / W) * np.cos(2 * np.pi * yy / H)
    return np.clip(img, 0, 255).astype(np.uint8)


def render(cfg, seq, frames, device, block: int = 64) -> np.ndarray:
    """The u8 frames ``frames`` of ``seq`` as one (n, H, W) host array,
    painted on ``device`` ``block`` frames at a time."""
    H, W = cfg.camera.height, cfg.camera.width
    frames = list(frames)
    out = np.empty((len(frames), H, W), np.uint8)
    bg = torch.as_tensor(background(H, W), device=device)
    d = torch.arange(-BLOB, BLOB, device=device)
    dy, dx = (x.reshape(-1) for x in torch.meshgrid(d, d, indexing="ij"))
    for b0 in range(0, len(frames), block):
        ks = frames[b0:b0 + block]
        cols = []
        for j, k in enumerate(ks):
            px, vis = project(cfg, seq, k)
            # Python's round, half to even, as torch.round
            xy = np.round(px[vis])
            cols.append(np.column_stack([np.full(len(xy), j), xy]))
        tiles = torch.as_tensor(np.concatenate(cols), device=device)
        f = tiles[:, 0].long()
        xi, yi = tiles[:, 1].long(), tiles[:, 2].long()
        n = len(ks)
        # each pixel takes the last tile over it: the largest tile index
        x = xi[:, None] + dx
        y = yi[:, None] + dy
        inside = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        pix = (f[:, None] * H + y) * W + x
        order = torch.arange(len(f), device=device)[:, None].expand_as(pix)
        owner = torch.full((n * H * W,), -1, dtype=torch.long, device=device)
        owner.scatter_reduce_(0, pix[inside], order[inside], "amax")
        img = bg.expand(n, H, W).clone().reshape(-1)
        hit = torch.nonzero(owner >= 0).squeeze(1)
        o = owner[hit]
        py = (hit // W) % H
        pxx = hit % W
        same = (py >= yi[o]) == (pxx >= xi[o])
        img[hit] = torch.where(same, 230, 20).to(torch.uint8)
        out[b0:b0 + n] = img.reshape(n, H, W).cpu().numpy()
    return out
