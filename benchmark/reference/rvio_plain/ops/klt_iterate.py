"""K8 (one Lucas-Kanade pyramid level) and K9 (cornerSubPix refinement).

Replace rvio_tpu/ops/klt_iterate.py: ``lk_level_pallas``
(``_lk_level_kernel``), CUDA source ``csrc/lk_level.cu``, and
``subpix_refine_pallas`` (``_subpix_kernel``), CUDA source
``csrc/subpix_refine.cu``.

Both compute the JAX package's CPU oracle on the tracker's own tiles, not
the TPU kernels' variant of it:

- ``lk_level`` is one level of ``frontend.klt.klt_track``
  (rvio_tpu/frontend/klt.py:178-268) from the gathered 40 x 32 tiles on:
  the tile Scharr gradients with a reflect pad, template and gradient
  patches whose taps clip one by one to ``[0, tile-2]``, the min-eigenvalue
  and determinant test, up to ``max_iters`` Gauss-Newton steps with the
  wander kill and, at level 0, the in-bounds test and the mean-abs error.
  The TPU kernel clamps the whole sampling window instead ("base clamp",
  rvio_tpu/ops/klt_iterate.py:25-30) on larger edge-padded tiles; that was
  a TPU workaround for static vector offsets.
- ``subpix_refine`` is ``corner_subpix``'s loop
  (rvio_tpu/frontend/detector.py:198-237) on the same 40 x 32 tiles:
  10 fixed iterations of a 17 x 17 patch, the Gaussian weight mask and
  steps clipped to +-1 px.  The TPU kernel samples edge-padded 56 x 48
  tiles.

The oracle's LK loop is a batch ``while`` that stops when no feature is
live.  A feature that converged keeps being tested against the wander
bound on the trips other features still run, so its final status depends
on T, the largest trip count in the call.  The kernel runs each feature's
own trips, counts them, and the block that finishes last (a ticket drawn
by every block, one counter per CUDA stream, kept here) takes T and
applies that last wander test in the same launch; the plain version runs
all ``max_iters`` trips with the test gated on "some feature still live".
A batched tracker's B segments are one call, and the oracle vmapped over
them stops each segment's loop at its own T: so T, the gate and the
ticket are per segment (flattening the B·N features would change the
function), and no kernel block holds features of two segments.

Bounds on the H100 at the operating point (200 features, 40 x 32 f32
tiles, win 15, 30 iterations at most; 10 iterations of a 17 x 17 patch for
subpix), counting only the tile pixels the function samples
(``ops/checks.py``: ``lk_level_reads``, ``subpix_reads``): K8 reads each
template's window support with its Scharr halo (:func:`template_support`)
and the search-tile windows its live trips visit, about 0.48 MB in the
check, 0.14 us at 3.35 TB/s, more than its operations (6.8 MFLOP, 0.10 us
at 67 TFLOP/s); K9 reads the patch supports of its iterations, 0.35 MB or
0.10 us, and its 15.5 MFLOP take 0.23 us: it is bound by operations.  Both
bounds are far under a launch.  They are latency-bound chains of dependent
iterations.  K8 answers that with a warp per feature: both tiles arrive by
one bulk copy each, the template's gradients are formed over its support
box only, a lane keeps a strip of eight window taps (a column of the
window from 17 x 17 to 31 x 31, the widest a 32-wide tile leaves room
for) and the search pixels under it in registers and every sum is a
warp shuffle, so a Gauss-Newton step never waits on a block barrier or
touches device memory; past 31 x 31, where the tracker's wander bound is
negative and the first trip kills every feature, an instance without
trips writes the plain version's outputs (the guesses unmoved, every
status false, the last level's error at the guess);
the block that finishes last applies the T rule in the same launch
(csrc/lk_level.cu).  K9 gives a corner two warps: the
tile by one bulk copy, each warp a band of the window's rows with its
patch samples and taps laid out once, the five sums by warp shuffles and
one named barrier a step, every element operation rounded as the plain
version's (csrc/subpix_refine.cu).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from benchmark.reference.rvio_plain.ops import _lib

_LK_LIB = "lk_level"
# rvio_lk_level (one segment), then rvio_lk_level_batch (B segments)
_LK_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
            + [ctypes.c_int] * 3)
_LK_BATCH_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                  + [ctypes.c_float] * 3 + [ctypes.c_int] * 3)
# K8's finish tickets: per device a buffer of counters, for each stream
# one a segment of a call (at most _TICKET_SEGMENTS segments)
_TICKET_SLOTS = 256
_TICKET_SEGMENTS = 256
_tickets: dict = {}
_SP_LIB = "subpix_refine"
_SP_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
# K8: a column of the window a lane from win 17 to 31; past it the
# instance without trips (the wander bound is negative there)
_LK_MAX_WIN = 31
_SP_MAX_TAPS = 256  # K9: win <= 7


# --- sampling primitives of the oracle (frontend/klt.py:96-147) -------------

def _window_indices(local: torch.Tensor, win: int, tile: int):
    """Contiguous tap window start indices along one axis: (idx (N, win)
    clipped to [0, tile-2], frac (N,)); every tap shares one fraction."""
    r = win // 2
    f = torch.floor(local)
    frac = local - f
    idx = f.long()[:, None] + (torch.arange(win, device=local.device)
                               - r)[None, :]
    return torch.clamp(idx, 0, tile - 2), frac


def _sample_patches(tiles: torch.Tensor, loc_y: torch.Tensor,
                    loc_x: torch.Tensor, win: int) -> torch.Tensor:
    """(N, TH, TW) tiles sampled bilinearly at fractional centres ->
    (N, win, win): one 2-tap blend of the whole tile per axis, then a
    contiguous-window gather."""
    N, TH, TW = tiles.shape
    fy, wy = _window_indices(loc_y, win, TH)
    fx, wx = _window_indices(loc_x, win, TW)
    rows_b = (tiles[:, :-1, :] * (1 - wy)[:, None, None]
              + tiles[:, 1:, :] * wy[:, None, None])            # (N, TH-1, TW)
    rows = torch.gather(rows_b, 1, fy[:, :, None].expand(N, win, TW))
    cols_b = (rows[:, :, :-1] * (1 - wx)[:, None, None]
              + rows[:, :, 1:] * wx[:, None, None])              # (N, win, TW-1)
    return torch.gather(cols_b, 2, fx[:, None, :].expand(N, win, win))


def _tile_scharr(tiles: torch.Tensor):
    """Scharr gradients of gathered tiles, reflect-padded."""
    p = F.pad(tiles[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
    a, b = 3 / 32, 10 / 32
    sy = a * p[:, :-2, :] + b * p[:, 1:-1, :] + a * p[:, 2:, :]
    gx = sy[:, :, 2:] - sy[:, :, :-2]
    dy = p[:, 2:, :] - p[:, :-2, :]
    gy = a * dy[:, :, :-2] + b * dy[:, :, 1:-1] + a * dy[:, :, 2:]
    return gx, gy


def _inb(g: torch.Tensor, rb: int, hw) -> torch.Tensor:
    H, W = hw
    return ((g[:, 0] > rb) & (g[:, 0] < W - rb - 1)
            & (g[:, 1] > rb) & (g[:, 1] < H - rb - 1))


# --- K8: one LK pyramid level -------------------------------------------------

def lk_level_trips(t_tiles, n_tiles, loc0, g_init, o1, status, *, win: int,
                   max_iters: int, eps: float, min_eig: float, wander: float,
                   last: bool = False, hw=(0, 0)):
    """The plain version's outputs plus each feature's trip count (N,):
    the Gauss-Newton trips it ran while live.  With a leading segment axis
    (every argument (B, N, ...)) the features run as B·N rows, each
    segment's trips gated on its own live features; outputs (B, N, ...)."""
    kw = dict(win=win, max_iters=max_iters, eps=eps, min_eig=min_eig,
              wander=wander, last=last, hw=hw)
    if t_tiles.dim() == 3:
        return _lk_rows(t_tiles, n_tiles, loc0, g_init, o1, status, **kw,
                        segments=1)
    B, N = t_tiles.shape[:2]
    rows = [x.reshape((B * N,) + tuple(x.shape[2:]))
            for x in (t_tiles, n_tiles, loc0, g_init, o1, status)]
    out = _lk_rows(*rows, **kw, segments=B)
    return tuple(x.reshape((B, N) + tuple(x.shape[1:])) for x in out)


def _lk_rows(t_tiles, n_tiles, loc0, g_init, o1, status, *, win, max_iters,
             eps, min_eig, wander, last, hw, segments: int):
    """:func:`lk_level_trips` on the feature rows of ``segments`` equal
    segments in turn, each with its own "still live" gate."""
    dtype = loc0.dtype
    TH, TW = n_tiles.shape[1:]
    area = win * win
    t_gx, t_gy = _tile_scharr(t_tiles)
    tmpl = _sample_patches(t_tiles, loc0[:, 1], loc0[:, 0], win)
    gx = _sample_patches(t_gx, loc0[:, 1], loc0[:, 0], win)
    gy = _sample_patches(t_gy, loc0[:, 1], loc0[:, 0], win)

    gxx = torch.sum(gx * gx, dim=(1, 2))
    gxy = torch.sum(gx * gy, dim=(1, 2))
    gyy = torch.sum(gy * gy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    meig = (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) / (2 * area)
    ok_level = (meig > min_eig) & (det > 1e-12)
    zero = torch.zeros((), dtype=dtype, device=det.device)
    dets = torch.where(det == 0, torch.ones_like(det), det)
    inv00 = torch.where(ok_level, gyy / dets, zero)
    inv01 = torch.where(ok_level, -gxy / dets, zero)
    inv11 = torch.where(ok_level, gxx / dets, zero)

    o1f = o1.to(dtype)
    g = g_init
    alive = status & ok_level
    conv = torch.zeros_like(alive)
    trips = torch.zeros(alive.shape, dtype=torch.int32, device=alive.device)
    for _ in range(max_iters):
        live = ~conv & alive
        # the oracle's batch loop still runs, in each segment
        running = live.reshape(segments, -1).any(-1).repeat_interleave(
            live.shape[0] // segments)
        trips = trips + live.int()
        d = torch.abs(g - g_init)
        alive = alive & (((d[:, 0] <= wander) & (d[:, 1] <= wander))
                         | ~running)
        loc = g - o1f
        cur = _sample_patches(n_tiles, torch.clamp(loc[:, 1], 0.0, TH - 1.0),
                              torch.clamp(loc[:, 0], 0.0, TW - 1.0), win)
        di = cur - tmpl
        bx = torch.sum(di * gx, dim=(1, 2))
        by = torch.sum(di * gy, dim=(1, 2))
        step = torch.stack([-(inv00 * bx + inv01 * by),
                            -(inv01 * bx + inv11 * by)], dim=-1)
        take = (~conv & alive)[:, None]
        g = torch.where(take, g + step, g)
        conv = conv | (torch.sum(step * step, dim=-1) < eps * eps)

    err = torch.zeros_like(gxx)
    if last:
        alive = alive & _inb(g, win // 2 + 1, hw)
        loc = g - o1f
        cur = _sample_patches(n_tiles, torch.clamp(loc[:, 1], 0.0, TH - 1.0),
                              torch.clamp(loc[:, 0], 0.0, TW - 1.0), win)
        err = torch.mean(torch.abs(cur - tmpl), dim=(1, 2))
    return g, alive, err, trips


def lk_level_plain(t_tiles, n_tiles, loc0, g_init, o1, status, **kw):
    """Plain version of :func:`lk_level`: all ``max_iters`` trips with
    masks, no host sync."""
    return lk_level_trips(t_tiles, n_tiles, loc0, g_init, o1, status, **kw)[:3]


def lk_level(t_tiles: torch.Tensor, n_tiles: torch.Tensor,
             loc0: torch.Tensor, g_init: torch.Tensor, o1: torch.Tensor,
             status: torch.Tensor, *, win: int, max_iters: int, eps: float,
             min_eig: float, wander: float, last: bool = False, hw=(0, 0)):
    """One LK pyramid level for N features.

    t_tiles/n_tiles: (N, TH, TW) template tiles of the previous image and
    search tiles of the next one; loc0 (N, 2) xy template centre in tile
    coordinates; g_init (N, 2) xy level-entry guess in image coordinates;
    o1 (N, 2) int origin of the search tiles; status (N,) bool live lanes
    (in-bounds already folded in).  ``last`` (level 0, image size ``hw`` =
    (H, W)) adds the in-bounds test of the result and the mean-abs error.
    Returns (guess (N, 2), status (N,) bool, err (N,)).  With a leading
    segment axis B on every argument and output, each segment is the call
    on its own features (its own T).

    A CUDA tensor runs the kernel (f32 tiles and points, int32 origins;
    tiles of a multiple of 4 pixels starting on 16-byte boundaries, any
    window, past 31 x 31 with a negative ``wander`` as the tracker's is
    there, at most 256 segments; one launch for the B segments); a CPU
    tensor the plain version."""
    kw = dict(win=win, max_iters=max_iters, eps=eps, min_eig=min_eig,
              wander=wander, last=last, hw=hw)
    if not _lib.uses_kernel(t_tiles, "lk_level"):
        return lk_level_plain(t_tiles, n_tiles, loc0, g_init, o1, status, **kw)
    lead = tuple(t_tiles.shape[:1]) if t_tiles.dim() == 4 else ()
    B = lead[0] if lead else 1
    N, TH, TW = t_tiles.shape[-3:]
    dev = t_tiles.device
    f32 = torch.float32
    for name, t, shape, dt in (
            ("t_tiles", t_tiles, (N, TH, TW), f32),
            ("n_tiles", n_tiles, (N, TH, TW), f32),
            ("loc0", loc0, (N, 2), f32), ("g_init", g_init, (N, 2), f32),
            ("o1", o1, (N, 2), torch.int32),
            ("status", status, (N,), torch.bool)):
        _lib.check("lk_level", name, t, lead + shape, dt, dev)
    if B > _TICKET_SEGMENTS:
        raise ValueError(f"lk_level: {B} segments exceed the "
                         f"{_TICKET_SEGMENTS} finish tickets of a stream")
    if win < 1 or (win > _LK_MAX_WIN and not wander < 0):
        raise ValueError(f"lk_level: the kernel takes a window past "
                         f"{_LK_MAX_WIN} x {_LK_MAX_WIN} only with a negative "
                         f"wander bound (the tracker's there), got a "
                         f"{win}x{win} window and wander {wander}")
    if TH < 2 or TW < 2 or (TH * TW) % 4:
        raise ValueError(f"lk_level: a {TH}x{TW} tile is not one bulk copy "
                         f"(at least 2 x 2, a multiple of 4 pixels)")
    if t_tiles.data_ptr() % 16 or n_tiles.data_ptr() % 16:
        raise ValueError("lk_level: the tiles must start on 16-byte "
                         "boundaries (bulk copies)")
    g = torch.empty(lead + (N, 2), dtype=f32, device=dev)
    out_status = torch.empty(lead + (N,), dtype=torch.bool, device=dev)
    err = torch.empty(lead + (N,), dtype=f32, device=dev)
    # per-feature trips and flags, for the block that finishes last
    scratch = torch.empty(lead + (N,), dtype=torch.int32, device=dev)
    fn = _lib.function(_LK_LIB, "rvio_lk_level_batch", _LK_BATCH_ARGS)
    H, W = hw
    _lib.call(_LK_LIB, fn, *map(_lib.ptr, (
        t_tiles, n_tiles, loc0, g_init, o1, status, g, out_status, err,
        scratch)), _ticket(dev), B, N, TH, TW, win, max_iters,
        ctypes.c_float(eps), ctypes.c_float(min_eig), ctypes.c_float(wander),
        int(last), H, W, device=dev)
    _lib.launched(lk_level)
    return g, out_status, err


def _ticket(dev: torch.device) -> ctypes.c_void_p:
    """Address of K8's finish tickets for the current stream on ``dev``:
    ``_TICKET_SEGMENTS`` counters, one for each segment of a call.

    The kernel counts a segment's blocks on its counter and leaves it at
    0, so launches on one stream, which run one after another, reuse them;
    launches on two streams may overlap, so each stream has its own.  The
    counters are allocated, zeroed, at the first call on a device, which
    must not be captured into a CUDA graph.  A graph keeps the counters of
    the stream it was captured on: two graphs captured on one stream must
    be replayed on one stream."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    pool = _tickets.get(dev.index)
    if pool is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("lk_level: the first call on a device must "
                               "not be captured (it allocates the tickets)")
        pool = _tickets[dev.index] = (
            torch.zeros(_TICKET_SLOTS * _TICKET_SEGMENTS, dtype=torch.int32,
                        device=dev), {})
    counters, slots = pool
    slot = slots.get(stream)
    if slot is None:
        if len(slots) == _TICKET_SLOTS:
            raise RuntimeError(f"lk_level: more than {_TICKET_SLOTS} streams")
        slot = slots[stream] = len(slots)
    return ctypes.c_void_p(counters.data_ptr()
                           + 4 * _TICKET_SEGMENTS * slot)


def template_support(loc0: torch.Tensor, win: int, TH: int, TW: int):
    """Inclusive box ``(y0, y1, x0, x1)``, each (N,) int64, of the
    template-tile pixels one LK level reads around ``loc0`` (N, 2) xy: the
    2 x 2 supports of the window's clipped taps (``_window_indices``) and
    the one-pixel halo of their Scharr gradients, within the tile.  No
    pixel outside it reaches the outputs (tests/test_torch_lk_support.py);
    K8 forms its gradients over the box without the halo."""
    r = win // 2

    def span(loc, size):
        f = torch.floor(loc).long()
        lo = torch.clamp(f - r, 0, size - 2)
        hi = torch.clamp(f - r + win - 1, 0, size - 2) + 1
        return torch.clamp(lo - 1, min=0), torch.clamp(hi + 1, max=size - 1)

    y0, y1 = span(loc0[:, 1], TH)
    x0, x1 = span(loc0[:, 0], TW)
    return y0, y1, x0, x1


lk_level.launches = 0


# --- K9: cornerSubPix refinement ---------------------------------------------

def subpix_system(tiles: torch.Tensor, origin: torch.Tensor,
                  c: torch.Tensor, win: int):
    """One cornerSubPix iteration's 2 x 2 system at corners ``c`` (N, 2):
    (gxx, gxy, gyy, bx, by), the Gaussian-weighted sums over the
    (2 win + 1)^2 window of central differences of one (2 win + 3)^2
    patch."""
    size = 2 * win + 1
    dtype = c.dtype
    off = torch.arange(-win, win + 1, dtype=dtype, device=c.device)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    wmask = torch.exp(-(ox ** 2 + oy ** 2) / (2.0 * (win / 2.0) ** 2))
    of = origin.to(dtype)
    locy = torch.clamp(c[:, 1] - of[:, 1], 0.0, float(tiles.shape[1] - 1))
    locx = torch.clamp(c[:, 0] - of[:, 0], 0.0, float(tiles.shape[2] - 1))
    p = _sample_patches(tiles, locy, locx, size + 2)
    gx = (p[:, 1:-1, 2:] - p[:, 1:-1, :-2]) * 0.5
    gy = (p[:, 2:, 1:-1] - p[:, :-2, 1:-1]) * 0.5
    gxx = torch.sum(wmask * gx * gx, dim=(1, 2))
    gxy = torch.sum(wmask * gx * gy, dim=(1, 2))
    gyy = torch.sum(wmask * gy * gy, dim=(1, 2))
    bx = torch.sum(wmask * (gx * gx * ox + gx * gy * oy), dim=(1, 2))
    by = torch.sum(wmask * (gx * gy * ox + gy * gy * oy), dim=(1, 2))
    return gxx, gxy, gyy, bx, by


def subpix_refine_plain(tiles: torch.Tensor, origin: torch.Tensor,
                        pts: torch.Tensor, *, win: int = 7,
                        iters: int = 10) -> torch.Tensor:
    """Plain version of :func:`subpix_refine`: ``corner_subpix``'s loop."""
    c = pts
    for _ in range(iters):
        gxx, gxy, gyy, bx, by = subpix_system(tiles, origin, c, win)
        det = gxx * gyy - gxy * gxy
        safe = torch.abs(det) > 1e-12
        dets = torch.where(safe, det, torch.ones_like(det))
        zero = torch.zeros((), dtype=c.dtype, device=det.device)
        dx = torch.where(safe, (gyy * bx - gxy * by) / dets, zero)
        dy = torch.where(safe, (-gxy * bx + gxx * by) / dets, zero)
        c = c + torch.clamp(torch.stack([dx, dy], dim=-1), -1.0, 1.0)
    return c


def subpix_refine(tiles: torch.Tensor, origin: torch.Tensor,
                  pts: torch.Tensor, *, win: int = 7,
                  iters: int = 10) -> torch.Tensor:
    """Batched cv::cornerSubPix on gathered tiles.

    tiles: (N, TH, TW) tiles at integer origins ``origin`` (N, 2) xy;
    pts: (N, 2) xy corners in image coordinates.  Returns the refined
    (N, 2) corners.  A CUDA tensor runs the kernel (f32 tiles and points,
    int32 origins); a CPU tensor the plain version."""
    if not _lib.uses_kernel(tiles, "subpix_refine"):
        return subpix_refine_plain(tiles, origin, pts, win=win, iters=iters)
    N, TH, TW = tiles.shape
    dev = tiles.device
    _lib.check("subpix_refine", "tiles", tiles, (N, TH, TW), torch.float32, dev)
    _lib.check("subpix_refine", "origin", origin, (N, 2), torch.int32, dev)
    _lib.check("subpix_refine", "pts", pts, (N, 2), torch.float32, dev)
    if (2 * win + 1) ** 2 > _SP_MAX_TAPS:
        raise ValueError(f"subpix_refine: a {2 * win + 1}-px window exceeds "
                         f"{_SP_MAX_TAPS} taps")
    out = torch.empty((N, 2), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    fn = _lib.function(_SP_LIB, "rvio_subpix_refine", _SP_ARGS)
    _lib.call(_SP_LIB, fn, _lib.ptr(tiles), _lib.ptr(origin), _lib.ptr(pts),
              _lib.ptr(out), N, TH, TW, win, iters, device=dev)
    _lib.launched(subpix_refine)
    return out


subpix_refine.launches = 0
