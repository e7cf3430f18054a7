"""The port's tracker with a segment axis against the JAX package.

f64 on the CPU at the small config of tests/test_replay_set.py (160x120
frames, N = 32 slots, L = 6), two sequences (seeds 5 and 9):

- ``make_batched_tracker`` at B = 2, equalizer off and on: every
  TrackerState field, UpdateBatch and debug value against ``jax.vmap`` of
  JAX's ``track_fn`` with the JAX chains' draws (1e-10; masks, lengths and
  counts exactly), and bitwise against two calls of the one-sequence
  ``track_fn`` (the same body at B = 1);
- each image kernel's plain version at B against B single calls, bitwise:
  K6, K8 (two segments whose trip counts differ: each keeps its own T),
  K9 on flattened rows, K10, K11, K13;
- ``make_batched_image_chunk_scan`` at B = 2 against JAX's over 8 frames
  (1e-8 m), and at B = 1 bitwise ``make_image_chunk_scan``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvio_tpu import config as jconfig
from rvio_tpu.dataio.synthetic import render_frame, simulate_sequence
from rvio_tpu.frontend.tracker import make_tracker as jax_make_tracker
from rvio_tpu.runtime import image_driver as jdriver
from rvio_tpu.runtime.driver import bundle_imu
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.frontend import (make_batched_tracker, make_tracker,
                                     stack_tracker_states)
from rvio_tpu_torch.runtime import (make_batched_image_chunk_scan,
                                    make_image_chunk_scan)
from rvio_tpu_torch.runtime.image_driver import (_find_init_frame,
                                                 _imu_chunk_arrays)
from rvio_tpu_torch.state import stack_states
from test_torch_replay_set import _cfg

torch.set_num_threads(1)
F64 = torch.float64
SEEDS = (5, 9)
N_FRAMES = 6
CHUNK = 8


def _u8(img):
    return np.clip(img, 0, 255).astype(np.uint8)


def _keys_draws(seed, T, N):
    """The keys and uniforms of a JAX driver's chain: ``key, sub =
    split(key)`` a frame, ``uniform(sub, (N,))``."""
    key = jax.random.key(seed)
    subs, rows = [], []
    for _ in range(T):
        key, sub = jax.random.split(key)
        subs.append(sub)
        rows.append(np.asarray(jax.random.uniform(sub, (N,))))
    return subs, np.stack(rows)


@pytest.fixture(scope="module")
def sims():
    jcfg = _cfg(jconfig)
    return [simulate_sequence(jcfg, duration=3.0, static_time=1.0,
                              ramp_time=1.0, seed=s, n_landmarks=400,
                              motion_scale=0.5) for s in SEEDS]


def _stack_jax(states):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


@pytest.fixture(scope="module", params=[False, True],
                ids=["equalizer_off", "equalizer_on"])
def tracked(request, sims):
    """Both packages' batched trackers over N_FRAMES frames of the two
    sequences from frame 12, and the port's single tracker on each."""
    jcfg, tcfg = _cfg(jconfig, request.param), _cfg(tconfig, request.param)
    N, K = jcfg.tracker.num_features, jcfg.tpu.imu_block
    j_init, j_track = jax_make_tracker(jcfg, jnp.float64)
    vtrack = jax.jit(jax.vmap(j_track))
    b_init, b_track = make_batched_tracker(tcfg, device="cpu", dtype=F64)
    s_init, s_track = make_tracker(tcfg, device="cpu", dtype=F64)
    k0 = 12
    groups = [bundle_imu(s.imu_t, s.imu_w, s.imu_a, s.frame_t) for s in sims]
    imgs0 = np.stack([_u8(render_frame(jcfg, s, k0)) for s in sims])
    js = _stack_jax([j_init(jnp.asarray(x))[0] for x in imgs0])
    bs, bn = b_init(torch.as_tensor(imgs0))
    singles = [s_init(torch.as_tensor(x)) for x in imgs0]
    assert [int(n) for _, n in singles] == bn.tolist()
    chains = [_keys_draws(b, N_FRAMES, N) for b in range(len(sims))]
    frames = []
    for i, k in enumerate(range(k0 + 1, k0 + 1 + N_FRAMES)):
        imgs = np.stack([_u8(render_frame(jcfg, s, k)) for s in sims])
        blocks = []
        for g in groups:
            w, a, dts = g[k]
            pad = K - len(w)
            blocks.append((np.pad(w, ((0, pad), (0, 0))), np.pad(dts, (0, pad)),
                           np.arange(K) < len(w)))
        wn, dn, vn = (np.stack(x) for x in zip(*blocks))
        subs = jnp.stack([c[0][i] for c in chains])
        u = np.stack([c[1][i] for c in chains])
        js, jb, jd = vtrack(js, jnp.asarray(imgs), jnp.asarray(wn),
                            jnp.asarray(dn), jnp.asarray(vn), subs)
        bs, bb, bd = b_track(bs, torch.as_tensor(imgs), torch.as_tensor(wn),
                             torch.as_tensor(dn), torch.as_tensor(vn),
                             torch.as_tensor(u))
        one = []
        for b in range(len(sims)):
            st, batch, dbg = s_track(singles[b][0], torch.as_tensor(imgs[b]),
                                     torch.as_tensor(wn[b]),
                                     torch.as_tensor(dn[b]),
                                     torch.as_tensor(vn[b]),
                                     torch.as_tensor(u[b]))
            singles[b] = (st, None)
            one.append((st, batch, dbg))
        frames.append((js, jb, jd, bs, bb, bd, one))
    return frames


FIELDS = ("pos", "hist", "length", "active", "pyramid")


@pytest.mark.parametrize("field", FIELDS)
def test_batched_tracker_matches_vmapped_jax(tracked, field):
    for f, (js, _, _, bs, _, _, _) in enumerate(tracked):
        a, b = getattr(js, field), getattr(bs, field)
        if field == "pyramid":
            for x, y in zip(a, b):
                np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0,
                                           atol=1e-10)
        elif field in ("length", "active"):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"frame {f}")
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-10, err_msg=f"frame {f}")


def test_batched_update_batches_match_vmapped_jax(tracked):
    n_valid = 0
    for f, (_, jb, jd, _, bb, bd, _) in enumerate(tracked):
        for name in ("track_len", "is_type2", "valid"):
            np.testing.assert_array_equal(
                getattr(bb, name).numpy(), np.asarray(getattr(jb, name)),
                err_msg=f"frame {f} {name}")
        np.testing.assert_allclose(bb.meas.numpy(), np.asarray(jb.meas),
                                   rtol=0, atol=1e-10)
        for name in ("n_tracked", "n_lost", "n_new"):
            np.testing.assert_array_equal(bd[name].numpy(),
                                          np.asarray(jd[name]), err_msg=name)
        # the mean abs error in gray levels (up to about 30 here): its
        # slope in the tracked position is the image gradient, so it is
        # held relatively (positions hold 1e-10 absolutely above)
        np.testing.assert_allclose(bd["klt_err"].numpy(),
                                   np.asarray(jd["klt_err"]), rtol=1e-10,
                                   atol=1e-10)
        n_valid += int(bb.valid.sum())
    assert n_valid > 0
    # each segment tracks: most of its slots survive every frame
    assert (torch.stack([d["n_tracked"] for *_x, d, _o in tracked])
            .double().mean(0) > 10).all()


def test_batched_tracker_is_single_calls(tracked):
    """Segment b of the batched body is the one-sequence track_fn on
    segment b's inputs, bitwise."""
    for _, _, _, bs, bb, bd, one in tracked:
        for b, (st, batch, dbg) in enumerate(one):
            for name in ("pos", "hist", "length", "active"):
                assert torch.equal(getattr(bs, name)[b], getattr(st, name))
            for x, y in zip(bs.pyramid, st.pyramid):
                assert torch.equal(x[b], y)
            for name in ("meas", "track_len", "is_type2", "valid"):
                assert torch.equal(getattr(bb, name)[b], getattr(batch, name))
            for k, v in dbg.items():
                assert torch.equal(bd[k][b], v), k


# ---- each image kernel's plain version at B against B single calls --------

def _frames(rng, B, H=120, W=160):
    from rvio_tpu_torch.ops.checks import _checker_frame
    return torch.stack([_checker_frame(rng, H, W, n_corners=40)
                        for _ in range(B)])


def test_gather_tiles_plain_batched():
    from rvio_tpu_torch.ops.tile_gather import gather_tiles_plain
    rng = np.random.default_rng(0)
    imgs = _frames(rng, 3)
    o = torch.as_tensor(rng.integers(-20, 170, (3, 17, 2)), dtype=torch.int32)
    got = gather_tiles_plain(imgs, o, 40, 32)
    assert got.shape == (3, 17, 40, 32)
    for b in range(3):
        assert torch.equal(got[b], gather_tiles_plain(imgs[b], o[b], 40, 32))


def test_lk_level_plain_batched_keeps_each_segments_T():
    """Two segments whose largest trip counts differ: the batched plain
    version is the two single calls bitwise (each stopped at its own T)."""
    from rvio_tpu_torch.ops.checks import _texture, lk_inputs
    from rvio_tpu_torch.ops.klt_iterate import lk_level_plain, lk_level_trips
    from rvio_tpu_torch.frontend.image import bilinear_sample
    rng = np.random.default_rng(3)
    H, W, n = 120, 160, 24
    cases = []
    for shift in ((0.4, -0.3), (3.7, 2.9)):
        base = _texture(rng, H + 40, W + 40)
        yy, xx = torch.meshgrid(torch.arange(H, dtype=F64),
                                torch.arange(W, dtype=F64), indexing="ij")
        img2 = bilinear_sample(base, torch.stack(
            [xx + 20 - shift[0], yy + 20 - shift[1]], -1))
        pts = rng.uniform([8, 8], [W - 9, H - 9], (n, 2))
        args, hw = lk_inputs(base[20:20 + H, 20:20 + W].float(),
                             img2.float(), pts, 15)
        cases.append(args)
    kw = dict(win=15, max_iters=30, eps=1e-2, min_eig=1e-3,
              wander=7.5, last=True, hw=(H, W))
    T = [int(lk_level_trips(*a, **kw)[3].max()) for a in cases]
    assert T[0] != T[1]
    stacked = tuple(torch.stack(x) for x in zip(*cases))
    got = lk_level_plain(*stacked, **kw)
    trips = lk_level_trips(*stacked, **kw)[3]
    for b, a in enumerate(cases):
        want = lk_level_plain(*a, **kw)
        for x, y in zip(got, want):
            assert torch.equal(x[b], y)
        assert int(trips[b].max()) == T[b]


def test_subpix_refine_plain_on_flattened_rows():
    from rvio_tpu_torch.frontend.klt import TILE, TILE_H, tile_origins
    from rvio_tpu_torch.ops.klt_iterate import subpix_refine_plain
    from rvio_tpu_torch.ops.tile_gather import gather_tiles_plain
    rng = np.random.default_rng(1)
    imgs = _frames(rng, 2)
    pts = torch.as_tensor(rng.uniform([6, 6], [154, 114], (2, 20, 2)),
                          dtype=torch.float32)
    o = tile_origins(pts, 120, 160)
    tiles = gather_tiles_plain(imgs, o, TILE_H, TILE)
    got = subpix_refine_plain(tiles.reshape(40, TILE_H, TILE),
                              o.reshape(40, 2), pts.reshape(40, 2))
    for b in range(2):
        want = subpix_refine_plain(tiles[b], o[b], pts[b])
        assert torch.equal(got[20 * b:20 * (b + 1)], want)


@pytest.mark.parametrize("hw", [(120, 160), (97, 131)])
def test_clahe_plain_batched(hw):
    from rvio_tpu_torch.ops.clahe import (clahe_apply_plain,
                                          clahe_hist_plain, clahe_luts_plain)
    rng = np.random.default_rng(2)
    imgs = _frames(rng, 3, *hw)
    hist = clahe_hist_plain(imgs)
    luts = clahe_luts_plain(imgs, 3.0, 5)
    out = clahe_apply_plain(imgs, luts, 5)
    assert hist.shape == (3, 25, 256) and luts.shape == (3, 25, 256)
    for b in range(3):
        assert torch.equal(hist[b], clahe_hist_plain(imgs[b]))
        assert torch.equal(luts[b], clahe_luts_plain(imgs[b], 3.0, 5))
        assert torch.equal(out[b], clahe_apply_plain(imgs[b], luts[b], 5))


def test_shi_tomasi_nms_plain_batched():
    from rvio_tpu_torch.ops.shi_tomasi import shi_tomasi_nms_plain
    rng = np.random.default_rng(4)
    imgs = _frames(rng, 3)
    got = shi_tomasi_nms_plain(imgs)
    for b in range(3):
        assert torch.equal(got[b], shi_tomasi_nms_plain(imgs[b]))


# ---- the batched image chunk scan -------------------------------------------

@pytest.fixture(scope="module")
def chunk_case(sims):
    jcfg, tcfg = _cfg(jconfig, True), _cfg(tconfig, True)
    K, N = tcfg.tpu.imu_block, tcfg.tracker.num_features
    t_init, _ = make_tracker(tcfg, device="cpu", dtype=F64)
    j_init, _ = jax_make_tracker(jcfg, jnp.float64)
    per = []
    for sim in sims:
        groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
        fs, k0 = _find_init_frame(tcfg, groups, len(sim.frame_t), F64, "cpu")
        jfs, jk0 = jdriver._find_init_frame(jcfg, groups, len(sim.frame_t),
                                            jnp.float64)
        assert jk0 == k0
        ks = list(range(k0 + 1, k0 + 1 + CHUNK))
        ch = {k: v.numpy() for k, v in _imu_chunk_arrays(
            groups, ks, K, F64, "cpu").items()}
        ch["image"] = np.stack([_u8(render_frame(jcfg, sim, k)) for k in ks])
        img0 = _u8(render_frame(jcfg, sim, k0))
        per.append(dict(chunk=ch, ts=t_init(torch.as_tensor(img0))[0], fs=fs,
                        jts=j_init(jnp.asarray(img0))[0], jfs=jfs))
    _, u = _keys_draws(0, CHUNK, N)
    chunk = {k: np.stack([p["chunk"][k] for p in per]) for k in per[0]["chunk"]}
    chunk["u"] = np.stack([u] * len(sims))
    carry = (stack_tracker_states([p["ts"] for p in per]),
             stack_states([p["fs"] for p in per]))
    scan = make_batched_image_chunk_scan(tcfg, "cpu", F64)
    got = scan(carry, {k: torch.as_tensor(np.ascontiguousarray(v))
                       for k, v in chunk.items()})
    return dict(jcfg=jcfg, tcfg=tcfg, per=per, chunk=chunk, got=got)


def test_batched_chunk_scan_matches_jax(chunk_case):
    c = chunk_case
    B = len(c["per"])
    jcarry = (_stack_jax([p["jts"] for p in c["per"]]),
              _stack_jax([p["jfs"] for p in c["per"]]),
              jnp.stack([jax.random.key(0)] * B))
    jchunk = {k: jnp.asarray(v) for k, v in c["chunk"].items() if k != "u"}
    (jts, jfs, _), ref = jdriver.make_batched_image_chunk_scan(
        c["jcfg"], jnp.float64)(jcarry, jchunk)
    (ts, fs), got = c["got"]
    assert got["p_Gk"].shape == (B, CHUNK, 3)
    for k in ("n_good", "ok", "n_tracked", "n_lost", "n_new", "n_usable",
              "tl_good_sum"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert got["n_tracked"].sum() > 0 and bool(got["ok"].all())
    for k in ("p_Gk", "v_k"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-8, err_msg=k)
    np.testing.assert_allclose(got["q_kG"].numpy(), np.asarray(ref["q_kG"]),
                               rtol=0, atol=1e-8)
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(jts.active))
    np.testing.assert_allclose(fs.P.numpy(), np.asarray(jfs.P), rtol=0,
                               atol=1e-8)


def test_batched_chunk_scan_at_one_is_the_chunk_scan(chunk_case):
    c = chunk_case
    p = c["per"][1]
    ch = {k: torch.as_tensor(np.ascontiguousarray(v[1]))
          for k, v in c["chunk"].items()}
    (ts, fs), want = make_image_chunk_scan(c["tcfg"], "cpu", F64)(
        (p["ts"], p["fs"]), ch)
    carry = (stack_tracker_states([p["ts"]]), stack_states([p["fs"]]))
    (bts, bfs), got = make_batched_image_chunk_scan(c["tcfg"], "cpu", F64)(
        carry, {k: v[None] for k, v in ch.items()})
    for k, v in want.items():
        assert torch.equal(got[k][0], v), k
    assert torch.equal(bts.pos[0], ts.pos) and torch.equal(bfs.P[0], fs.P)
    # and segment 1 of the B = 2 scan
    for k in ("p_Gk", "q_kG", "n_good", "active"):
        assert torch.equal(c["got"][1][k][1], want[k]), k


def test_batched_builders_default_to_cuda():
    """The new builders mean CUDA by default and raise without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from rvio_tpu_torch.runtime import run_sequence_set
    cfg = _cfg(tconfig)
    for call in (lambda: make_batched_tracker(cfg),
                 lambda: make_batched_image_chunk_scan(cfg),
                 lambda: run_sequence_set(cfg, [None])):
        with pytest.raises(RuntimeError):
            call()
