"""The port's mesh layer in two real processes (gloo on the CPU, f64),
through scripts/torch_multiprocess_check.py, against the JAX package's
sharded functions on its virtual 8-device CPU mesh (tests/conftest.py) in
this process.  The children import no jax: this process writes their
inputs (JAX's) to .npz files, and one launch of the script runs every
workload in the same two processes:

- ``make_parallel_sequence`` over S = 4 segments of tests/test_parallel.py's
  small config (its sharded-step case: 8 s, seeds 0-3), seg = 2 / feat = 1
  and seg = 1 / feat = 2, each against JAX's
  ``make_parallel_sequence(cfg, make_mesh(8, seg=4, feat=2))`` at 1e-8 m;
  the two feat ranks' final states bitwise equal, both ranks' gathered
  outputs bitwise equal;
- the feat-split tracker (``make_tracker(mesh=)``, seg = 1 / feat = 2, at
  tests/test_torch_tracker.py's 320x240 config over 8 tracked frames)
  against JAX's ``make_tracker(cfg, mesh=make_mesh(8, seg=4, feat=2))`` at
  1e-10 (masks, lengths and slots exactly), and JAX's unsharded tracker;
- the feat-split KLT in ``make_image_chunk_scan(mesh=)`` over the same
  frames against the port's unsharded chunk scan;
- ``run_segments_warm(mesh=)`` with seg = 2 against the port's
  ``mesh=None`` run at 1e-10 m, the same repaired segments.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_bundles
from rvio_tpu import config as jconfig
from rvio_tpu.dataio.synthetic import render_frame, simulate_sequence
from rvio_tpu.frontend.tracker import make_tracker as jax_make_tracker
from rvio_tpu.parallel import make_mesh as jax_make_mesh
from rvio_tpu.parallel.segment import (make_parallel_sequence as
                                       jax_parallel_sequence,
                                       shard_bundles as jax_shard_bundles,
                                       shard_states as jax_shard_states,
                                       stack_states as jax_stack_states)
from rvio_tpu.runtime.driver import bundle_imu
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.frontend import make_tracker
from rvio_tpu_torch.parallel import run_segments_warm
from rvio_tpu_torch.runtime import make_image_chunk_scan
from rvio_tpu_torch.runtime.image_driver import (_find_init_frame,
                                                 _imu_chunk_host)
from rvio_tpu_torch.state import state_from_numpy
from test_torch_batched import jax_state_np, port_bundles, small_cfg
from test_torch_tracker import _cfg as image_cfg
from test_torch_tracker import jax_draws

torch.set_num_threads(1)
F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_multiprocess_check.py")
RUNS = ("sequence:2x1", "sequence:1x2", "tracker:1x2", "chunk:1x2",
        "warm:2x1")
N_TRACK = 8          # tracked frames of the tracker and chunk workloads
WARM = dict(duration=20.0, seed=5, segments=4, warmup=30)


def _fields(prefix, obj):
    return {f"{prefix}{k}": np.asarray(v) for k, v in vars(obj).items()}


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jax_make_mesh(8, seg=4, feat=2)


@pytest.fixture(scope="module")
def sequence_inputs():
    """tests/test_parallel.py's sharded-step case: JAX's stacked init
    states and bundles of four 8 s sequences, cut to a common T."""
    cfg = small_cfg(jconfig)
    built = [build_bundles(cfg, simulate_sequence(
        cfg, duration=8.0, static_time=1.0, seed=s, meas_noise=5e-4,
        imu_noise=False), jnp.float64) for s in range(4)]
    T = min(b[1].imu.w.shape[0] for b in built)
    states = jax_stack_states([b[0] for b in built])
    bundles = jax.tree.map(lambda *xs: jnp.stack([x[:T] for x in xs]),
                           *[b[1] for b in built])
    return cfg, states, bundles


@pytest.fixture(scope="module")
def frames():
    """tests/test_torch_tracker.py's rendered frames (CLAHE off): the init
    frame k0 of the port's init gate, then N_TRACK frames, their padded
    IMU blocks and the JAX chain's draws."""
    jcfg, tcfg = image_cfg(jconfig), image_cfg(tconfig)
    sim = simulate_sequence(jcfg, duration=4.0, static_time=1.0, seed=5,
                            n_landmarks=300, motion_scale=0.6)
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    st0, k0 = _find_init_frame(tcfg, groups, len(sim.frame_t), F64, "cpu")
    ks = range(k0 + 1, k0 + 1 + N_TRACK)
    imu = _imu_chunk_host(groups, ks, jcfg.tpu.imu_block)
    images = np.stack([np.clip(render_frame(jcfg, sim, k), 0, 255)
                       .astype(np.uint8) for k in range(k0, ks[-1] + 1)])
    draws = jax_draws(0, N_TRACK, jcfg.tracker.num_features)
    return jcfg, tcfg, st0, images, imu, draws


@pytest.fixture(scope="module")
def warm_inputs():
    cfg = small_cfg(jconfig)
    sim = simulate_sequence(cfg, duration=WARM["duration"], static_time=1.0,
                            seed=WARM["seed"], meas_noise=5e-4,
                            imu_noise=True)
    state0, bundles, _ = build_bundles(cfg, sim, jnp.float64)
    return state0, bundles


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, sequence_inputs, frames, warm_inputs):
    """One launch of the script with every run: each rank's arrays by run
    name, and the parent's JSON line."""
    inputs = tmp_path_factory.mktemp("mp_in")
    out = tmp_path_factory.mktemp("mp_out")
    common = {"dtype": "float64"}
    _, states, bundles = sequence_inputs
    np.savez(inputs / "sequence.npz", config="small", **common,
             **_fields("state.", states), **_fields("imu.", bundles.imu),
             **_fields("batch.", bundles.batch))
    _, _, st0, images, imu, draws = frames
    np.savez(inputs / "tracker.npz", config="image-small", **common,
             images=images, imu_w=imu["imu_w"], imu_dt=imu["imu_dt"],
             imu_valid=imu["imu_valid"], u=draws)
    np.savez(inputs / "chunk.npz", config="image-small", **common,
             image0=images[0], **_fields("state.", st0),
             **{f"chunk.{k}": v for k, v in _chunk(images, imu,
                                                   draws).items()})
    state0, wb = warm_inputs
    np.savez(inputs / "warm.npz", config="small", **common,
             segments=WARM["segments"], warmup=WARM["warmup"],
             **_fields("state.", state0), **_fields("imu.", wb.imu),
             **_fields("batch.", wb.batch))
    cmd = [sys.executable, SCRIPT, "--device", "cpu", "--backend", "gloo",
           "--inputs", str(inputs), "--out", str(out), "--timeout", "500"]
    for r in RUNS:
        cmd += ["--run", r]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    got = {}
    for run in RUNS:
        w, layout = run.split(":")
        name = f"{w}-{layout}"
        got[name] = [dict(np.load(out / f"{name}.rank{i}.npz"))
                     for i in range(2)]
    return got, line


def _chunk(images, imu, draws):
    return {"image": images[1:], "u": draws, **imu}


def test_script_line(ranks):
    _, line = ranks
    assert line["ok"] and line["processes"] == 2 and line["rcs"] == [0, 0]
    assert line["backend"] == "gloo" and line["device"] == "cpu"
    assert set(line["runs"]) == {r.replace(":", "-") for r in RUNS}


def _script_parser():
    import importlib.util
    spec = importlib.util.spec_from_file_location("torch_mp_check", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.parser()


def test_script_runs_on_the_card_unless_asked():
    """The script's ranks run on the card by default, and the backend has
    no default: the caller names it."""
    ap = _script_parser()
    base = ["--inputs", "i", "--out", "o", "--run", "sequence:1x2"]
    assert ap.parse_args(base + ["--backend", "nccl"]).device == "cuda"
    with pytest.raises(SystemExit):
        ap.parse_args(base)


@pytest.fixture(scope="module")
def jax_sequence(sequence_inputs, jax_mesh):
    cfg, states, bundles = sequence_inputs
    prun = jax_parallel_sequence(cfg, jax_mesh)
    _, out = prun(jax_shard_states(states, jax_mesh),
                  jax_shard_bundles(bundles, jax_mesh, time_axis=True))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("layout", ["2x1", "1x2"])
def test_parallel_sequence_matches_jax(ranks, jax_sequence, layout):
    got, _ = ranks
    r0, r1 = got[f"sequence-{layout}"]
    for k in ("p_Gk", "q_kG", "v_k", "n_good"):
        assert r0[f"out.{k}"].shape == jax_sequence[k].shape, k
        # both ranks hold the gathered global outputs, bitwise
        np.testing.assert_array_equal(r0[f"out.{k}"], r1[f"out.{k}"])
    np.testing.assert_allclose(r0["out.p_Gk"], jax_sequence["p_Gk"], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(r0["out.q_kG"], jax_sequence["q_kG"], rtol=0,
                               atol=1e-8)
    np.testing.assert_array_equal(r0["out.n_good"], jax_sequence["n_good"])
    assert jax_sequence["n_good"].mean() > 3


def test_feat_ranks_states_bitwise_equal(ranks):
    got, _ = ranks
    r0, r1 = got["sequence-1x2"]
    keys = [k for k in r0 if k.startswith("state.")]
    assert len(keys) == 14
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    # the seg ranks hold different segments
    s0, s1 = got["sequence-2x1"]
    assert not np.array_equal(s0["state.p_G"], s1["state.p_G"])


def test_one_collective_a_frame(ranks, sequence_inputs):
    """The warm rerun of each scan: feat = 2 makes one ``all_reduce`` a
    frame (the update's sums; the KLT's slots in the chunk scan), seg = 2
    none."""
    got, _ = ranks
    T = sequence_inputs[2].imu.w.shape[1]
    for name, calls in (("sequence-1x2", T), ("sequence-2x1", 0),
                        ("chunk-1x2", N_TRACK)):
        assert [int(r["allreduce_calls"]) for r in got[name]] == [calls] * 2
    cfg, states, _ = sequence_inputs
    M = states.clones.shape[1]
    # 4 segments: C (6M x 6M), b (6M) and the counts (the adaptive noise's
    # two sums besides n_good, n_usable, tl_good_sum) of each, f64
    n_sums = 3 + 2 * int(cfg.tpu.adaptive_noise)
    assert int(got["sequence-1x2"][0]["allreduce_bytes"]) == \
        8 * 4 * (36 * M * M + 6 * M + n_sums)


@pytest.fixture(scope="module")
def jax_tracks(frames, jax_mesh):
    """JAX's sharded and unsharded trackers over the frames: per frame
    (state, batch, debug) of each."""
    jcfg, _, _, images, imu, draws = frames
    out = {}
    for name, mesh in (("sharded", jax_mesh), ("unsharded", None)):
        init, track = jax_make_tracker(jcfg, jnp.float64, mesh=mesh)
        ts, _ = init(jnp.asarray(images[0], jnp.float64))
        key = jax.random.key(0)
        rows = []
        for i in range(N_TRACK):
            key, sub = jax.random.split(key)
            ts, batch, dbg = track(ts, jnp.asarray(images[i + 1]),
                                   jnp.asarray(imu["imu_w"][i]),
                                   jnp.asarray(imu["imu_dt"][i]),
                                   jnp.asarray(imu["imu_valid"][i]), sub)
            rows.append({"pos": ts.pos, "hist": ts.hist,
                         "length": ts.length, "active": ts.active,
                         "meas": batch.meas, "track_len": batch.track_len,
                         "is_type2": batch.is_type2, "valid": batch.valid,
                         "n_tracked": dbg["n_tracked"],
                         "klt_err": dbg["klt_err"]})
        out[name] = {k: np.stack([np.asarray(r[k]) for r in rows])
                     for k in rows[0]}
    return out


@pytest.mark.parametrize("reference", ["sharded", "unsharded"])
def test_split_tracker_matches_jax(ranks, jax_tracks, reference):
    got, _ = ranks
    r0, r1 = got["tracker-1x2"]
    ref = jax_tracks[reference]
    for k in ref:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        if k in ("length", "active", "track_len", "is_type2", "valid",
                 "n_tracked"):
            np.testing.assert_array_equal(r0[k], ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(r0[k], ref[k], rtol=0, atol=1e-10,
                                       err_msg=k)
    assert ref["n_tracked"].mean() > 10 and ref["valid"].any()


def test_split_chunk_scan_matches_unsharded(ranks, frames):
    _, tcfg, st0, images, imu, draws = frames
    init_fn, _ = make_tracker(tcfg, "cpu", F64)
    ts0, _ = init_fn(torch.as_tensor(images[0]))
    chunk = {k: torch.as_tensor(v) for k, v in _chunk(images, imu,
                                                      draws).items()}
    chunk = {k: v.to(F64) if v.is_floating_point() else v
             for k, v in chunk.items()}
    (ts, _), out = make_image_chunk_scan(tcfg, "cpu", F64)((ts0, st0), chunk)
    got, _ = ranks
    r0, r1 = got["chunk-1x2"]
    for k, v in out.items():
        np.testing.assert_array_equal(r0[f"out.{k}"], r1[f"out.{k}"])
        np.testing.assert_allclose(r0[f"out.{k}"], v.numpy(), rtol=0,
                                   atol=1e-10, err_msg=k)
    for k in ("pos", "hist", "length", "active"):
        np.testing.assert_allclose(r0[f"ts.{k}"], getattr(ts, k).numpy(),
                                   rtol=0, atol=1e-10, err_msg=k)
    assert out["ok"].any() and out["n_tracked"].float().mean() > 10


def test_warm_split_mesh_matches_single(ranks, warm_inputs):
    state0, bundles = warm_inputs
    stitched, outs, info = run_segments_warm(
        small_cfg(tconfig), state_from_numpy(jax_state_np(state0), "cpu",
                                             F64),
        port_bundles(bundles), WARM["segments"], WARM["warmup"],
        device="cpu")
    got, _ = ranks
    r0, r1 = got["warm-2x1"]
    for r in (r0, r1):
        np.testing.assert_allclose(r["stitched"], stitched, rtol=0,
                                   atol=1e-10)
        assert list(r["repaired"]) == info["repaired_segments"]
        for k in ("p_Gk", "n_good", "ok"):
            np.testing.assert_allclose(r[f"out.{k}"], outs[k].numpy(),
                                       rtol=0, atol=1e-10, err_msg=k)
    assert outs["n_good"].float().mean() > 3
