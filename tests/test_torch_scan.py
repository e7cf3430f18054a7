"""The port's one-dispatch frame loops against the JAX package, f64 on the
CPU, where each runs its body eagerly (on a CUDA device the same body is
replayed as a captured graph: tests/test_torch_cuda.py).

- the sequence scan (``make_sequence_scan``) against JAX's on the feature
  config of tests/test_torch_e2e.py: positions and attitudes to 1e-8,
  n_good exactly;
- the fused chunk scan (``make_image_chunk_scan``) against JAX's on an
  8-frame chunk at the small image config of tests/test_torch_tracker.py,
  equalizer off and on, JAX's draws passed in as ``u``: poses to 1e-10
  (test_torch_replay.py's tolerance), counters exactly, the carries too;
- the front-end then back-end chunk scans equal the fused scan bitwise;
- the chunk scan equals the per-frame ``ImagePipeline`` to 1e-12 m;
- an ``ok`` False frame leaves both carries bitwise unchanged;
- the sequence scan equals the eager per-frame step bitwise, a second run
  of a scan equals its first, and a longer run reallocates its buffers;
- utils/profiling.py's spans, counts and Chrome trace, and the batched
  sequence scan's spans.
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
from rvio_tpu.runtime.driver import InitializationGate as JaxGate
from rvio_tpu.runtime.driver import bundle_imu
from rvio_tpu.runtime.step import FrameBundle as JaxBundle
from rvio_tpu.runtime.step import make_sequence_scan as jax_sequence_scan
from rvio_tpu.filter.propagation import ImuBlock as JaxImu
from rvio_tpu.filter.update import UpdateBatch as JaxBatch
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.filter.propagation import pad_imu
from rvio_tpu_torch.frontend import make_tracker
from rvio_tpu_torch.runtime import (ImagePipeline, InitializationGate,
                                    SequenceDriver, make_backend_chunk_scan,
                                    make_batched_sequence_scan,
                                    make_filter_step,
                                    make_frontend_chunk_scan,
                                    make_image_chunk_scan,
                                    make_sequence_scan)
from rvio_tpu_torch.runtime.graph import tree_leaves
from rvio_tpu_torch.runtime.image_driver import (_find_init_frame,
                                                 _imu_chunk_arrays)
from rvio_tpu_torch.state import stack_states
from rvio_tpu_torch.utils import profiling
from rvio_tpu_torch.utils.profiling import device_trace, span
from test_torch_tracker import _cfg as _image_cfg
from test_torch_tracker import jax_draws

torch.set_num_threads(1)
F64 = torch.float64
CHUNK = 8


def _feature_cfg(mod, compression):
    return mod.RVIOConfig(
        imu=mod.ImuConfig(rate_hz=100.0), camera=mod.CameraConfig(fps=10.0),
        tracker=mod.TrackerConfig(num_features=16, max_tracking_length=8),
        tpu=mod.TpuConfig(imu_block=16, compression=compression))


def _feature_inputs(cfg, sim):
    """The sequence's filtered frames as stacked host arrays (the rows
    SequenceDriver stacks) and the frame the gates fire at."""
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    jgate, tgate = JaxGate(cfg[0], jnp.float64), InitializationGate(
        cfg[1], F64, "cpu")
    jstate = tstate = None
    rows = []
    for k, (w, a, dts) in enumerate(groups):
        if len(w) < 2:
            continue
        if tstate is None:
            jstate, tstate = jgate.feed(w, a, dts), tgate.feed(w, a, dts)
            assert (jstate is None) == (tstate is None)
            continue
        rows.append(pad_imu(w, a, dts, cfg[1].tpu.imu_block)
                    + (sim.feat_meas[k], sim.feat_len[k], sim.feat_type2[k],
                       sim.feat_valid[k]))
    return jstate, tstate, [np.stack(x) for x in zip(*rows)]


def _port_bundles(arrays):
    from rvio_tpu_torch.filter.propagation import ImuBlock
    from rvio_tpu_torch.filter.update import UpdateBatch
    from rvio_tpu_torch.runtime.step import FrameBundle
    w, a, dt, valid, meas, tlen, typ2, ok = (torch.as_tensor(x)
                                             for x in arrays)
    return FrameBundle(imu=ImuBlock(w=w, a=a, dt=dt, valid=valid),
                       batch=UpdateBatch(meas=meas, track_len=tlen,
                                         is_type2=typ2, valid=ok))


@pytest.fixture(scope="module")
def feature_sim():
    return simulate_sequence(_feature_cfg(jconfig, "qr"), duration=6.0,
                             static_time=1.2, seed=11, meas_noise=0.0015,
                             imu_noise=True)


@pytest.mark.parametrize("compression", ["qr", "cholesky"])
def test_sequence_scan_matches_jax(feature_sim, compression):
    cfg = (_feature_cfg(jconfig, compression),
           _feature_cfg(tconfig, compression))
    jstate, tstate, arrays = _feature_inputs(cfg, feature_sim)
    w, a, dt, valid, meas, tlen, typ2, ok = arrays
    jb = JaxBundle(imu=JaxImu(w=jnp.asarray(w), a=jnp.asarray(a),
                              dt=jnp.asarray(dt), valid=jnp.asarray(valid)),
                   batch=JaxBatch(meas=jnp.asarray(meas),
                                  track_len=jnp.asarray(tlen, jnp.int32),
                                  is_type2=jnp.asarray(typ2),
                                  valid=jnp.asarray(ok)))
    _, ref = jax_sequence_scan(cfg[0])(jstate, jb)
    _, got = make_sequence_scan(cfg[1], "cpu", F64)(tstate,
                                                    _port_bundles(arrays))
    assert got["p_Gk"].shape == (len(w), 3) and len(w) > 30
    np.testing.assert_array_equal(got["n_good"].numpy(),
                                  np.asarray(ref["n_good"]))
    assert got["n_good"][10:].double().mean() > 3
    for k in ("p_Gk", "q_kG", "v_k"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-8, err_msg=k)


def test_sequence_scan_is_the_eager_step(feature_sim):
    """The scan's packed rows round-trip exactly: its outputs and final
    state are the eager per-frame step's, bitwise; a second run of the
    same scan gives the first run's results, and a longer run (which
    reallocates the scan's buffers) the longer eager run's."""
    cfg = (_feature_cfg(jconfig, "cholesky"),
           _feature_cfg(tconfig, "cholesky"))
    _, state0, arrays = _feature_inputs(cfg, feature_sim)
    bundles = _port_bundles(arrays)
    step = make_filter_step(cfg[1], "cpu", F64)
    state, rows = state0, []
    for t in range(len(arrays[0])):
        state, out = step(state, bundles.frame(t))
        rows.append(out)
    eager = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    run = make_sequence_scan(cfg[1], "cpu", F64)
    half = _port_bundles([x[:20] for x in arrays])
    _, first = run(state0, half)
    final, got = run(state0, bundles)
    _, again = run(state0, bundles)
    assert set(got) == set(eager)
    for k, v in eager.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k
        assert torch.equal(again[k], v), k
        assert torch.equal(first[k], v[:20]), k
    for x, y in zip(tree_leaves(final), tree_leaves(state), strict=True):
        assert torch.equal(x, y)


def test_sequence_driver_runs_the_scan(feature_sim):
    """SequenceDriver's frames go through make_sequence_scan."""
    cfg = _feature_cfg(tconfig, "cholesky")
    drv = SequenceDriver(cfg, dtype=F64, device="cpu")
    calls = []
    scan = drv.run_sequence

    def counted(state, bundles):
        calls.append(bundles.imu.w.shape[0])
        return scan(state, bundles)

    drv.run_sequence = counted
    sim = feature_sim
    from rvio_tpu_torch.runtime import batches_from_sim
    res = drv.run(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t,
                  batches_from_sim(sim))
    assert calls == [len(res.timestamps)]
    assert scan.frame_scan.carry is not None


# ---- the image chunk scans ------------------------------------------------

def _chunk_setup(equalizer):
    """Both packages' configs, the sequence, its init frame k0, each
    package's init states and the first CHUNK frames after k0 as a chunk
    (host arrays)."""
    jcfg, tcfg = _image_cfg(jconfig, equalizer), _image_cfg(tconfig, equalizer)
    sim = simulate_sequence(jcfg, duration=4.0, static_time=1.0, seed=5,
                            n_landmarks=300, motion_scale=0.6)
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    fs, k0 = _find_init_frame(tcfg, groups, len(sim.frame_t), F64, "cpu")
    ks = list(range(k0 + 1, k0 + 1 + CHUNK))
    ch = {k: v.numpy() for k, v in _imu_chunk_arrays(
        groups, ks, tcfg.tpu.imu_block, F64, "cpu").items()}
    ch["image"] = np.stack([np.clip(render_frame(jcfg, sim, k), 0, 255)
                            .astype(np.uint8) for k in ks])
    init_img = np.clip(render_frame(jcfg, sim, k0), 0, 255).astype(np.uint8)
    init_fn, _ = make_tracker(tcfg, device="cpu", dtype=F64)
    ts, _ = init_fn(torch.as_tensor(init_img))
    return dict(jcfg=jcfg, tcfg=tcfg, sim=sim, groups=groups, k0=k0, ks=ks,
                chunk=ch, init_img=init_img, ts=ts, fs=fs,
                u=jax_draws(0, CHUNK, tcfg.tracker.num_features))


@pytest.fixture(scope="module", params=[False, True],
                ids=["equalizer_off", "equalizer_on"])
def chunk_case(request):
    return _chunk_setup(request.param)


def _port_chunk(case, ok=None):
    ch = {k: torch.as_tensor(v) for k, v in case["chunk"].items()}
    ch["u"] = torch.as_tensor(case["u"])
    if ok is not None:
        ch["ok"] = torch.as_tensor(ok)
    return ch


@pytest.fixture(scope="module")
def fused_run(chunk_case):
    scan = make_image_chunk_scan(chunk_case["tcfg"], "cpu", F64)
    return scan((chunk_case["ts"], chunk_case["fs"]), _port_chunk(chunk_case))


def test_image_chunk_scan_matches_jax(chunk_case, fused_run):
    c = chunk_case
    jcfg = c["jcfg"]
    j_init, _ = jax_make_tracker(jcfg, jnp.float64)
    jts, _ = j_init(jnp.asarray(c["init_img"]))
    jfs, k0 = jdriver._find_init_frame(jcfg, c["groups"],
                                       len(c["sim"].frame_t), jnp.float64)
    assert k0 == c["k0"]
    jchunk = {k: jnp.asarray(v) for k, v in c["chunk"].items()}
    (jts, jfs, _), ref = jdriver.make_image_chunk_scan(jcfg, jnp.float64)(
        (jts, jfs, jax.random.key(0)), jchunk)
    (ts, fs), got = fused_run
    for k in ("n_good", "ok", "n_tracked", "n_lost", "n_new", "n_usable",
              "tl_good_sum"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert got["n_tracked"].sum() > 0 and bool(got["ok"].all())
    for k in ("p_Gk", "q_kG", "v_k"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-10, err_msg=k)
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(jts.active))
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(jts.pos), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(fs.P.numpy(), np.asarray(jfs.P), rtol=0,
                               atol=1e-10)


def test_front_then_back_is_the_fused_scan(chunk_case, fused_run):
    c = chunk_case
    ch = _port_chunk(c)
    ts, fo = make_frontend_chunk_scan(c["tcfg"], "cpu", F64)(c["ts"], ch)
    back_chunk = {k: ch[k] for k in ("imu_w", "imu_a", "imu_dt", "imu_valid",
                                     "ok")}
    back_chunk.update({k: fo[k] for k in ("meas", "track_len", "is_type2",
                                          "valid")})
    fs, bo = make_backend_chunk_scan(c["tcfg"], "cpu", F64)(c["fs"],
                                                           back_chunk)
    (fts, ffs), fused = fused_run
    for k, v in bo.items():
        assert torch.equal(v, fused[k]), k
    for k in ("n_tracked", "n_lost", "n_new", "active"):
        assert torch.equal(fo[k], fused[k]), k
    for x, y in zip(tree_leaves((ts, fs)), tree_leaves((fts, ffs)),
                    strict=True):
        assert torch.equal(x, y)


def _pipeline_outputs(c, last):
    """ImagePipeline fed the sequence's frames 0..last with the chunk's
    draws; the outputs of its tracked frames."""
    pipe = ImagePipeline(c["tcfg"], F64, device="cpu", uniforms=c["u"])
    H, W = c["tcfg"].camera.height, c["tcfg"].camera.width
    outs = []
    for k in range(last + 1):
        img = (c["init_img"] if k == c["k0"] else
               c["chunk"]["image"][k - c["ks"][0]] if k in c["ks"] else
               np.zeros((H, W), np.uint8))       # before the gate: unused
        out = pipe.process(c["sim"].frame_t[k], img, *c["groups"][k])
        if out is not None:
            outs.append(out)
    return outs


def test_chunk_scan_is_the_pipeline(chunk_case, fused_run):
    """The per-frame ImagePipeline over the same frames and draws gives the
    chunk scan's poses (the same body, one frame a call)."""
    outs = _pipeline_outputs(chunk_case, chunk_case["ks"][-1])
    assert len(outs) == CHUNK
    _, fused = fused_run
    for k in ("p_Gk", "q_kG", "v_k"):
        got = torch.stack([o[k] for o in outs])
        np.testing.assert_allclose(got.numpy(), fused[k].numpy(), rtol=0,
                                   atol=1e-12, err_msg=k)
    for k in ("n_good", "n_usable", "tl_good_sum"):
        assert torch.equal(torch.stack([o[k] for o in outs]), fused[k]), k


def test_pipeline_outputs_are_not_aliased(chunk_case):
    """process() returns copies: later frames leave them alone."""
    outs = _pipeline_outputs(chunk_case, chunk_case["ks"][2])
    kept = [{k: v.clone() for k, v in o.items()} for o in outs]
    assert len(outs) == 3
    outs += _pipeline_outputs(chunk_case, chunk_case["ks"][2])
    for out, copy in zip(outs, kept):
        for k, v in copy.items():
            assert torch.equal(out[k], v), k
    assert not torch.equal(outs[0]["p_Gk"], outs[1]["p_Gk"])


def test_not_ok_frame_keeps_the_carries(chunk_case):
    """A frame with ``ok`` False leaves the tracker and filter states
    bitwise as they were: alone, and after a frame that is ok."""
    c = chunk_case
    scan = make_image_chunk_scan(c["tcfg"], "cpu", F64)
    carry = (c["ts"], c["fs"])
    one = {k: v[:1] for k, v in _port_chunk(c, ok=[False] * CHUNK).items()}
    kept, out = scan(carry, one)
    assert not bool(out["ok"][0])
    for x, y in zip(tree_leaves(kept), tree_leaves(carry), strict=True):
        assert torch.equal(x, y)
    ok = [True, False] + [True] * (CHUNK - 2)
    two = {k: v[:2] for k, v in _port_chunk(c, ok=ok).items()}
    after_two, _ = scan(carry, two)
    after_one, _ = scan(carry, {k: v[:1] for k, v in two.items()})
    for x, y in zip(tree_leaves(after_two), tree_leaves(after_one),
                    strict=True):
        assert torch.equal(x, y)


def test_profiling_on_the_cpu(tmp_path):
    """utils/profiling.py on the CPU: with no profiler running a span adds
    its host time and one to the totals and records no profiler event;
    counts add up and ``reset`` clears them; ``device_trace`` writes a
    Chrome trace that holds a span with its arguments, and ``run.py
    --profile`` writes one."""
    import json

    from rvio_tpu_torch.run import main
    profiling.reset()
    for _ in range(3):
        with span("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    profiling.add("frames", 5)
    profiling.add("frames")
    path = tmp_path / "trace.json"
    with device_trace(str(path)) as prof:
        with span("chunk", pass_no=2, chunk=8):
            torch.ones(8) + 1
    got = profiling.totals()
    assert got["matmul"]["n"] == 3 and got["matmul"]["s"] > 0
    assert got["frames"] == {"s": 0.0, "n": 6} and got["chunk"]["n"] == 1
    names = {e.name for e in prof.events()}
    assert "chunk" in names and "matmul" not in names
    events = json.loads(path.read_text())["traceEvents"]
    chunk = [e for e in events if e.get("name") == "chunk"]
    assert len(chunk) == 1
    assert (chunk[0]["args"]["pass_no"], chunk[0]["args"]["chunk"]) == (2, 8)
    profiling.reset()
    assert profiling.totals() == {} and profiling.count("frames") == 0
    cli = tmp_path / "cli.json"
    assert main(["--sweep", "0", "--device", "cpu", "--output",
                 str(tmp_path / "out"), "--profile", str(cli)]) == 0
    assert json.loads(cli.read_text())["traceEvents"]


def test_spans_nest_under_the_profiler():
    """Under torch.profiler a span is a profiler range of its name, and a
    span opened inside another is recorded inside it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with span("inner"):
                torch.ones(4) + 1
    ev = {e.name: e for e in prof.events()}
    assert ev["inner"].cpu_parent.name == "outer"
    assert ev["outer"].time_range.start <= ev["inner"].time_range.start
    assert ev["inner"].time_range.end <= ev["outer"].time_range.end


def test_batched_sequence_scan_fills_its_spans(feature_sim):
    """A batched sequence scan on the CPU fills ``sequence_scan.pack`` and
    ``.split`` once a call and counts B·T poses; no graph, so no
    ``frame_scan.*`` span."""
    cfg = (_feature_cfg(jconfig, "cholesky"),
           _feature_cfg(tconfig, "cholesky"))
    _, state0, arrays = _feature_inputs(cfg, feature_sim)
    bundles = _port_bundles([np.stack([x[:4]] * 2) for x in arrays])
    run = make_batched_sequence_scan(cfg[1], "cpu", F64)
    profiling.reset()
    _, out = run(stack_states([state0, state0]), bundles)
    got = profiling.totals()
    assert out["p_Gk"].shape == (2, 4, 3)
    assert {k: v["n"] for k, v in got.items()} == {
        "sequence_scan.pack": 1, "sequence_scan.split": 1,
        "sequence_scan.poses": 8}
    assert got["sequence_scan.pack"]["s"] > 0
    assert got["sequence_scan.split"]["s"] > 0
