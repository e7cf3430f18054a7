"""The port's dataset replay against the JAX package: ASL folders, rosbags,
checkpoint/resume and the ``run`` CLI, f64 on the CPU.

The sequence is the one of tests/test_torch_tracker.py
``test_images_to_poses_matches_jax`` (its 320x240 config, CLAHE off),
written as a EuRoC ASL folder the way tests/test_euroc_pipeline.py writes
one, and as a bz2 bag of the same frames.  Both sides get the JAX chain's
RANSAC draws.

- folder and bag replay (``run_euroc_sequence_scan``): positions and
  attitudes within 1e-10 of the JAX replay, counters exactly;
- the per-frame replay (``run_euroc_sequence``) equals the scan;
- a run saved half-way and resumed is the uninterrupted run (1e-12 m);
  a JAX-written checkpoint loads bitwise, refuses to resume without
  draws, and resumed with the JAX chain's continued draws is the JAX
  resumed run (1e-10 m);
- the CLI writes its four outputs in the JAX CLI's formats, ``--info``
  prints the topics (``--set`` runs: tests/test_torch_replay_set.py;
  ``--sweep``: tests/test_torch_sweep.py);
- ``run_euroc_sweep`` over the folder is one row of the per-frame
  replay's frames, ATE and RPE.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvio_tpu import config as jconfig
from rvio_tpu.dataio import euroc as jeuroc
from rvio_tpu.dataio import rosbag as jrosbag
from rvio_tpu.dataio.synthetic import render_frame, simulate_sequence
from rvio_tpu.dataio.tum import write_tum as jax_write_tum
from rvio_tpu.runtime import checkpoint as jcheckpoint
from rvio_tpu.runtime.driver import bundle_imu
from rvio_tpu.runtime.image_driver import \
    run_euroc_sequence_scan as jax_replay
from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.dataio import euroc, rosbag
from rvio_tpu_torch.dataio.png import write_png_gray
from rvio_tpu_torch.runtime import (load_checkpoint, run_euroc_sequence,
                                    run_euroc_sequence_scan)
from rvio_tpu_torch.runtime.image_driver import _find_init_frame
from test_torch_tracker import _cfg, jax_draws

torch.set_num_threads(1)
N_FRAMES = 32         # filtered frames of the compared runs
CHUNK = 16
T0_NS = 1_400_000_000_000_000_000


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(folder, bag path, JAX config, port config, k0): the sequence as an
    ASL folder and as a bag, and its init frame."""
    root = tmp_path_factory.mktemp("replay")
    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    sim = simulate_sequence(jcfg, duration=6.0, static_time=1.0,
                            ramp_time=1.5, seed=6, n_landmarks=400,
                            motion_scale=0.5)
    mav = root / "asl" / "mav0"
    for d in ("imu0", "cam0/data", "state_groundtruth_estimate0"):
        (mav / d).mkdir(parents=True)
    msgs = []
    with open(mav / "imu0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for i, (t, w, a) in enumerate(zip(sim.imu_t, sim.imu_w, sim.imu_a)):
            f.write(f"{T0_NS + int(t * 1e9)},{w[0]},{w[1]},{w[2]},"
                    f"{a[0]},{a[1]},{a[2]}\n")
            msgs.append(("/imu0", b"sensor_msgs/Imu", float(t),
                         rosbag.serialize_imu(i, float(t), w, a)))
    with open(mav / "cam0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        for k, t in enumerate(sim.frame_t):
            ts = T0_NS + int(t * 1e9)
            f.write(f"{ts},{ts}.png\n")
            img = np.clip(render_frame(jcfg, sim, k), 0, 255).astype(np.uint8)
            write_png_gray(str(mav / "cam0" / "data" / f"{ts}.png"), img)
            msgs.append(("/cam0/image_raw", b"sensor_msgs/Image", float(t),
                         rosbag.serialize_image(k, float(t), img)))
    with open(mav / "state_groundtruth_estimate0" / "data.csv", "w") as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n")
        for t, p in zip(sim.frame_t, sim.gt_p):
            f.write(f"{T0_NS + int(t * 1e9)},{p[0]},{p[1]},{p[2]},1,0,0,0\n")
    msgs.sort(key=lambda m: m[2])
    bag = str(root / "sim.bag")
    rosbag.write_rosbag(bag, msgs, compression="bz2", chunk_count=4)
    seq = euroc.load_euroc(str(root / "asl"))
    groups = bundle_imu(seq.imu_t, seq.imu_w, seq.imu_a, seq.cam_t)
    _, k0 = _find_init_frame(tcfg, groups, len(seq.cam_t), torch.float64,
                             "cpu")
    return str(root / "asl"), bag, jcfg, tcfg, k0


def _loaders(source):
    if source == "folder":
        return jeuroc.load_euroc, euroc.load_euroc
    return jrosbag.load_rosbag, rosbag.load_rosbag


def _assert_same_run(got, ref, atol):
    assert len(got.timestamps) == len(ref.timestamps) > 0
    np.testing.assert_array_equal(got.timestamps, ref.timestamps)
    np.testing.assert_array_equal(got.n_good, ref.n_good)
    np.testing.assert_allclose(got.positions, ref.positions, rtol=0,
                               atol=atol)
    np.testing.assert_allclose(got.quaternions, ref.quaternions, rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def port_run(data):
    """The port's folder replay over N_FRAMES filtered frames, seed 0."""
    path, _, _, tcfg, k0 = data
    return run_euroc_sequence_scan(tcfg, euroc.load_euroc(path),
                                   dtype=torch.float64, device="cpu",
                                   chunk_size=CHUNK,
                                   max_frames=k0 + 1 + N_FRAMES)


@pytest.mark.parametrize("source", ["folder", "bag"])
def test_replay_matches_jax(data, source):
    path, bag, jcfg, tcfg, k0 = data
    src = path if source == "folder" else bag
    jload, tload = _loaders(source)
    n = k0 + 1 + N_FRAMES
    ref = jax_replay(jcfg, jload(src), dtype=jnp.float64, chunk_size=CHUNK,
                     max_frames=n)
    got = run_euroc_sequence_scan(tcfg, tload(src), dtype=torch.float64,
                                  device="cpu", chunk_size=CHUNK,
                                  max_frames=n,
                                  uniforms=jax_draws(0, N_FRAMES, 40))
    _assert_same_run(got, ref, 1e-10)
    assert got.n_good.sum() > 0
    for k in ("n_tracked", "n_lost", "n_new", "n_usable", "tl_good_sum"):
        np.testing.assert_array_equal(got.diag[k], ref.diag[k], err_msg=k)
    if source == "bag":
        assert got.decoder == "bag"
    else:
        assert got.decoder == "native" or got.decoder.startswith("python (")


def test_per_frame_replay_matches_scan(data, port_run):
    path, _, _, tcfg, k0 = data
    got = run_euroc_sequence(tcfg, euroc.load_euroc(path),
                             dtype=torch.float64, device="cpu",
                             max_frames=k0 + 1 + N_FRAMES)
    _assert_same_run(got, port_run, 1e-12)
    for k in ("n_usable", "tl_good_sum"):
        np.testing.assert_array_equal(got.diag[k], port_run.diag[k])


def test_resume_continues_exact_trajectory(data, port_run, tmp_path):
    path, _, _, tcfg, k0 = data
    seq = euroc.load_euroc(path)
    ck = str(tmp_path / "session.npz")
    kw = dict(dtype=torch.float64, device="cpu", chunk_size=CHUNK)
    half = k0 + 1 + N_FRAMES // 2
    first = run_euroc_sequence_scan(tcfg, seq, max_frames=half,
                                    checkpoint_path=ck, **kw)
    _, _, draws, cursor, _ = load_checkpoint(ck, torch.float64, "cpu")
    assert draws == (0, N_FRAMES // 2) and cursor == half - 1
    second = run_euroc_sequence_scan(tcfg, seq, resume_from=ck,
                                     max_frames=k0 + 1 + N_FRAMES, **kw)
    assert len(second.timestamps) == N_FRAMES - N_FRAMES // 2
    np.testing.assert_array_equal(
        np.concatenate([first.timestamps, second.timestamps]),
        port_run.timestamps)
    np.testing.assert_allclose(
        np.concatenate([first.positions, second.positions]),
        port_run.positions, rtol=0, atol=1e-12)


def test_jax_checkpoint_carries_across(data, tmp_path):
    """A JAX-written session: the port loads it bitwise, refuses to resume
    it without draws, and resumed with the JAX key chain's next draws
    continues as the JAX package's own resume does."""
    path, _, jcfg, tcfg, k0 = data
    ck = str(tmp_path / "jax_session.npz")
    half = k0 + 1 + N_FRAMES // 2
    end = k0 + 1 + N_FRAMES
    jseq = jeuroc.load_euroc(path)
    jax_replay(jcfg, jseq, dtype=jnp.float64, chunk_size=CHUNK,
               max_frames=half, checkpoint_path=ck)
    jfs, jts, key, jcur, jt = jcheckpoint.load_checkpoint(ck, jnp.float64)
    fs, ts, draws, cur, t = load_checkpoint(ck, torch.float64, "cpu")
    assert draws is None and (cur, t) == (jcur, jt)
    for k, v in jfs.__dict__.items():
        np.testing.assert_array_equal(getattr(fs, k).numpy(), np.asarray(v),
                                      err_msg=k)
    for k in ("pos", "hist", "length", "active"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(jts, k)), err_msg=k)
    for x, y in zip(ts.pyramid, jts.pyramid, strict=True):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))

    seq = euroc.load_euroc(path)
    kw = dict(dtype=torch.float64, device="cpu", chunk_size=CHUNK,
              resume_from=ck, max_frames=end)
    with pytest.raises(ValueError, match="uniforms"):
        run_euroc_sequence_scan(tcfg, seq, **kw)
    rows = []
    for _ in range(end - half):
        key, sub = jax.random.split(key)
        rows.append(np.asarray(jax.random.uniform(sub, (40,))))
    got = run_euroc_sequence_scan(tcfg, seq, uniforms=np.stack(rows), **kw)
    ref = jax_replay(jcfg, jseq, dtype=jnp.float64, chunk_size=CHUNK,
                     max_frames=end, resume_from=ck)
    _assert_same_run(got, ref, 1e-10)


def test_cli_writes_reference_outputs(data, port_run, tmp_path, capsys):
    from rvio_tpu.dataio.tum import read_tum

    from rvio_tpu_torch.run import main
    path, _, _, _, k0 = data
    cfg_path = tmp_path / "cfg.yaml"
    c = _cfg(tconfig).camera
    cfg_path.write_text(
        "imu: {rate_hz: 100.0}\n"
        f"camera: {{fps: 10.0, width: {c.width}, height: {c.height}, "
        f"fx: {c.fx}, fy: {c.fy}, cx: {c.cx}, cy: {c.cy}, k1: {c.k1}, "
        f"k2: {c.k2}, p1: 0.0, p2: 0.0}}\n"
        "tracker: {num_features: 40, max_tracking_length: 8, "
        "min_tracking_length: 3, min_distance: 12.0, block_size_x: 80, "
        "block_size_y: 60, enable_equalizer: false}\n"
        "init: {sigma_v0: 0.1}\n"
        "tpu: {imu_block: 16, ekf_tail_fused: true}\n")
    out = tmp_path / "out"
    assert main(["--euroc", path, "--config", str(cfg_path), "--output",
                 str(out), "--device", "cpu", "--dtype", "float64"]) == 0
    printed = capsys.readouterr().out
    assert "ATE RMSE" in printed and "decoder" in printed
    names = sorted(p.name for p in out.iterdir())
    assert names == ["landmarks.xyz", "stamped_pose_ests.dat",
                     "time_cost.dat", "trajectory.svg"]
    t, p, q = read_tum(str(out / "stamped_pose_ests.dat"))
    # the seed-0 run over the whole folder begins as the fixture's run
    m = len(port_run.timestamps)
    np.testing.assert_array_equal(t[:m], port_run.timestamps)
    # the file keeps nine decimals
    np.testing.assert_allclose(p[:m], port_run.positions, rtol=0, atol=1e-9)
    ref = tmp_path / "ref.dat"
    jax_write_tum(str(ref), t, p, q)
    assert (out / "stamped_pose_ests.dat").read_text() == ref.read_text()
    cost = np.loadtxt(out / "time_cost.dat")
    assert cost.shape == (len(t), 3)
    np.testing.assert_array_equal(cost[:, 0], np.arange(1, len(t) + 1))
    assert np.loadtxt(out / "landmarks.xyz").shape[1] == 3
    assert (out / "trajectory.svg").read_text().startswith("<svg")


def test_cli_info(data, capsys):
    from rvio_tpu_torch.run import main
    _, bag, *_ = data
    assert main(["--info", bag]) == 0
    printed = capsys.readouterr().out
    assert "/cam0/image_raw" in printed and "sensor_msgs/Imu" in printed
    assert "duration:" in printed


def test_euroc_sweep_row(data, monkeypatch):
    """``run_euroc_sweep`` on the folder: one row named after it, whose
    frames, ATE and RPE are those of the per-frame replay it ran (ground
    truth matched by ``match_nearest``), and a finite table."""
    from rvio_tpu_torch.eval import ate
    from rvio_tpu_torch.eval.sweep import format_table, run_euroc_sweep
    from rvio_tpu_torch.runtime import image_driver
    path, _, _, tcfg, _ = data
    runs = []

    def recorded(*args, **kw):
        runs.append(run_euroc_sequence(*args, **kw))
        return runs[-1]

    monkeypatch.setattr(image_driver, "run_euroc_sequence", recorded)
    rows = run_euroc_sweep(tcfg, [path + "/"], dtype=torch.float64,
                           device="cpu")
    res, seq = runs[0], euroc.load_euroc(path)
    gi, ok = ate.match_nearest(seq.gt_t, res.timestamps)
    assert ok.sum() >= 3 and len(rows) == 1
    row = rows[0]
    assert (row.name, row.frames) == ("asl", len(res.timestamps))
    assert row.ate_m == ate.ate_rmse(res.positions[ok], seq.gt_p[gi][ok])
    assert row.rpe_m == ate.rpe_rmse(res.positions[ok], seq.gt_p[gi][ok])
    assert row.ate_m < 0.1 and row.n_good_mean > 0 and row.fps > 0
    assert "asl" in format_table(rows)
