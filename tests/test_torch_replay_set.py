"""The port's set replay (``run_sequence_set``) and ``run --set``, f64 on
the CPU.

The shorter port of tests/test_replay_set.py's slow case: two sequences
of different lengths (6 s and 4 s, seeds 5 and 9, the small config of
that file: 160x120, N = 32) held in memory, replayed in lockstep; each
sequence's result equals its own ``run_euroc_sequence_scan`` with the same
seed (timestamps exactly, positions and attitudes to 1e-12, n_good and the
tracker's counters equal), the shorter one riding ``ok = False`` padding
for the rest of the batch; in chunks of 8, each staged while the one
before it runs, the set replay is bitwise the one chunk that covers the
set; both fill every ``replay.*`` total.  Then the CLI on two ASL folders
of the same basename: one output folder each, the second renamed.
"""

import time

import numpy as np
import pytest
import torch

from rvio_tpu_torch import config as tconfig
from rvio_tpu_torch.dataio.png import write_png_gray
from rvio_tpu_torch.dataio.rosbag import BagSequence
from rvio_tpu_torch.dataio.synthetic import render_frame, simulate_sequence
from rvio_tpu_torch.runtime import run_euroc_sequence_scan, run_sequence_set
from rvio_tpu_torch.utils import profiling

torch.set_num_threads(1)
F64 = torch.float64
T0_NS = 1_400_000_000_000_000_000
ONE_CHUNK = 10 ** 6     # a chunk size past every sequence's length


def _cfg(mod, equalizer=False):
    """tests/test_replay_set.py's small config in either package's config
    module (``mod``), the equalizer on or off."""
    return mod.RVIOConfig(
        imu=mod.ImuConfig(rate_hz=100.0),
        camera=mod.CameraConfig(fps=10.0, width=160, height=120, fx=100.0,
                                fy=100.0, cx=80.0, cy=60.0, k1=0.0, k2=0.0,
                                p1=0.0, p2=0.0),
        tracker=mod.TrackerConfig(num_features=32, max_tracking_length=6,
                                  min_tracking_length=3, min_distance=10.0,
                                  block_size_x=40, block_size_y=30,
                                  enable_equalizer=equalizer),
        init=mod.InitConfig(sigma_v0=0.1),
        tpu=mod.TpuConfig(imu_block=16))


def _mem_seq(cfg, duration, seed):
    sim = simulate_sequence(cfg, duration=duration, static_time=1.0,
                            ramp_time=1.0, seed=seed, n_landmarks=400,
                            motion_scale=0.5)
    imgs = np.stack([np.clip(render_frame(cfg, sim, k), 0, 255)
                     for k in range(len(sim.frame_t))]).astype(np.uint8)
    return BagSequence(imu_t=sim.imu_t, imu_w=sim.imu_w, imu_a=sim.imu_a,
                       cam_t=sim.frame_t, images=imgs), sim


def _set_pass(cfg, seqs, chunk_size):
    """One set replay from cleared span totals: its results, the totals
    and its wall time."""
    profiling.reset()
    t0 = time.perf_counter()
    res = run_sequence_set(cfg, seqs, dtype=F64, device="cpu",
                           chunk_size=chunk_size)
    wall = time.perf_counter() - t0
    return res, profiling.totals(), wall


@pytest.fixture(scope="module")
def set_run():
    """The set replay in chunks of 8, the single replays, the set replay's
    sequences, and each chunk size's pass (8 and one chunk for the whole
    set) with its span totals and wall time."""
    cfg = _cfg(tconfig, True)
    seqs = [_mem_seq(cfg, 6.0, 5)[0], _mem_seq(cfg, 4.0, 9)[0]]
    passes = {size: _set_pass(cfg, seqs, size) for size in (8, ONE_CHUNK)}
    singles = [run_euroc_sequence_scan(cfg, s, dtype=F64, device="cpu",
                                       chunk_size=8) for s in seqs]
    return passes[8][0], singles, (seqs, passes)


def test_set_replay_matches_single_replays(set_run):
    batch, singles, _ = set_run
    assert len(batch) == 2
    assert len(singles[0].timestamps) > len(singles[1].timestamps) + 10
    for res, single in zip(batch, singles):
        assert len(res.timestamps) == len(single.timestamps)
        np.testing.assert_allclose(res.timestamps, single.timestamps,
                                   atol=0.0)
        np.testing.assert_allclose(res.positions, single.positions, rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(res.quaternions, single.quaternions,
                                   rtol=0, atol=1e-12)
        np.testing.assert_array_equal(res.n_good, single.n_good)
        for k in ("n_tracked", "n_lost", "n_new", "n_usable", "tl_good_sum"):
            np.testing.assert_array_equal(res.diag[k], single.diag[k],
                                          err_msg=k)
        np.testing.assert_array_equal(res.active_slots, single.active_slots)
        assert res.n_good.sum() > 0


def test_set_replay_results_are_whole(set_run):
    batch, _, _ = set_run
    for res in batch:
        assert np.isfinite(res.positions).all()
        assert res.landmarks is not None and res.landmarks.shape[1] == 3
        assert res.backend_ms.shape == res.timestamps.shape
        assert res.decoder == "bag"


def test_set_replay_staged_ahead_is_one_chunk(set_run):
    """Chunks of 8, each assembled and sent up while the chunk before it
    runs (each of the two staging buffers reused), give bitwise the poses,
    slots and landmarks of one chunk over the whole set, where nothing is
    staged ahead."""
    _, _, (_, passes) = set_run
    for a, b in zip(passes[8][0], passes[ONE_CHUNK][0], strict=True):
        for name in ("timestamps", "positions", "quaternions",
                     "active_slots", "landmarks"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=name)


@pytest.mark.parametrize("chunk_size", [8, ONE_CHUNK],
                         ids=["chunks_of_8", "one_chunk"])
def test_set_replay_fills_its_spans(set_run, chunk_size):
    """Every ``replay.*`` span of a pass: one init, a chunk's assembly,
    upload, scan and readback once each, rows once a chunk and once for
    the results; ``replay.ahead`` counts the chunks staged while the one
    before ran (all but the first), ``replay.poses`` the rows returned,
    and the spans, which never nest, sum to no more than the call's
    wall."""
    _, _, (seqs, passes) = set_run
    batch, spans, wall = passes[chunk_size]
    longest = max(len(s.cam_t) - int(np.searchsorted(s.cam_t,
                                                     r.timestamps[0]))
                  for s, r in zip(seqs, batch))
    chunks = -(-longest // chunk_size)
    assert chunks >= 3 if chunk_size == 8 else chunks == 1
    n = {k: spans[f"replay.{k}"]["n"] for k in
         ("init", "assemble", "upload", "scan", "readback", "rows", "poses")}
    assert n == {"init": 1, "assemble": chunks, "upload": chunks,
                 "scan": chunks, "readback": chunks, "rows": chunks + 1,
                 "poses": sum(len(r.timestamps) for r in batch)}
    ahead = spans.get("replay.ahead", {"s": 0, "n": 0})
    assert ahead == {"s": 0, "n": chunks - 1}
    timed = [spans[f"replay.{k}"]["s"] for k in
             ("init", "assemble", "upload", "scan", "readback", "rows")]
    assert min(timed) > 0 and sum(timed) <= wall
    assert spans["replay.poses"]["s"] == 0
    assert not any(k.startswith("frame_scan.") for k in spans)


def _write_asl(root, cfg, duration, seed):
    """A small sequence as a EuRoC ASL folder (frames as PNG, IMU and
    ground truth as CSV)."""
    sim = simulate_sequence(cfg, duration=duration, static_time=1.0,
                            ramp_time=1.0, seed=seed, n_landmarks=400,
                            motion_scale=0.5)
    mav = root / "mav0"
    for d in ("imu0", "cam0/data", "state_groundtruth_estimate0"):
        (mav / d).mkdir(parents=True)
    with open(mav / "imu0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for t, w, a in zip(sim.imu_t, sim.imu_w, sim.imu_a):
            f.write(f"{T0_NS + int(t * 1e9)},{w[0]},{w[1]},{w[2]},"
                    f"{a[0]},{a[1]},{a[2]}\n")
    with open(mav / "cam0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        for k, t in enumerate(sim.frame_t):
            ts = T0_NS + int(t * 1e9)
            f.write(f"{ts},{ts}.png\n")
            img = np.clip(render_frame(cfg, sim, k), 0, 255).astype(np.uint8)
            write_png_gray(str(mav / "cam0" / "data" / f"{ts}.png"), img)
    with open(mav / "state_groundtruth_estimate0" / "data.csv", "w") as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n")
        for t, p in zip(sim.frame_t, sim.gt_p):
            f.write(f"{T0_NS + int(t * 1e9)},{p[0]},{p[1]},{p[2]},1,0,0,0\n")


def test_cli_set_writes_one_output_each(tmp_path, capsys):
    from rvio_tpu_torch.dataio.euroc import load_euroc
    from rvio_tpu_torch.dataio.tum import read_tum
    from rvio_tpu_torch.run import main
    cfg = _cfg(tconfig)
    paths = []
    for parent, (dur, seed) in zip("ab", ((3.5, 5), (3.0, 9))):
        root = tmp_path / parent / "seq"
        _write_asl(root, cfg, dur, seed)
        paths.append(str(root))
    c = cfg.camera
    cfg_path = tmp_path / "small.yaml"
    cfg_path.write_text(
        "imu: {rate_hz: 100.0}\n"
        f"camera: {{fps: 10.0, width: {c.width}, height: {c.height}, "
        f"fx: {c.fx}, fy: {c.fy}, cx: {c.cx}, cy: {c.cy}, k1: 0.0, "
        "k2: 0.0, p1: 0.0, p2: 0.0}\n"
        "tracker: {num_features: 32, max_tracking_length: 6, "
        "min_tracking_length: 3, min_distance: 10.0, block_size_x: 40, "
        "block_size_y: 30, enable_equalizer: false}\n"
        "init: {sigma_v0: 0.1}\n"
        "tpu: {imu_block: 16}\n")
    out = tmp_path / "out"
    assert main(["--set", *paths, "--device", "cpu", "--config",
                 str(cfg_path), "--output", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "fps aggregate" in printed and printed.count("ATE ") == 2
    assert sorted(p.name for p in out.iterdir()) == ["seq", "seq.1"]
    for name, path in zip(("seq", "seq.1"), paths):
        t, p, _ = read_tum(str(out / name / "stamped_pose_ests.dat"))
        single = run_euroc_sequence_scan(cfg, load_euroc(path), device="cpu")
        np.testing.assert_array_equal(t, np.round(single.timestamps, 9))
        assert np.isfinite(p).all()
