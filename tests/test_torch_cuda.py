"""The port's CUDA kernels on the card (marked ``gpu``; they skip without one).

Run on a machine with a CUDA card (``--noconftest`` where jax, which
tests/conftest.py imports, is not installed):

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest

Each kernel is held against its plain PyTorch version on the same inputs
at its main path's operating point (rvio_tpu_torch/ops/checks.py states
the tolerances); SequenceDriver's main path must launch every filter
kernel once per frame, the images -> poses path every kernel as often as
it implies (at a small config with CLAHE off and on, and at
``RVIOConfig()``), and stay close to the CPU plain path (with CLAHE on at
the small config, as accurate as it); a frame of images -> poses (CLAHE
off and on), ``ImagePipeline.process_device`` and the filter step with
K5 make no synchronizing call; K5 takes the wider ridge where its plain
version does, and the filter with K5 stays with the filter that runs the
library chain in its place; K1 at every trip count, for several streams
and past a warp's lanes of samples, and K4 at every order it takes, for
feature counts that do not fill a block, with an indefinite lane;
K8 at feature counts around a warp and a block, every window size, one
trip and thirty, near the tile edges, with every status false, with the
T rule of its finish, in a replayed CUDA graph and on two streams at
once, and K6 bitwise at every pyramid level, on images smaller than the
tile, past every side and at other tile shapes;
K10 at seven frame sizes, on and off the clip limit's grid, on a constant
and a random frame, in a replayed CUDA graph, and K3 at both compiled row
bounds and their edges, F = 0 to 200, t_eff = 2 and L, c0 at both ends of
the window, a feature of rank two and one with a single measurement;
K11 and K12 bitwise with their plain versions at widths that are no
multiple of 4, heights that are no multiple of a strip or a block, the
5 x 5 least, K11 at g = 8 and on an image off a 16-byte boundary, each
in a replayed CUDA graph and on two streams at once;
the replay of an ASL folder is the rendered scan of the same frames, and
a resumed replay the uninterrupted one; the one-dispatch frame: the
graphed sequence scan (1 and 8 frames a graph) and the graphed image
chunk scans (fused, front then back) bitwise with the eager frames, every
kernel's launches under replay, two graphs that hold K8 replayed in turn
on the graph stream, ImagePipeline's outputs not aliased across frames,
and a capture that meets a host sync raising; the segment-batched filter:
K1-K5 at its shapes against their plain versions, the graphed batched
scan against single scans with one launch a batched frame, the masked
scan keeping a masked segment's state, and the warm split with its
repair pass; the batched tracker: K6, K8, K9 (B·N rows), K10, K11 and
K13 at B = 1, 2 and 4 against their plain versions, K8's segments each
with its own T bitwise against single launches, the batched wrappers
refusing mismatched parts, and the set replay against the single
replays and, staged a chunk ahead, bitwise against one whole chunk; QR
compression in graphed frames (single and B = 4, run in a child process)
against the same frames run eagerly, windows of 16, 19, 32 and 64
clones (K5's wide route once a frame; K4 and K3 past their narrow
instances) against the CPU and a batched wide-window scan whose
rows are bitwise equal, K5's wide route at n = 93 to 384 (B = 1, 4 and
16, the wider ridge, NaN where a factorization fails) and where its
rows spill (n = 516, 600, 2700), both K5 routes near the f64 chain on
scripts/joseph_order.py's stacks, K4 past m = 64 and K3 past L = 64, K8
at windows of 17 to 31 and past 31 (every feature lost), K6, K8 and K9
at the stress config's shapes (800 lanes, the 30 x 47 fifth level), and
the bench's feature path with ``BENCH_COMPRESSION=qr``.  Whether a
card is present is decided in the fixture, so every process collects the
same tests.
"""

import numpy as np
import pytest
import torch

KERNEL_NAMES = ["propagate_block", "lm_triangulate", "jac_project",
                "batched_quadform", "gather_tiles", "lk_level",
                "subpix_refine", "shi_tomasi_nms", "clahe_luts",
                "clahe_apply", "shi_tomasi", "gather_tiles_aligned",
                "ekf_tail"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_matches_plain(cuda, name):
    from rvio_tpu_torch.ops.checks import kernel_checks
    chk = {c.name: c for c in kernel_checks(cuda)}[name]
    before = chk.kernel.launches
    chk.check()
    torch.cuda.synchronize()
    assert chk.kernel.launches == before + chk.check_launches


@pytest.mark.gpu
def test_ekf_tail_fallback_matches_plain(cuda):
    """K5 on inputs whose factor must take the wider ridge: the kernel
    decides it, as the plain version does, and agrees with it."""
    from rvio_tpu_torch.ops.checks import (EKF_TAIL_FALLBACK_SCALED_TOL,
                                           EKF_TAIL_FALLBACK_TOL,
                                           ekf_tail_case,
                                           ekf_tail_fallback_inputs)
    for seed in range(3):
        chk = ekf_tail_case(cuda, *ekf_tail_fallback_inputs(
            np.random.default_rng(seed)), tol=EKF_TAIL_FALLBACK_TOL,
            what="fallback", scaled_tol=EKF_TAIL_FALLBACK_SCALED_TOL)
        assert chk.info["fallback"]
        chk.check()
        assert bool(chk.run_kernel()[2].all())


@pytest.mark.gpu
def test_ekf_tail_batch_and_narrow_window(cuda):
    """K5 at M = 7 (n = 42, rows padded to 44 and D to 68) on a batch of
    three: each entry agrees with the plain version, and with a single
    launch of it."""
    from rvio_tpu_torch.ops.checks import ekf_tail_stack
    from rvio_tpu_torch.ops.ekf_tail import ekf_tail, ekf_tail_plain
    rng = np.random.default_rng(5)
    cases = [ekf_tail_stack(rng, 7, 320, dead_clones=2) for _ in range(3)]
    args = [torch.as_tensor(np.stack(x), device=cuda) for x in zip(*cases)]
    dx, P_new, fb = ekf_tail(*args)
    ref = ekf_tail_plain(*args)
    for got, want in zip((dx, P_new), ref[:2]):
        err = float((got - want).abs().max() / want.abs().max())
        assert err < 2e-5, err
    assert not bool(fb.any()) and not bool(ref[2].any())
    one = ekf_tail(*(a[1:2].contiguous() for a in args))
    assert torch.equal(one[0][0], dx[1]) and torch.equal(one[1][0], P_new[1])


@pytest.mark.gpu
def test_ekf_tail_refuses_f64(cuda):
    from rvio_tpu_torch.ops.ekf_tail import ekf_tail
    n = 6
    args = [torch.eye(n, device=cuda)[None], torch.ones(1, n, device=cuda),
            torch.eye(24 + n, device=cuda)[None], torch.ones(1, device=cuda)]
    for i in range(4):
        bad = list(args)
        bad[i] = bad[i].double()
        with pytest.raises(TypeError):
            ekf_tail(*bad)
    with pytest.raises(ValueError):                  # D != 24 + n
        ekf_tail(args[0], args[1], args[2][:, 1:, 1:].contiguous(), args[3])
    n = 0                                # every n >= 1 runs (the wide route
    with pytest.raises(ValueError):      # past 92): only an empty window raises
        ekf_tail(torch.eye(n, device=cuda)[None], torch.ones(1, n, device=cuda),
                 torch.eye(24 + n, device=cuda)[None], args[3])
    ekf_tail(*args)                      # the refusal leaves no error behind
    torch.cuda.synchronize()


def _feature_cfg():
    from rvio_tpu_torch.config import (CameraConfig, ImuConfig, RVIOConfig,
                                       TpuConfig, TrackerConfig)
    return RVIOConfig(imu=ImuConfig(rate_hz=100.0), camera=CameraConfig(fps=10.0),
                      tracker=TrackerConfig(num_features=16,
                                            max_tracking_length=8),
                      tpu=TpuConfig(imu_block=16))


@pytest.mark.gpu
def test_fused_filter_step_reads_nothing_back(cuda):
    """The filter step launches K5 once a frame, decides the fallback on
    the card and reads nothing back: it runs under
    set_sync_debug_mode("error")."""
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.filter.propagation import pad_imu
    from rvio_tpu_torch.ops.ekf_tail import ekf_tail
    from rvio_tpu_torch.runtime import (InitializationGate, SequenceDriver,
                                        batches_from_sim, bundle_imu,
                                        make_filter_step)
    cfg = _feature_cfg()
    sim = simulate_sequence(cfg, duration=6.0, static_time=1.2, seed=11,
                            meas_noise=0.0015, imu_noise=True)
    batches = batches_from_sim(sim)
    gate = InitializationGate(cfg, torch.float32, cuda)
    state, rows = None, []
    for k, (w, a, dts) in enumerate(bundle_imu(sim.imu_t, sim.imu_w,
                                               sim.imu_a, sim.frame_t)):
        if len(w) < 2:
            continue
        if state is None:
            state = gate.feed(w, a, dts)
            continue
        b = batches[k]
        rows.append((pad_imu(w, a, dts, cfg.tpu.imu_block),
                     (b.meas, b.track_len, b.is_type2, b.valid)))
    bundles = SequenceDriver(cfg, device=cuda)._stack(rows[:30])
    step = make_filter_step(cfg, cuda)
    ekf_tail.launches = 0
    for t in range(30):
        if t > 0:                            # the first frame warms caches
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, out = step(state, bundles.frame(t))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert ekf_tail.launches == 30
    assert torch.isfinite(out["p_Gk"]).all() and int(out["n_good"]) > 2


@pytest.mark.gpu
def test_fused_matches_unfused_on_card(cuda, monkeypatch):
    """The feature-level filter on the card with K5 and with the unfused
    library chain (the plain version) called in its place: K5 runs once a
    filtered frame, and the two trajectories differ by summation order
    alone (the card-vs-CPU limit of chip_smoke.py)."""
    import rvio_tpu_torch.filter.update as update
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.ops.ekf_tail import ekf_tail, ekf_tail_plain
    from rvio_tpu_torch.runtime import SequenceDriver, batches_from_sim
    sim = simulate_sequence(_feature_cfg(), duration=6.0, static_time=1.2,
                            seed=11, meas_noise=0.0015, imu_noise=True)
    args = (sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t, batches_from_sim(sim))
    res, launches = {}, {}
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(update, "ekf_tail", ekf_tail_plain)
        ekf_tail.launches = 0
        res[fused] = SequenceDriver(_feature_cfg(), device=cuda).run(*args)
        launches[fused] = ekf_tail.launches
    n = len(res[True].timestamps)
    assert launches == {False: 0, True: n}
    np.testing.assert_array_equal(res[True].timestamps, res[False].timestamps)
    np.testing.assert_allclose(res[True].positions, res[False].positions,
                               atol=1e-4)


@pytest.mark.gpu
def test_kernels_refuse_f64(cuda):
    from rvio_tpu_torch.ops.spd_solve import batched_quadform
    S = torch.eye(4, dtype=torch.float64, device=cuda)[None]
    with pytest.raises(TypeError):
        batched_quadform(S, torch.ones(1, 4, dtype=torch.float64, device=cuda))


@pytest.mark.gpu
def test_driver_launches_every_kernel(cuda):
    from rvio_tpu_torch.config import (CameraConfig, ImuConfig, RVIOConfig,
                                       TpuConfig, TrackerConfig)
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.ops import (ekf_tail, jac_project, lm_triangulate,
                                    propagate_block, spd_solve)
    from rvio_tpu_torch.runtime import SequenceDriver, batches_from_sim
    wrappers = [propagate_block.propagate_block, lm_triangulate.lm_triangulate,
                jac_project.jac_project, spd_solve.batched_quadform,
                ekf_tail.ekf_tail]
    cfg = RVIOConfig(imu=ImuConfig(rate_hz=100.0), camera=CameraConfig(fps=10.0),
                     tracker=TrackerConfig(num_features=16,
                                           max_tracking_length=8),
                     tpu=TpuConfig(imu_block=16))
    sim = simulate_sequence(cfg, duration=6.0, static_time=1.2, seed=11,
                            meas_noise=0.0015, imu_noise=True)
    args = (sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t, batches_from_sim(sim))
    for w in wrappers:
        w.launches = 0
    gpu = SequenceDriver(cfg, device=cuda).run(*args)
    n = len(gpu.timestamps)
    assert [w.launches for w in wrappers] == [n] * 5
    cpu = SequenceDriver(cfg, device="cpu").run(*args)
    np.testing.assert_allclose(gpu.positions, cpu.positions, atol=1e-4)


@pytest.mark.gpu
def test_image_kernels_refuse_f64(cuda):
    from rvio_tpu_torch.ops.clahe import clahe_apply, clahe_luts
    from rvio_tpu_torch.ops.shi_tomasi import shi_tomasi, shi_tomasi_nms
    from rvio_tpu_torch.ops.tile_gather import (gather_tiles,
                                                gather_tiles_aligned)
    img = torch.zeros(48, 64, dtype=torch.float64, device=cuda)
    org = torch.zeros(3, 2, dtype=torch.int32, device=cuda)
    luts = torch.zeros(25, 256, dtype=torch.float32, device=cuda)
    for call in (lambda: shi_tomasi_nms(img), lambda: shi_tomasi(img),
                 lambda: gather_tiles(img, org, 40, 32),
                 lambda: gather_tiles_aligned(img, org),
                 lambda: clahe_luts(img), lambda: clahe_apply(img, luts)):
        with pytest.raises(TypeError):
            call()


def _small_image_cfg(equalizer=False):
    from rvio_tpu_torch.config import (CameraConfig, ImuConfig, InitConfig,
                                       RVIOConfig, TpuConfig, TrackerConfig)
    return RVIOConfig(
        imu=ImuConfig(rate_hz=100.0),
        camera=CameraConfig(fps=10.0, width=320, height=240, fx=200.0,
                            fy=200.0, cx=160.0, cy=120.0, k1=-0.05, k2=0.01,
                            p1=0.0, p2=0.0),
        tracker=TrackerConfig(num_features=40, max_tracking_length=8,
                              min_tracking_length=3, min_distance=12.0,
                              block_size_x=80, block_size_y=60,
                              enable_equalizer=equalizer),
        init=InitConfig(sigma_v0=0.1), tpu=TpuConfig(imu_block=16))


@pytest.mark.gpu
@pytest.mark.parametrize("equalizer", [False, True])
def test_frame_reads_nothing_back(cuda, equalizer):
    """A frame of images -> poses (track_fn, then the filter step) makes no
    synchronizing call: it runs under set_sync_debug_mode("error")."""
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.dataio.synthetic import render_frame
    from rvio_tpu_torch.filter.propagation import ImuBlock
    from rvio_tpu_torch.frontend import make_tracker
    from rvio_tpu_torch.runtime import bundle_imu, make_filter_step
    from rvio_tpu_torch.runtime.image_driver import (_find_init_frame,
                                                     _imu_chunk_arrays)
    from rvio_tpu_torch.runtime.step import FrameBundle
    cfg = _small_image_cfg(equalizer)
    sim = simulate_sequence(cfg, duration=4.0, static_time=1.0, ramp_time=1.5,
                            seed=6, n_landmarks=400, motion_scale=0.5)
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    fs, k0 = _find_init_frame(cfg, groups, len(sim.frame_t), torch.float32,
                              cuda)
    init_fn, track_fn = make_tracker(cfg, cuda)
    step = make_filter_step(cfg, cuda)
    ts, _ = init_fn(torch.as_tensor(render_frame(cfg, sim, k0)))
    ks = list(range(k0 + 1, k0 + 5))
    ch = _imu_chunk_arrays(groups, ks, cfg.tpu.imu_block, torch.float32, cuda)
    imgs = torch.as_tensor(np.stack([render_frame(cfg, sim, k) for k in ks]),
                           device=cuda)
    u = torch.rand(len(ks), cfg.tracker.num_features, device=cuda)
    for i in range(len(ks)):
        if i > 0:                            # the first frame warms caches
            torch.cuda.set_sync_debug_mode("error")
        try:
            ts, batch, _ = track_fn(ts, imgs[i], ch["imu_w"][i],
                                    ch["imu_dt"][i], ch["imu_valid"][i], u[i])
            imu = ImuBlock(w=ch["imu_w"][i], a=ch["imu_a"][i],
                           dt=ch["imu_dt"][i], valid=ch["imu_valid"][i])
            fs, out = step(fs, FrameBundle(imu=imu, batch=batch))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out["p_Gk"]).all()


@pytest.mark.gpu
def test_pipeline_process_device_does_not_sync(cuda):
    """ImagePipeline.process_device enqueues a frame's uploads and work and
    reads nothing back; only unpack synchronizes."""
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.dataio.synthetic import render_frame
    from rvio_tpu_torch.runtime import ImagePipeline, bundle_imu
    cfg = _small_image_cfg(True)
    sim = simulate_sequence(cfg, duration=4.0, static_time=1.0, ramp_time=1.5,
                            seed=6, n_landmarks=400, motion_scale=0.5)
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    pipe = ImagePipeline(cfg, device=cuda)
    outs, checked = [], 0
    for k in range(len(sim.frame_t)):
        img = np.clip(render_frame(cfg, sim, k), 0, 255).astype(np.uint8)
        tracked = pipe.tracker_state is not None and pipe.n_tracked > 0
        if tracked:                          # the first tracked frame warms up
            torch.cuda.set_sync_debug_mode("error")
        try:
            dev = pipe.process_device(sim.frame_t[k], img, *groups[k])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        checked += tracked and dev is not None
        if dev is not None:
            outs.append(pipe.unpack(dev))
    assert checked > 10 and all(np.isfinite(o["p_Gk"]).all() for o in outs)


def _image_launches(cfg, sim, cuda, **kw):
    from rvio_tpu_torch.ops import (clahe, ekf_tail, jac_project,
                                    klt_iterate, lm_triangulate,
                                    propagate_block, shi_tomasi, spd_solve,
                                    tile_gather)
    from rvio_tpu_torch.runtime import run_rendered_sequence_scan
    wrappers = {w.__name__: w for w in (
        propagate_block.propagate_block, lm_triangulate.lm_triangulate,
        jac_project.jac_project, spd_solve.batched_quadform,
        tile_gather.gather_tiles, klt_iterate.lk_level,
        klt_iterate.subpix_refine, shi_tomasi.shi_tomasi_nms,
        clahe.clahe_luts, clahe.clahe_apply, shi_tomasi.shi_tomasi,
        tile_gather.gather_tiles_aligned, ekf_tail.ekf_tail)}
    for w in wrappers.values():
        w.launches = 0
    gpu = run_rendered_sequence_scan(cfg, sim, device=cuda, **kw)
    n = len(gpu.timestamps)
    got = {k: w.launches for k, w in wrappers.items()}
    eq = n + 1 if cfg.tracker.enable_equalizer else 0
    want = dict.fromkeys(KERNEL_NAMES[:4], n)
    want.update(gather_tiles=9 * n + 1, lk_level=4 * n, subpix_refine=n + 1,
                shi_tomasi_nms=n + 1, clahe_luts=eq, clahe_apply=eq,
                shi_tomasi=0, gather_tiles_aligned=0, ekf_tail=n)
    assert got == want
    return gpu


@pytest.mark.gpu
def test_image_driver_launches_every_kernel(cuda):
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.runtime import run_rendered_sequence_scan
    cfg = _small_image_cfg()
    sim = simulate_sequence(cfg, duration=6.0, static_time=1.0, ramp_time=1.5,
                            seed=6, n_landmarks=400, motion_scale=0.5)
    gpu = _image_launches(cfg, sim, cuda, chunk_size=16)
    cpu = run_rendered_sequence_scan(cfg, sim, device="cpu", chunk_size=16)
    np.testing.assert_array_equal(cpu.timestamps, gpu.timestamps)
    assert (cpu.active_slots == gpu.active_slots).mean() > 0.99
    np.testing.assert_allclose(gpu.positions, cpu.positions, atol=1e-3)


@pytest.mark.gpu
def test_image_driver_small_config_clahe_on(cuda):
    """The small config with CLAHE on: every kernel launches as the path
    implies, and the card's trajectory stays as accurate as the CPU plain
    path's.  The two part beyond summation order here (ROADMAP.md section
    3), so the bound is on each run's ATE: an H100 run read 0.0296 m on
    the card and 0.0308 m on the CPU (f32 and f64 alike)."""
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.eval.ate import ate_rmse
    from rvio_tpu_torch.runtime import run_rendered_sequence_scan
    cfg = _small_image_cfg(True)
    sim = simulate_sequence(cfg, duration=6.0, static_time=1.0, ramp_time=1.5,
                            seed=6, n_landmarks=400, motion_scale=0.5)
    gpu = _image_launches(cfg, sim, cuda, chunk_size=16)
    cpu = run_rendered_sequence_scan(cfg, sim, device="cpu", chunk_size=16)
    np.testing.assert_array_equal(cpu.timestamps, gpu.timestamps)
    ate = {name: ate_rmse(r.positions, sim.gt_p[np.searchsorted(
        sim.frame_t, r.timestamps)]) for name, r in (("card", gpu),
                                                      ("cpu", cpu))}
    assert ate["card"] < 0.04 and ate["cpu"] < 0.04, ate


@pytest.mark.gpu
def test_image_driver_launches_at_default_config(cuda):
    """RVIOConfig() unmodified (752 x 480, 200 slots, CLAHE on): every
    kernel of the path launches as often as the path implies, and the
    card stays with the CPU plain path as in the small-config test with
    CLAHE off."""
    from rvio_tpu_torch.config import RVIOConfig
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.runtime import bundle_imu, run_rendered_sequence_scan
    from rvio_tpu_torch.runtime.image_driver import _find_init_frame
    cfg = RVIOConfig()
    sim = simulate_sequence(cfg, duration=4.0, static_time=1.5, ramp_time=5.0,
                            seed=7, n_landmarks=2000, motion_scale=0.8,
                            meas_noise=0.001, imu_noise=True)
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    _, k0 = _find_init_frame(cfg, groups, len(sim.frame_t), torch.float32,
                             "cpu")
    gpu = _image_launches(cfg, sim, cuda, max_frames=k0 + 21)
    assert len(gpu.timestamps) == 20 and np.isfinite(gpu.positions).all()
    cpu = run_rendered_sequence_scan(cfg, sim, device="cpu",
                                     max_frames=k0 + 21)
    np.testing.assert_array_equal(cpu.timestamps, gpu.timestamps)
    assert (cpu.active_slots == gpu.active_slots).mean() > 0.99
    np.testing.assert_allclose(gpu.positions, cpu.positions, atol=1e-3)


@pytest.fixture
def asl_folder(tmp_path):
    """The small config's sequence (CLAHE on) as a EuRoC ASL folder, the
    folder loaded back and the simulator's sequence on its stamps."""
    from chip_smoke import write_asl
    from rvio_tpu_torch.dataio import simulate_sequence
    cfg = _small_image_cfg(True)
    sim = simulate_sequence(cfg, duration=6.0, static_time=1.0, ramp_time=1.5,
                            seed=6, n_landmarks=400, motion_scale=0.5)
    seq, sim_f = write_asl(str(tmp_path / "asl"), cfg, sim)
    return cfg, seq, sim_f


@pytest.mark.gpu
def test_folder_replay_matches_rendered_scan(cuda, asl_folder):
    """The folder replay on the card is the rendered scan: the same frames
    (PNG is lossless), IMU, stamps and draws give the same run."""
    from rvio_tpu_torch.runtime import (run_euroc_sequence_scan,
                                        run_rendered_sequence_scan)
    cfg, seq, sim_f = asl_folder
    scan = run_rendered_sequence_scan(cfg, sim_f, device=cuda, chunk_size=16)
    rep = run_euroc_sequence_scan(cfg, seq, device=cuda, chunk_size=16)
    np.testing.assert_array_equal(rep.timestamps, scan.timestamps)
    np.testing.assert_array_equal(rep.active_slots, scan.active_slots)
    np.testing.assert_allclose(rep.positions, scan.positions, rtol=0,
                               atol=1e-6)
    assert rep.decoder == "native" or rep.decoder.startswith("python (")


@pytest.mark.gpu
def test_resume_on_card(cuda, asl_folder, tmp_path):
    """A replay saved half-way and resumed is the uninterrupted replay
    (K5 once a frame)."""
    from rvio_tpu_torch.ops.ekf_tail import ekf_tail
    from rvio_tpu_torch.runtime import run_euroc_sequence_scan
    cfg, seq, _ = asl_folder
    ekf_tail.launches = 0
    full = run_euroc_sequence_scan(cfg, seq, device=cuda, chunk_size=16)
    assert ekf_tail.launches == len(full.timestamps) > 20
    ck = str(tmp_path / "session.npz")
    half = int(np.searchsorted(seq.cam_t, full.timestamps[20])) + 1
    first = run_euroc_sequence_scan(cfg, seq, device=cuda, chunk_size=16,
                                    max_frames=half, checkpoint_path=ck)
    second = run_euroc_sequence_scan(cfg, seq, device=cuda, chunk_size=16,
                                     resume_from=ck)
    assert len(first.timestamps) == 21
    np.testing.assert_array_equal(
        np.concatenate([first.timestamps, second.timestamps]), full.timestamps)
    np.testing.assert_allclose(
        np.concatenate([first.positions, second.positions]), full.positions,
        rtol=0, atol=1e-6)


def _tail_inputs(rng, n, rows=None, masked_frac=0.3, dead=0):
    """C, b, P, sig2 of one system at any n (not only 6 M): a random row
    stack of which the last ``masked_frac`` is masked, ``dead`` trailing
    columns of H and rows and columns of P zero (dead clones), f32."""
    rows = rows or 3 * n
    D = 24 + n
    H = rng.normal(size=(rows, n)) * 0.5
    H[int(rows * (1 - masked_frac)):] = 0.0
    if dead:
        H[:, n - dead:] = 0.0
    r = rng.normal(size=rows) * 0.01
    A = rng.normal(size=(D, D)) * 0.02
    P = A @ A.T + np.eye(D) * 1e-4
    if dead:
        P[D - dead:, :] = 0.0
        P[:, D - dead:] = 0.0
    return (np.float32(H.T @ H), np.float32(H.T @ r), np.float32(P),
            np.float32(2.3e-6))


def _tail_against_plain(cuda, cases):
    """K5 on the stacked ``cases`` against the plain version (the limits of
    ops/checks.py's seeded stack: fallback and NaN identical, dx and P_new
    within 2e-5 of their largest entry, n / 92 times that past n = 92
    (ops/checks.ekf_tail_tol), P_new within ops/checks.py's
    EKF_TAIL_SCALED_TOL scaled by its diagonal, n / 92 times it past 92)
    and each entry bitwise its own single launch."""
    from rvio_tpu_torch.ops.checks import (EKF_TAIL_FALLBACK_SCALED_TOL,
                                           EKF_TAIL_FALLBACK_TOL,
                                           EKF_TAIL_SCALED_TOL, ekf_tail_tol,
                                           scaled_cov_err)
    from rvio_tpu_torch.ops.ekf_tail import ekf_tail, ekf_tail_plain
    args = [torch.as_tensor(np.stack(x), device=cuda) for x in zip(*cases)]
    before = ekf_tail.launches
    dx, P_new, fb = ekf_tail(*args)
    assert ekf_tail.launches == before + 1
    ref = ekf_tail_plain(*args)
    assert torch.equal(fb, ref[2])
    n = args[0].shape[-1]
    for e in range(len(cases)):
        wide = bool(ref[2][e])
        tol = ekf_tail_tol(EKF_TAIL_FALLBACK_TOL if wide else 2e-5, n)
        stol = (EKF_TAIL_FALLBACK_SCALED_TOL if wide
                else ekf_tail_tol(EKF_TAIL_SCALED_TOL, n))
        for got, want in ((dx[e], ref[0][e]), (P_new[e], ref[1][e])):
            assert torch.equal(torch.isnan(got), torch.isnan(want))
            scale = want.abs().max().clamp_min(torch.finfo(want.dtype).tiny)
            err = float((got - want).abs().max() / scale)
            assert err <= tol, (e, err)
        scaled = scaled_cov_err(P_new[e].double().cpu().numpy(),
                                ref[1][e].double().cpu().numpy())
        assert scaled <= stol, (e, scaled)
        one = ekf_tail(*(a[e:e + 1].contiguous() for a in args))
        assert torch.equal(one[0][0], dx[e]) and torch.equal(one[1][0], P_new[e])
        assert bool(one[2][0]) == bool(fb[e])
    return ref[2]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("n", [6, 42, 84, 92])
def test_ekf_tail_sizes_and_batches(cuda, n, B):
    """K5 (a cluster of CTAs per system) at window sizes whose rows and
    columns split over the cluster unevenly (n = 6 leaves most CTAs
    without columns; n = 92, the largest, fills the shared memory), on
    batches of one to sixteen systems."""
    rng = np.random.default_rng(100 * n + B)
    cases = [_tail_inputs(rng, n, dead=6 * (e % 2) if n > 6 else 0)
             for e in range(B)]
    fb = _tail_against_plain(cuda, cases)
    assert not bool(fb.any())


@pytest.mark.gpu
def test_ekf_tail_wider_ridge_in_one_entry(cuda):
    """B = 3 with the seeded wider-ridge inputs in the middle entry only:
    the flag and the ridge are decided per system."""
    from rvio_tpu_torch.ops.checks import ekf_tail_fallback_inputs
    rng = np.random.default_rng(3)
    cases = [_tail_inputs(rng, 84), ekf_tail_fallback_inputs(rng),
             _tail_inputs(rng, 84)]
    fb = _tail_against_plain(cuda, cases)
    assert fb.tolist() == [False, True, False]


@pytest.mark.gpu
def test_ekf_tail_dead_clones(cuda):
    """Every row masked (C = 0: the ridge alone is factored), and a window
    whose trailing clones are dead (zero columns in H, zero rows and
    columns in P), as the growth phase gives."""
    from rvio_tpu_torch.ops.checks import ekf_tail_stack
    rng = np.random.default_rng(4)
    cases = [ekf_tail_stack(rng, 14, 600, masked_frac=1.0),
             ekf_tail_stack(rng, 14, 600, dead_clones=5),
             ekf_tail_stack(rng, 14, 600, masked_frac=1.0, dead_clones=14)]
    fb = _tail_against_plain(cuda, cases)
    assert not bool(fb.any())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("n", [93, 96, 114, 192, 384])
def test_ekf_tail_wide_route(cuda, n, B):
    """K5's wide route (n > 92: windows of 16 or more clones, and n = 93,
    not a multiple of 8) on seeded stacks, dead clones in every other
    entry, B = 1 and 4 systems in one launch."""
    rng = np.random.default_rng(7 * n + B)
    cases = [_tail_inputs(rng, n, dead=6 * (e % 2)) for e in range(B)]
    fb = _tail_against_plain(cuda, cases)
    assert not bool(fb.any())


@pytest.mark.gpu
def test_ekf_tail_wide_route_sixteen_systems(cuda):
    """B = 16 systems at n = 192 in one call (the factorizations' clusters
    of 8 CTAs over the card, the row blocks and tiles of the other
    launches for every system), dead clones in every other entry."""
    rng = np.random.default_rng(192 * 16)
    cases = [_tail_inputs(rng, 192, dead=6 * (e % 2)) for e in range(16)]
    fb = _tail_against_plain(cuda, cases)
    assert not bool(fb.any())


def _tail_near_f64(cuda, cases, factor=2.0):
    """K5 on the stacked ``cases`` against its plain version in f64 on the
    CPU: dx and P_new relative to their largest entry, and P_new scaled by
    its diagonal, each within ``factor`` times the distance of the plain
    version in f32 on the card (the unfused chain's own f32 rounding) or
    within 1e-4 scaled; no wider ridge; one launch."""
    from rvio_tpu_torch.ops.checks import scaled_cov_err
    from rvio_tpu_torch.ops.ekf_tail import ekf_tail, ekf_tail_plain
    args = [torch.as_tensor(np.stack(x), device=cuda) for x in zip(*cases)]
    before = ekf_tail.launches
    got = ekf_tail(*args)
    torch.cuda.synchronize()
    assert ekf_tail.launches == before + 1
    f32 = ekf_tail_plain(*args)
    ref = ekf_tail_plain(*(a.double().cpu() for a in args))
    assert not bool(got[2].any()) and not bool(ref[2].any())
    for e in range(len(cases)):
        for k in (0, 1):
            want = ref[k][e]
            scale = float(want.abs().max())

            def err(x):
                return float((x[k][e].double().cpu() - want).abs().max()) / scale
            assert err(got) <= factor * err(f32), (e, k, err(got), err(f32))
        w = ref[1][e].numpy()
        sk = scaled_cov_err(got[1][e].double().cpu().numpy(), w)
        sp = scaled_cov_err(f32[1][e].double().cpu().numpy(), w)
        assert sk <= max(1e-4, factor * sp), (e, sk, sp)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [516, 600, 2700])
def test_ekf_tail_wide_route_spills(cuda, n):
    """Past n = 512 the factorizations' rows do not fit the cluster's
    shared memory and stay in the workspace (csrc/ekf_tail_wide.cu
    ``factor_spills``), past about n = 2600 the solves' rows too
    (``wt_global``): as near the f64 function as the unfused chain in f32
    is (``_tail_near_f64``), two systems (one at 2700)."""
    rng = np.random.default_rng(n)
    _tail_near_f64(cuda, [_tail_inputs(rng, n, dead=6 * e)
                          for e in range(2 if n < 1000 else 1)])


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [97, 98, 99])
@pytest.mark.parametrize("n", [84, 96, 192, 384])
def test_ekf_tail_near_the_f64_chain(cuda, n, seed):
    """K5 on the seeded stacks of scripts/joseph_order.py (ops/checks.py
    ``ekf_tail_stack``, 3840 rows) at n = 84 (the narrow kernel) and 96,
    192, 384 (the wide route): P_new within 1e-4 of the chain's order in
    f64 (``joseph_p_new``), scaled by P_new's diagonal, where f32 allows
    it; at 192 and 384 the unfused chain in f32 itself parts from f64 by
    more than 1e-4 (scripts/joseph_order.py), and the kernel is held to
    twice the plain version's distance on the card there."""
    from rvio_tpu_torch.ops.checks import (ekf_tail_stack, joseph_p_new,
                                           scaled_cov_err)
    from rvio_tpu_torch.ops.ekf_tail import ekf_tail, ekf_tail_plain
    C, b, P, sig2 = (torch.as_tensor(np.asarray(x)) for x in ekf_tail_stack(
        np.random.default_rng(seed), n // 6, 3840))
    ref = joseph_p_new(*(x.double() for x in (C, b, P, sig2)), True).numpy()
    args = [x[None].to(cuda) for x in (C, b, P, sig2)]
    got = scaled_cov_err(ekf_tail(*args)[1][0].double().cpu().numpy(), ref)
    plain = scaled_cov_err(ekf_tail_plain(*args)[1][0].double().cpu().numpy(),
                           ref)
    limit = 1e-4 if n <= 96 else max(1e-4, 2 * plain)
    assert got <= limit, (got, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [96, 192])
def test_ekf_tail_wide_route_wider_ridge(cuda, n):
    """The wide route takes the wider ridge where the plain version does,
    in the one entry that needs it, and with the 1e-8 ridge elsewhere."""
    from rvio_tpu_torch.ops.checks import ekf_tail_fallback_inputs
    rng = np.random.default_rng(n)
    cases = [_tail_inputs(rng, n), ekf_tail_fallback_inputs(rng, n=n),
             _tail_inputs(rng, n)]
    fb = _tail_against_plain(cuda, cases)
    assert fb.tolist() == [False, True, False]


@pytest.mark.gpu
def test_ekf_tail_wide_route_nan(cuda):
    """Where even the wider ridge fails (C with a large negative
    eigenvalue), dx and P_new are NaN, as in the plain version; where S's
    factorization fails (sig2 negative beyond S), too."""
    from rvio_tpu_torch.ops.ekf_tail import ekf_tail, ekf_tail_plain
    rng = np.random.default_rng(11)
    n = 96
    C, b, P, s2 = _tail_inputs(rng, n)
    bad_c = C - 10 * np.float32(np.trace(C)) * np.eye(n, dtype=np.float32)
    cases = [(bad_c, b, P, s2), (C, b, P, np.float32(-1e6))]
    args = [torch.as_tensor(np.stack(x), device=cuda) for x in zip(*cases)]
    got, want = ekf_tail(*args), ekf_tail_plain(*args)
    torch.cuda.synchronize()
    assert got[2].tolist() == want[2].tolist() == [True, False]
    for g, w in zip(got[:2], want[:2]):
        assert bool(torch.isnan(w).all()) and bool(torch.isnan(g).all())


@pytest.mark.gpu
def test_ekf_tail_wide_route_clusters(cuda):
    """The wide route's clusters: some fit the card at once, at every n."""
    from rvio_tpu_torch.ops.ekf_tail import max_active_clusters
    for n in (96, 384):
        assert max_active_clusters(16, n, cuda) >= 8


@pytest.mark.gpu
@pytest.mark.parametrize("L", [2, 15, 40])
def test_lm_triangulate_lengths(cuda, L):
    """K2 (a warp per feature) at track lengths below, at and above a warp
    (L = 40 keeps a second measurement in some lanes), F = 37 (not a
    multiple of the four warps of a block), tracks of length 2 beside
    full ones: ok flags identical and phi, psi, rho within 1e-4 of the
    plain version where ok (the tolerance of ops/checks.py)."""
    from rvio_tpu_torch.config import RVIOConfig
    from rvio_tpu_torch.ops.checks import _feature_geometry
    from rvio_tpu_torch.ops.lm_triangulate import (lm_triangulate,
                                                   lm_triangulate_plain)
    cfg = RVIOConfig()
    F = 37
    rng = np.random.default_rng(L)
    _, _, Rc, tc, _, z = _feature_geometry(cfg, rng, F, L)
    tl = np.where(np.arange(F) % 3 == 0, 2, L)
    tl[1::3] = rng.integers(2, L + 1, size=len(tl[1::3]))
    args = [torch.as_tensor(np.asarray(x, np.float32), device=cuda)
            for x in (z, Rc, tc)] + [torch.as_tensor(tl, device=cuda)]
    kw = dict(sigma_im=cfg.camera.sigma_image)
    before = lm_triangulate.launches
    got = lm_triangulate(*args, **kw)
    assert lm_triangulate.launches == before + 1
    want = lm_triangulate_plain(*args, **kw)
    ok = want[3]
    assert torch.equal(got[3], ok) and bool(ok.any())
    for x, y in zip(got[:3], want[:3]):
        assert float((x - y).abs()[ok].max()) <= 1e-4


def _k1_stream(rng, dte):
    """One stream's K1 inputs (numpy) for the sample steps ``dte``: the
    draws of ops/checks.py's case, R0 != I, one small-angle sample."""
    from rvio_tpu_torch.core.so3 import rodrigues_np
    K = len(dte)
    A = rng.normal(size=(24, 24)) * 0.01
    ax = rng.normal(size=3)
    w = rng.normal(size=(K, 3)) * 0.4
    w[1] = 1e-8
    a = rng.normal(size=(K, 3)) * 2.0 + [0, 0, 9.8]
    g = np.array([0.05, -0.02, 0.998])
    return [w, a, dte, rodrigues_np(ax / np.linalg.norm(ax), 1.0),
            rng.normal(size=3), g / np.linalg.norm(g),
            rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.05,
            A @ A.T + np.eye(24) * 1e-4]


def _k1_check(cuda, streams):
    from rvio_tpu_torch.config import RVIOConfig
    from rvio_tpu_torch.ops.checks import propagate_case
    chk = propagate_case(RVIOConfig(), cuda,
                         [np.stack(x) for x in zip(*streams)])
    before = chk.kernel.launches
    chk.check()                    # the check's 1e-5, P relative to max|P|
    torch.cuda.synchronize()
    assert chk.kernel.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("n_valid", [0, 1, 7, 11, 16])
def test_propagate_block_trip_counts(cuda, n_valid):
    """K1 runs up to the last sample with dt > 0 (one step when there is
    none) and agrees with the plain version, which runs all 16."""
    dte = np.where(np.arange(16) < n_valid, 0.005, 0.0)
    _k1_check(cuda, [_k1_stream(np.random.default_rng(n_valid), dte)])


@pytest.mark.gpu
@pytest.mark.parametrize("K", [32, 40])
def test_propagate_block_streams(cuda, K):
    """B = 3 streams of K samples (static and dynamic shared memory past
    48 KB; K = 40 past one sample a lane) with 11, 0 and K - 3 valid
    samples, the third with dt = 0 at two samples inside its valid range
    (steps that must run), in one launch."""
    dtes = [np.where(np.arange(K) < n, 0.005, 0.0) for n in (11, 0, K - 3)]
    dtes[2][[3, 20]] = 0.0
    rng = np.random.default_rng(K)
    _k1_check(cuda, [_k1_stream(rng, d) for d in dtes])


@pytest.mark.gpu
def test_propagate_block_refuses_long_blocks(cuda):
    from rvio_tpu_torch.ops.propagate_block import KMAX
    dte = np.full(KMAX + 1, 0.005)
    with pytest.raises(ValueError):
        _k1_check(cuda, [_k1_stream(np.random.default_rng(0), dte)])


def _spd_stack(rng, F, m, bad=None):
    """F symmetric positive definite m x m systems (cond(S) at most about
    400; ops/checks.py ``spd_systems``), lane ``bad`` made indefinite, and
    right-hand sides."""
    from rvio_tpu_torch.ops.checks import spd_systems
    S, r = spd_systems(rng, F, m)
    if bad is not None:
        S[bad] -= 2 * np.abs(np.linalg.eigvalsh(S[bad])).max() * np.eye(m)
    return S, r


def _quadform_against_plain(cuda, m, counts=(1, 3, 100, 257),
                            route="auto"):
    """K4 by ``route`` at order m for F features of ``counts``: within the
    check's rtol 2e-3 of the plain version, one launch a call, and with
    three or more features one indefinite lane, NaN in both and only it."""
    from rvio_tpu_torch.ops.spd_solve import (batched_quadform,
                                              batched_quadform_plain)
    rng = np.random.default_rng(m)
    for F in counts:
        bad = F // 2 if F >= 3 else None
        S, r = (torch.as_tensor(np.asarray(x, np.float32), device=cuda)
                for x in _spd_stack(rng, F, m, bad))
        before = batched_quadform.launches
        got = batched_quadform(S, r, route=route)
        torch.cuda.synchronize()
        assert batched_quadform.launches == before + 1
        want = batched_quadform_plain(S, r)
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert int(nan.sum()) == (bad is not None)
        if bad is not None:
            assert bool(nan[bad])
        rel = ((got - want).abs() / want.abs())[~nan].max()
        assert float(rel) <= 2e-3, (F, float(rel))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 17, 30, 32, 33, 40, 64, 65,
                               66, 96, 97, 128, 129, 130, 160, 161, 224,
                               225, 308, 309, 340])
def test_batched_quadform_orders(cuda, m):
    """K4 at every padded order the dispatch gives it (8, 16, 32 with a
    row a lane; up to 63 with two; the wide instance from 64 at its panel
    edges, S in shared memory as a square up to 224, then as the packed
    triangle, and in a workspace from 309 on the H100), at F = 1, 3, 100
    and 257 features (not all multiples of the four warps a block): within
    the check's rtol 2e-3 of the plain version, and with three or more
    features one indefinite lane, NaN in both and only it."""
    _quadform_against_plain(cuda, m)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["narrow", "wide"])
@pytest.mark.parametrize("m", [1, 2, 31, 32, 33, 34, 40, 62, 64])
def test_batched_quadform_both_instances(cuda, m, route):
    """Both K4 instances asked for at every order the warp instances take
    (the wide one a single partial panel up to 32, two past it), either
    side of the dispatch's seam at 64: the same checks, for the seam's
    timing in chip_smoke.py."""
    _quadform_against_plain(cuda, m, counts=(1, 3, 100), route=route)


@pytest.mark.gpu
def test_batched_quadform_workspace_past_308(cuda):
    """The wide instance keeps S, its panel and r in a block's shared memory
    up to m = 308 on the H100 (232448 bytes a block may opt in to: S as a
    square of stride m | 1 up to 224, then packed) and in the workspace the
    wrapper allocates past it; the warp instances refuse orders past 64."""
    from rvio_tpu_torch.ops.spd_solve import batched_quadform, workspace_floats
    props = torch.cuda.get_device_properties(cuda)
    if getattr(props, "shared_memory_per_block_optin", 232448) == 232448:
        for m in (65, 130, 224, 225, 308, 309, 340, 600):
            assert (workspace_floats(m, cuda) > 0) == (m >= 309), m
    with pytest.raises(ValueError):
        batched_quadform(torch.eye(65, device=cuda)[None].contiguous(),
                         torch.ones(1, 65, device=cuda), route="narrow")


@pytest.mark.gpu
def test_batched_quadform_refuses_large_orders(cuda):
    """Every order m >= 1 runs (the wide instance past 64, its triangle in
    a workspace past a block's shared memory); only m = 0 raises."""
    from rvio_tpu_torch.ops.spd_solve import batched_quadform
    for m, ok in ((0, False), (65, True)):
        S = torch.eye(m, device=cuda)[None].contiguous()
        r = torch.ones(1, m, device=cuda)
        if ok:
            assert float(batched_quadform(S, r)[0]) == pytest.approx(m)
        else:
            with pytest.raises(ValueError):
                batched_quadform(S, r)


@pytest.mark.gpu
def test_batched_quadform_no_features(cuda):
    """F = 0: an empty D, and no launch."""
    from rvio_tpu_torch.ops.spd_solve import batched_quadform
    before = batched_quadform.launches
    D = batched_quadform(torch.zeros(0, 30, 30, device=cuda),
                         torch.zeros(0, 30, device=cuda))
    assert D.shape == (0,) and batched_quadform.launches == before


@pytest.mark.gpu
def test_reference_faithful_feature_path_on_card(cuda):
    """The reference-faithful config of tests/test_strict_parity.py
    (sigma_v0 = 0, no bias freeze, no forward-rotated attitude, no FEJ, no
    adaptive noise) through the feature path on the card, where every
    update runs K2 and K5, against the CPU plain path over 100 frames,
    within chip_smoke.py's card-vs-CPU limits (1e-4 m, 1e-5 rad)."""
    from chip_smoke import rotation_gap
    from rvio_tpu_torch.config import (CameraConfig, ImuConfig, InitConfig,
                                       RVIOConfig, TpuConfig, TrackerConfig)
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.ops.ekf_tail import ekf_tail
    from rvio_tpu_torch.ops.lm_triangulate import lm_triangulate
    from rvio_tpu_torch.runtime import SequenceDriver, batches_from_sim
    cfg = RVIOConfig(
        imu=ImuConfig(rate_hz=200.0), camera=CameraConfig(fps=20.0),
        tracker=TrackerConfig(num_features=200, max_tracking_length=15,
                              min_tracking_length=3),
        init=InitConfig(sigma_v0=0.0, freeze_bias_average=False,
                        forward_rotate_attitude=False),
        tpu=TpuConfig(imu_block=16, fej=False, adaptive_noise=False))
    sim = simulate_sequence(cfg, duration=8.0, static_time=1.5,
                            ramp_time=0.6, rotation_lead=0.1, seed=7,
                            n_landmarks=600, meas_noise=0.001, imu_noise=True)
    args = (sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t, batches_from_sim(sim))
    ekf_tail.launches = lm_triangulate.launches = 0
    gpu = SequenceDriver(cfg, dtype=torch.float32, device=cuda).run(*args)
    n = len(gpu.timestamps)
    assert n >= 100 and ekf_tail.launches == lm_triangulate.launches == n
    k_end = int(np.searchsorted(sim.frame_t, gpu.timestamps[99])) + 1
    cpu = SequenceDriver(cfg, dtype=torch.float32, device="cpu").run(
        sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t[:k_end],
        batches_from_sim(sim)[:k_end])
    assert len(cpu.timestamps) == 100
    np.testing.assert_array_equal(cpu.timestamps, gpu.timestamps[:100])
    assert gpu.n_good[40:100].mean() > 4
    dp = float(np.abs(cpu.positions - gpu.positions[:100]).max())
    dq = rotation_gap(cpu.quaternions, gpu.quaternions[:100])
    assert dp < 1e-4 and dq < 1e-5, (dp, dq)


# --- K8 (one LK level) and K6 (the KLT tile gather) ---------------------------

_LK_FRAMES = {}


def _lk_frame(shift=(3.3, -2.1), noise=0.0):
    """A 752 x 480 textured frame and the next one moved by ``shift`` px
    (plus Gaussian noise of ``noise`` gray), f32 on the CPU; cached."""
    key = (shift, noise)
    if key not in _LK_FRAMES:
        from rvio_tpu_torch.config import RVIOConfig
        from rvio_tpu_torch.ops.checks import _frame_pair
        rng = np.random.default_rng(11)
        img1, img2, _ = _frame_pair(RVIOConfig(), rng, shift=shift)
        if noise:
            img2 = img2 + torch.as_tensor(rng.normal(0, noise, img2.shape),
                                          dtype=torch.float32)
        _LK_FRAMES[key] = (img1, img2)
    return _LK_FRAMES[key]


def _lk_kwargs(win, max_iters=30, last=True, hw=(480, 752)):
    from rvio_tpu_torch.frontend.klt import TILE
    return dict(win=win, max_iters=max_iters, eps=1e-2, min_eig=1e-3,
                wander=float(TILE - win) / 2.0 - 1.0, last=last, hw=hw)


def _lk_against_plain(cuda, args, kw):
    """K8 on ``args`` (CPU tensors) against its plain version on the card,
    under ops/checks.py's tolerances, on the features where the function
    is well posed in f32: its plain version in f32 keeps the f64 status
    and lands within a quarter of the 1e-3 px tolerance of the f64 result
    (CPU).  A feature that oscillates through all its trips parts by more
    than that between any two f32 summation orders (at win 5 and 30 trips
    the plain f32 and f64 part by up to 0.14 px); at most a tenth of the
    features live in f64 are set aside (the most, 7 of 96, at win 5 with
    templates at the tile edges).  One launch.  Returns both outputs."""
    from rvio_tpu_torch.ops.checks import compare_lk, lk_well_posed
    from rvio_tpu_torch.ops.klt_iterate import lk_level, lk_level_plain
    posed = lk_well_posed(args, kw)
    args = tuple(x.to(cuda) for x in args)
    before = lk_level.launches
    got = lk_level(*args, **kw)
    torch.cuda.synchronize()
    assert lk_level.launches == before + 1
    want = lk_level_plain(*args, **kw)
    keep = posed.to(cuda)
    compare_lk(tuple(x[keep] for x in got), tuple(x[keep] for x in want))
    return got, want


def _lk_points(rng, N, H=480, W=752, margin=3):
    return np.stack([rng.uniform(margin, W - 1 - margin, N),
                     rng.uniform(margin, H - 1 - margin, N)], -1)


@pytest.mark.gpu
@pytest.mark.parametrize("max_iters", [1, 30])
@pytest.mark.parametrize("win", [5, 7, 15])
@pytest.mark.parametrize("N", [1, 31, 32, 33, 200, 1000])
def test_lk_level_sizes(cuda, N, win, max_iters):
    """K8 at feature counts around a warp and the blocks' four warps, at
    every window the tracker may take (one to eight taps a lane), with one
    trip and with the tracker's 30."""
    from rvio_tpu_torch.ops.checks import lk_inputs
    img1, img2 = _lk_frame()
    args, hw = lk_inputs(img1, img2, _lk_points(np.random.default_rng(N), N),
                         win)
    _lk_against_plain(cuda, args, _lk_kwargs(win, max_iters, hw=hw))


@pytest.mark.gpu
@pytest.mark.parametrize("win", [17, 21, 31])
@pytest.mark.parametrize("N", [1, 33, 200])
def test_lk_level_wide_windows(cuda, N, win):
    """K8 past a 16 x 16 window (a column of the window a lane, win taps
    a lane; at win 31 the wander bound, (32 - win) / 2 - 1, is negative,
    so every feature dies on its first trip, as in the plain version), at
    feature counts below a warp, past it and at the tracker's 200."""
    from rvio_tpu_torch.ops.checks import lk_inputs
    img1, img2 = _lk_frame()
    args, hw = lk_inputs(img1, img2,
                         _lk_points(np.random.default_rng(N + win), N), win)
    got, _ = _lk_against_plain(cuda, args, _lk_kwargs(win, hw=hw))
    if win < 31 and N == 200:
        assert int(got[1].sum()) > 100


@pytest.mark.gpu
@pytest.mark.parametrize("win", [32, 41])
@pytest.mark.parametrize("N", [1, 33, 200])
def test_lk_level_past_31(cuda, N, win):
    """K8 past a 31 x 31 window (its instance without trips): the
    tracker's wander bound, (32 - win) / 2 - 1, is negative, so the plain
    version loses every feature on its first trip.  One launch gives the
    level-entry guesses bitwise, every status false and, at the last
    level, each feature's error within 1e-3 of the plain version's (off
    the last level, zero); with no trip (max_iters 0) the statuses of the
    level's test and the in-bounds test agree as ops/checks.py asks; a
    bound >= 0 past 31 raises; and a 15 x 15 call after them finds its
    ticket at 0."""
    from rvio_tpu_torch.ops.checks import LK_POS_TOL, compare_lk, lk_inputs
    from rvio_tpu_torch.ops.klt_iterate import lk_level, lk_level_plain
    img1, img2 = _lk_frame()
    pts = _lk_points(np.random.default_rng(N + win), N)
    args, hw = lk_inputs(img1, img2, pts, win)
    dev_args = tuple(x.to(cuda) for x in args)
    for last in (True, False):
        kw = _lk_kwargs(win, last=last, hw=hw)
        assert kw["wander"] < 0
        before = lk_level.launches
        got = lk_level(*dev_args, **kw)
        torch.cuda.synchronize()
        assert lk_level.launches == before + 1
        want = lk_level_plain(*dev_args, **kw)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[0].cpu(), args[3])
        assert not bool(got[1].any()) and not bool(want[1].any())
        err = float((got[2] - want[2]).abs().max())
        assert err <= LK_POS_TOL, err
        if last:
            assert float(want[2].abs().max()) > 0
        else:
            assert not bool(got[2].any())
    kw = _lk_kwargs(win, max_iters=0, hw=hw)
    compare_lk(lk_level(*dev_args, **kw), lk_level_plain(*dev_args, **kw))
    with pytest.raises(ValueError):
        lk_level(*dev_args, **dict(kw, wander=0.5))
    args, hw = lk_inputs(img1, img2, pts, 15)
    _lk_against_plain(cuda, args, _lk_kwargs(15, hw=hw))


@pytest.mark.gpu
@pytest.mark.parametrize("last", [False, True])
def test_lk_level_last(cuda, last):
    """The last level's in-bounds test and error on (``hw`` set, points
    reaching the image border) and off (err zero)."""
    from rvio_tpu_torch.ops.checks import lk_inputs
    img1, img2 = _lk_frame()
    args, hw = lk_inputs(img1, img2, _lk_points(np.random.default_rng(5), 200,
                                                margin=0.5), 15)
    got, _ = _lk_against_plain(cuda, args, _lk_kwargs(15, last=last, hw=hw))
    if not last:
        assert not bool(got[2].any())


@pytest.mark.gpu
def test_lk_level_all_dead(cuda):
    """Every status false: no feature moves or lives."""
    from rvio_tpu_torch.ops.checks import lk_inputs
    img1, img2 = _lk_frame()
    args, hw = lk_inputs(img1, img2, _lk_points(np.random.default_rng(6), 200),
                         15)
    args = args[:5] + (torch.zeros(200, dtype=torch.bool),)
    got, _ = _lk_against_plain(cuda, args, _lk_kwargs(15, hw=hw))
    assert not bool(got[1].any())
    assert torch.equal(got[0].cpu(), args[3])


@pytest.mark.gpu
@pytest.mark.parametrize("win", [5, 15])
def test_lk_level_tile_edges(cuda, win):
    """Template centres within 2 px of each tile edge (taps clip one by
    one), guesses near the search tiles' edges."""
    from rvio_tpu_torch.frontend.klt import TILE, TILE_H
    from rvio_tpu_torch.ops.checks import lk_inputs
    img1, img2 = _lk_frame()
    rng = np.random.default_rng(win)
    args, hw = lk_inputs(img1, img2, _lk_points(rng, 200, margin=40), win)
    t_tiles, n_tiles, loc0, g_init, o1, status = args
    N = 200
    side = np.arange(N) % 4
    near = rng.uniform(0, 2, N)
    ly = np.where(side == 0, near, np.where(side == 1, TILE_H - 1 - near,
                                            rng.uniform(0, TILE_H - 1, N)))
    lx = np.where(side == 2, near, np.where(side == 3, TILE - 1 - near,
                                            rng.uniform(0, TILE - 1, N)))
    loc0 = torch.as_tensor(np.stack([lx, ly], -1), dtype=torch.float32)
    g_init = o1.float() + loc0 + torch.as_tensor(
        rng.uniform(-1, 1, (N, 2)), dtype=torch.float32)
    _lk_against_plain(cuda, (t_tiles, n_tiles, loc0, g_init, o1, status),
                      _lk_kwargs(win, hw=hw))


@pytest.mark.gpu
def test_lk_level_finish_rule(cuda):
    """The finish's T rule: one feature converges at trip 2 and another
    runs all 30 in the same call, so T = 30 and the first is tested
    against the wander bound once more; picked from a noisy pair by the
    plain version, the 30-trip one where f32 and f64 agree best."""
    from rvio_tpu_torch.ops.checks import lk_inputs
    from rvio_tpu_torch.ops.klt_iterate import lk_level_trips
    img1, img2 = _lk_frame(shift=(0.4, -0.3), noise=60.0)
    rng = np.random.default_rng(3)
    args, hw = lk_inputs(img1, img2, _lk_points(rng, 1000, margin=20), 15)
    kw = _lk_kwargs(15, hw=hw)
    g, alive, _, trips = lk_level_trips(*args, **kw)
    g64 = lk_level_trips(*(x.double() if x.is_floating_point() else x
                           for x in args), **kw)[0]
    two = np.flatnonzero((trips == 2).numpy() & alive.numpy())
    full = np.flatnonzero((trips == 30).numpy() & alive.numpy())
    assert len(two) and len(full)
    gap = (g64 - g.double()).abs().max(dim=1).values.numpy()
    pick = [int(two[0]), int(full[np.argmin(gap[full])])]
    sub = tuple(x[pick].contiguous() for x in args)
    t = lk_level_trips(*sub, **kw)[3]
    assert t.tolist() == [2, 30]
    got, _ = _lk_against_plain(cuda, sub, kw)
    assert bool(got[1].all())


def _lk_case_on(cuda, seed=7):
    from rvio_tpu_torch.ops.checks import lk_inputs
    img1, img2 = _lk_frame()
    args, hw = lk_inputs(img1, img2,
                         _lk_points(np.random.default_rng(seed), 200), 15)
    return tuple(x.to(cuda) for x in args), _lk_kwargs(15, hw=hw)


@pytest.mark.gpu
def test_lk_level_graph_replays(cuda):
    """A CUDA graph of the call replayed three times gives the eager
    call's outputs each time: the finish ticket is back at 0 after every
    launch."""
    from rvio_tpu_torch.ops.klt_iterate import lk_level
    args, kw = _lk_case_on(cuda)
    want = lk_level(*args, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lk_level(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lk_level(*args, **kw)
    for _ in range(3):
        for o in out:
            o.fill_(0)
        graph.replay()
        torch.cuda.synchronize()
        for x, y in zip(out, want):
            assert torch.equal(x, y)


@pytest.mark.gpu
def test_lk_level_two_streams(cuda):
    """Calls on two streams at once (each stream its own ticket) give the
    outputs of the same calls on one stream."""
    from rvio_tpu_torch.ops.klt_iterate import lk_level
    cases = [_lk_case_on(cuda, seed) for seed in (7, 8)]
    want = [lk_level(*a, **kw) for a, kw in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(20):
        for k, (s, (a, kw)) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(s):
                got[k].append(lk_level(*a, **kw))
    torch.cuda.synchronize()
    for k in range(2):
        for outs in got[k]:
            for x, y in zip(outs, want[k]):
                assert torch.equal(x, y)


@pytest.mark.gpu
def test_lk_level_refuses(cuda):
    """What K8 does not take raises: a tile of pixels not a multiple of 4,
    tiles off a 16-byte boundary."""
    from rvio_tpu_torch.ops.klt_iterate import lk_level
    args, kw = _lk_case_on(cuda)
    t, n = (x[:, :39, :31].contiguous() for x in args[:2])
    with pytest.raises(ValueError):
        lk_level(t, n, *args[2:], **kw)
    flat = torch.empty(200 * 1280 + 1, device=cuda)
    t = flat[1:].view(200, 40, 32)
    t.copy_(args[0])
    with pytest.raises(ValueError):
        lk_level(t, *args[1:], **kw)


_PYRAMID = [(480, 752), (240, 376), (120, 188), (60, 94)]


def _gather_against_plain(cuda, H, W, N, th=40, tw=32, seed=0):
    from rvio_tpu_torch.ops.tile_gather import gather_tiles, gather_tiles_plain
    rng = np.random.default_rng(seed)
    img = torch.as_tensor(rng.uniform(0, 255, (H, W)), dtype=torch.float32,
                          device=cuda)
    # origins past every side of the image, and inside it
    o = torch.as_tensor(np.stack([rng.integers(-60, W + 60, N),
                                  rng.integers(-60, H + 60, N)], -1),
                        dtype=torch.int32, device=cuda)
    before = gather_tiles.launches
    got = gather_tiles(img, o, th, tw)
    torch.cuda.synchronize()
    assert gather_tiles.launches == before + 1
    assert got.shape == (N, th, tw)
    assert torch.equal(got, gather_tiles_plain(img, o, th, tw))


@pytest.mark.gpu
@pytest.mark.parametrize("hw", _PYRAMID + [(30, 40), (24, 20)])
@pytest.mark.parametrize("N", [0, 1, 200, 1000])
def test_gather_tiles_levels(cuda, N, hw):
    """K6 bitwise at every pyramid level of RVIOConfig() and on images
    smaller than the 40 x 32 tile (the edge-clamped path), origins out of
    bounds on every side."""
    _gather_against_plain(cuda, *hw, N, seed=N)


@pytest.mark.gpu
@pytest.mark.parametrize("th,tw", [(17, 24), (40, 64), (8, 8), (40, 33)])
def test_gather_tiles_other_shapes(cuda, th, tw):
    """Tiles other than 40 x 32 take the generic instantiation."""
    for hw in ((480, 752), (30, 20)):
        _gather_against_plain(cuda, *hw, 200, th, tw, seed=th * tw)


# ---- K10: the CLAHE LUTs (a cluster of CTAs a tile) ----

def _clahe_frame(H, W, seed=0):
    from rvio_tpu_torch.ops.checks import _checker_frame
    return _checker_frame(np.random.default_rng(seed), H, W)


def _clahe_exact_excess(img, clip, g=5):
    """The plain version's LUTs with each tile's excess summed exactly (in
    f64, then rounded to f32 once) where the plain version sums it in f32,
    and the tiles whose f32 sum is that exact one."""
    from rvio_tpu_torch.ops.clahe import (clahe_hist_plain, clip_limit_count,
                                          tile_shape)
    th, tw = tile_shape(*img.shape, g)
    area = th * tw
    hist = clahe_hist_plain(img, g).float()
    clipped = torch.clamp(hist, max=clip_limit_count(clip, area))
    terms = hist - clipped
    excess = terms.double().sum(dim=1, keepdim=True).float()
    exact = (terms.sum(dim=1, keepdim=True) == excess)[:, 0]
    cdf = torch.cumsum(clipped + excess / 256, dim=1)
    return (cdf * (255.0 / area)).to(torch.bfloat16).float(), exact


def _clahe_against_plain(cuda, img, clip):
    """K10's LUTs and histograms on the card against the plain versions on
    the CPU, one launch each (LUTs; LUTs and histograms): the histograms
    exact; the LUTs bitwise those of the plain version with the excess
    summed exactly, and bitwise the plain version's own on every tile whose
    f32 excess sum is exact (every tile on the clip limit's grid,
    cdf_any_order; off it the plain version's f32 sum may round, in an
    order the CPU's vector width sets)."""
    from rvio_tpu_torch.ops.clahe import (_luts_and_hist, cdf_any_order,
                                          clahe_hist_plain, clahe_luts,
                                          clahe_luts_plain, clip_limit_count,
                                          tile_shape)
    before = clahe_luts.launches
    luts = clahe_luts(img.to(cuda), clip)
    luts2, hist = _luts_and_hist(img.to(cuda), clip)
    torch.cuda.synchronize()
    assert clahe_luts.launches == before + 2
    assert torch.equal(hist.cpu().long(), clahe_hist_plain(img))
    assert torch.equal(luts.cpu(), luts2.cpu())
    ref, exact = _clahe_exact_excess(img, clip)
    th, tw = tile_shape(*img.shape, 5)
    if cdf_any_order(clip_limit_count(clip, th * tw), th * tw):
        assert bool(exact.all())
    assert torch.equal(luts.cpu(), ref)
    want = clahe_luts_plain(img, clip)
    assert torch.equal(luts.cpu()[exact], want[exact])
    return int(exact.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("clip", [3.0, 2.7])
@pytest.mark.parametrize("hw", [(480, 752), (440, 750), (750, 440),
                                (240, 320), (120, 130), (130, 120),
                                (20, 1400)])
def test_clahe_luts_sizes_and_limits(cuda, hw, clip):
    """K10 at RVIOConfig()'s frame, the CLAHE tests' 440 x 750 and 120 x
    130 frames and their transposes (tiles of 88 columns: two row phases
    a CTA; tiles of 24 and 26 rows: bands of 2-4 rows, and at 26 a CTA
    with none), the small config's 320 x 240, and tiles of 4 x 280 (two
    column passes a thread, half the cluster without a band); at clip 3.0
    (on the grid everywhere: the parallel scan) and 2.7 (off it at 752 x
    480, 320 x 240 and 120 x 130: the bin-order scan)."""
    from rvio_tpu_torch.ops.clahe import (cdf_any_order, clip_limit_count,
                                          tile_shape)
    th, tw = tile_shape(*hw, 5)
    any_order = cdf_any_order(clip_limit_count(clip, th * tw), th * tw)
    assert any_order == (clip == 3.0 or th * tw in (13200, 1120))
    _clahe_against_plain(cuda, _clahe_frame(*hw, seed=hw[0]), clip)


@pytest.mark.gpu
@pytest.mark.parametrize("clip", [3.0, 2.7])
def test_clahe_luts_constant_frame(cuda, clip):
    """Every pixel in one bin (every lane's run one atomic on one address,
    and one bin clipped holding the whole excess), and a frame of random
    bins (runs of one pixel)."""
    _clahe_against_plain(cuda, torch.full((480, 752), 77.3), clip)
    rng = np.random.default_rng(1)
    _clahe_against_plain(cuda, torch.as_tensor(
        rng.uniform(-20, 280, (480, 752)), dtype=torch.float32), clip)


@pytest.mark.gpu
def test_clahe_luts_graph_replays(cuda):
    """A CUDA graph of the call replayed three times gives the eager
    call's LUTs each time (the kernel keeps no state between launches)."""
    from rvio_tpu_torch.ops.clahe import clahe_luts
    img = _clahe_frame(480, 752).to(cuda)
    want = clahe_luts(img)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        clahe_luts(img)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = clahe_luts(img)
    for _ in range(3):
        out.fill_(0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


# ---- K3: per-feature Jacobians and the nullspace projection ----

def _jac_against_plain(cuda, inputs, route="auto"):
    """K3 by ``route`` on ``inputs`` (ops/checks.jac_inputs) against its
    plain version at the check's tolerances, one launch (none for F = 0)."""
    from rvio_tpu_torch.ops.checks import jac_case
    chk = jac_case(cuda, inputs)
    before = chk.kernel.launches
    got = chk.kernel(*chk.args, route=route)
    torch.cuda.synchronize()
    F = inputs[0].shape[0]
    assert chk.kernel.launches == before + (F > 0)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    chk.compare(got, chk.run_plain())
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("L", [2, 15, 16, 17, 33, 64, 65, 100, 128])
@pytest.mark.parametrize("F", [0, 1, 100, 200])
def test_jac_project_lengths_and_counts(cuda, L, F):
    """K3 by the route the length takes (L <= 16: 32 rows in registers;
    past 16 the wide kernel, any L), at the edges of both and past them,
    for F features with t_eff = 2 and t_eff = L in turn
    and c0 at 0 and at M - t_eff + 1 in turn (a window of M = L - 1
    clones, as RVIOConfig() has it)."""
    from rvio_tpu_torch.config import RVIOConfig
    from rvio_tpu_torch.ops.checks import jac_inputs
    M = max(L - 1, 2)
    t_eff = np.where(np.arange(F) % 2 == 0, 2, L)
    c0 = np.where(np.arange(F) % 4 < 2, 0, M - t_eff + 1)
    _jac_against_plain(cuda, jac_inputs(RVIOConfig(), np.random.default_rng(L),
                                        F, L, M, t_eff, c0))


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["narrow", "wide"])
@pytest.mark.parametrize("L", [2, 15, 16, 17, 20, 33, 64])
def test_jac_project_both_routes(cuda, L, route):
    """Both K3 kernels at the lengths the dispatch splits (the compiled row
    bounds, 32 and 128 rows, and the wide kernel asked for), as
    test_jac_project_lengths_and_counts holds the dispatched one: 100
    features, t_eff = 2 and L, c0 at both ends of the window."""
    from rvio_tpu_torch.config import RVIOConfig
    from rvio_tpu_torch.ops.checks import jac_inputs
    F, M = 100, max(L - 1, 2)
    t_eff = np.where(np.arange(F) % 2 == 0, 2, L)
    c0 = np.where(np.arange(F) % 4 < 2, 0, M - t_eff + 1)
    _jac_against_plain(cuda, jac_inputs(RVIOConfig(), np.random.default_rng(L),
                                        F, L, M, t_eff, c0), route=route)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [15, 40])
def test_jac_project_rank_two_feature(cuda, L):
    """A feature seen from one camera centre (tc = 0 at the linearization
    point: ||Hf[:, rho]|| = 0 < 1e-4, so Ncols = 2) beside ordinary ones;
    and a feature with fewer than two measurements (every row masked)."""
    from rvio_tpu_torch.config import RVIOConfig
    from rvio_tpu_torch.ops.checks import jac_inputs
    F, M = 9, 14
    t_eff = np.full(F, min(L, 15))
    c0 = np.zeros(F, np.int64)
    t_eff[5] = 1
    inputs = jac_inputs(RVIOConfig(), np.random.default_rng(3), F, L, M,
                        t_eff, c0)
    inputs[2] = inputs[2].copy()
    inputs[2][3] = 0.0
    r, Hx, hfn = _jac_against_plain(cuda, inputs)
    assert float(hfn[3]) < 1e-4 and float(hfn.max()) > 1e-4
    assert float(r[3, 2].abs()) > 0 and float(Hx[5].abs().max()) == 0.0


# ---- K9: cornerSubPix refinement; K13 and K12: the Shi-Tomasi response ----

def _subpix_inputs(N, seed, flat=False):
    """Tiles, origins and corners on the K8 tests' 752 x 480 frame: a third
    of the corners within 2 px of an image border (their tiles clamped),
    the rest anywhere; with ``flat`` every tile's pixels one value (no
    gradient: det = 0, no step)."""
    from rvio_tpu_torch.frontend.klt import TILE, TILE_H, tile_origins
    from rvio_tpu_torch.ops.tile_gather import gather_tiles_plain
    img, _ = _lk_frame()
    H, W = img.shape
    rng = np.random.default_rng(seed)
    p = np.stack([rng.uniform(0, W - 1, N), rng.uniform(0, H - 1, N)], -1)
    near = np.arange(N) % 3 == 0
    side, d = rng.integers(0, 4, N), rng.uniform(0, 2, N)
    for s, (axis, edge) in enumerate(((0, 0), (0, W - 1), (1, 0),
                                      (1, H - 1))):
        on = near & (side == s)
        p[on, axis] = abs(edge - d[on])
    pts = torch.as_tensor(p, dtype=torch.float32)
    o = tile_origins(pts, H, W)
    tiles = gather_tiles_plain(img, o, TILE_H, TILE)
    if flat:
        tiles = torch.full_like(tiles, 91.5)
    return tiles, o, pts


def _subpix_against_plain(cuda, tiles, o, pts, win, iters):
    """K9 against its plain version on the card under ops/checks.py's
    1e-3 px, on the corners where the function is well posed in f32: its
    plain version in f32 lands within a quarter of the tolerance of the
    f64 result (CPU).  At random points of a smooth texture the structure
    tensor can be near singular, and there any two f32 orders part (up to
    2 px at win 7 in the plain version itself); at most a tenth of the
    corners are set aside.  One launch (none for N = 0)."""
    from rvio_tpu_torch.ops.checks import subpix_case
    from rvio_tpu_torch.ops.klt_iterate import subpix_refine_plain
    kw = dict(win=win, iters=iters)
    p32 = subpix_refine_plain(tiles, o, pts, **kw)
    p64 = subpix_refine_plain(tiles.double(), o, pts.double(), **kw)
    posed = (p32.double() - p64).abs().amax(dim=1) <= 2.5e-4
    assert int((~posed).sum()) <= 0.1 * max(len(pts), 1)
    chk = subpix_case(cuda, tiles, o, pts, win, iters)
    before = chk.kernel.launches
    got = chk.run_kernel()
    torch.cuda.synchronize()
    assert chk.kernel.launches == before + (len(pts) > 0)
    assert got.shape == pts.shape and bool(torch.isfinite(got).all())
    keep = posed.to(cuda)
    chk.compare(got[keep], chk.run_plain()[keep])
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("iters", [0, 1, 10])
@pytest.mark.parametrize("win", [3, 5, 7])
@pytest.mark.parametrize("N", [1, 31, 32, 33, 200, 400])
def test_subpix_refine_sizes(cuda, N, win, iters):
    """K9 at corner counts around a warp and past the tracker's 200, every
    window the tracker's min distances give, no iteration, one and the
    tracker's ten; corners within 2 px of the image border among them."""
    got = _subpix_against_plain(cuda, *_subpix_inputs(N, N), win, iters)
    if iters == 0:
        assert torch.equal(got.cpu(), _subpix_inputs(N, N)[2])


@pytest.mark.gpu
def test_subpix_refine_flat_patch(cuda):
    """Flat tiles: every system's det is 0 (<= 1e-12), so no corner moves."""
    tiles, o, pts = _subpix_inputs(64, 3, flat=True)
    got = _subpix_against_plain(cuda, tiles, o, pts, 7, 10)
    assert torch.equal(got.cpu(), pts)


@pytest.mark.gpu
def test_subpix_refine_odd_tiles(cuda):
    """Tiles that are not one bulk copy (39 x 31: TH * TW % 4 != 0) are
    read by the threads; the same function."""
    tiles, o, pts = _subpix_inputs(64, 5)
    tiles = tiles[:, :39, :31].contiguous()
    _subpix_against_plain(cuda, tiles, o, pts, 7, 10)


@pytest.mark.gpu
def test_subpix_refine_no_corners(cuda):
    """N = 0 launches nothing and counts nothing."""
    from rvio_tpu_torch.ops.klt_iterate import subpix_refine
    before = subpix_refine.launches
    out = subpix_refine(torch.empty((0, 40, 32), device=cuda),
                        torch.empty((0, 2), dtype=torch.int32, device=cuda),
                        torch.empty((0, 2), device=cuda))
    torch.cuda.synchronize()
    assert out.shape == (0, 2) and subpix_refine.launches == before


_SHI_SIZES = [(5, 5), (37, 41), (60, 94), (480, 752), (481, 753)]


def _shi_image(case, cuda):
    if case == "constant":
        return torch.full((480, 752), 77.3, device=cuda)
    from rvio_tpu_torch.ops.checks import _texture
    H, W = case
    return _texture(np.random.default_rng(H), H, W, passes=1).float().to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("case", _SHI_SIZES + ["constant"])
def test_shi_tomasi_nms_bitwise(cuda, case):
    """K13 bitwise with its plain version on the card: the strips' edges
    at sizes that are and are not multiples of them, the 5 x 5 least, and
    a constant image (a zero response everywhere, every pixel a tie)."""
    from rvio_tpu_torch.ops.shi_tomasi import (shi_tomasi_nms,
                                               shi_tomasi_nms_plain)
    img = _shi_image(case, cuda)
    before = shi_tomasi_nms.launches
    got = shi_tomasi_nms(img)
    torch.cuda.synchronize()
    assert shi_tomasi_nms.launches == before + 1
    want = shi_tomasi_nms_plain(img)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("case", _SHI_SIZES + ["constant"])
def test_shi_tomasi_response_bitwise(cuda, case):
    """K12 (K13's strip kernel without its NMS stage, 28 columns a strip)
    bitwise with its plain version on the card: widths that are no
    multiple of 4, heights that are no multiple of its rows, the 5 x 5
    least."""
    from rvio_tpu_torch.ops.shi_tomasi import shi_tomasi, shi_tomasi_response
    img = _shi_image(case, cuda)
    got = shi_tomasi(img)
    torch.cuda.synchronize()
    want = shi_tomasi_response(img)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _graph_replays(fn, *args):
    """A CUDA graph of ``fn(*args)`` replayed three times gives the eager
    call's output each time."""
    want = fn(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    for _ in range(3):
        out.fill_(0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.gpu
def test_subpix_refine_graph_replays(cuda):
    """K9 in a replayed CUDA graph: the mbarrier is set up anew each
    launch."""
    from rvio_tpu_torch.ops.klt_iterate import subpix_refine
    tiles, o, pts = (x.to(cuda) for x in _subpix_inputs(200, 7))
    _graph_replays(subpix_refine, tiles, o, pts)


@pytest.mark.gpu
def test_shi_tomasi_nms_graph_replays(cuda):
    from rvio_tpu_torch.ops.shi_tomasi import shi_tomasi_nms
    _graph_replays(shi_tomasi_nms, _shi_image((480, 752), cuda))


def _two_streams(fn, cases):
    """``fn`` on each case's args, 20 times on each of two streams at once,
    gives the eager call's output each time."""
    want = [fn(*args) for args in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(20):
        for k, (s, args) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(s):
                got[k].append(fn(*args))
    torch.cuda.synchronize()
    for k in range(2):
        for out in got[k]:
            assert torch.equal(out, want[k])


@pytest.mark.gpu
def test_shi_tomasi_graph_replays(cuda):
    from rvio_tpu_torch.ops.shi_tomasi import shi_tomasi
    _graph_replays(shi_tomasi, _shi_image((481, 753), cuda))


@pytest.mark.gpu
def test_shi_tomasi_two_streams(cuda):
    from rvio_tpu_torch.ops.shi_tomasi import shi_tomasi
    _two_streams(shi_tomasi, [(_shi_image((480, 752), cuda),),
                              (_shi_image((481, 753), cuda),)])


# ---- K11: the CLAHE apply (a block a chunk of a cell) ----

# (H, W, g): the tracker's frame, widths that are no multiple of 4, the
# 5 x 5 least, g = 8 (where the old design needed the shared-memory
# attribute) at two sizes
_K11_SIZES = [(480, 752, 5), (481, 753, 5), (37, 42, 5), (5, 5, 5),
              (480, 752, 8), (61, 95, 8)]


def _k11_case(cuda, H, W, g, seed=0):
    """(image, LUTs) on the card and the plain version's output on the
    CPU; a few pixels outside [0, 255]."""
    from rvio_tpu_torch.ops.clahe import clahe_apply_plain, clahe_luts_plain
    img = _clahe_frame(H, W, seed)
    img[::7, ::5] = torch.linspace(-30.0, 290.5, img[::7, ::5].numel()
                                   ).reshape(img[::7, ::5].shape)
    luts = clahe_luts_plain(img, 3.0, g)
    return img.to(cuda), luts.to(cuda), clahe_apply_plain(img, luts, g)


@pytest.mark.gpu
@pytest.mark.parametrize("hwg", _K11_SIZES)
def test_clahe_apply_bitwise(cuda, hwg):
    """K11 bitwise with its plain version on the CPU, one launch."""
    from rvio_tpu_torch.ops.clahe import clahe_apply
    H, W, g = hwg
    img, luts, want = _k11_case(cuda, H, W, g)
    before = clahe_apply.launches
    got = clahe_apply(img, luts, g)
    torch.cuda.synchronize()
    assert clahe_apply.launches == before + 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_clahe_apply_unaligned(cuda):
    """An image and an output 4 bytes off a 16-byte boundary (W % 4 == 0:
    the quads by four loads) give the aligned call's pixels."""
    from rvio_tpu_torch.ops.clahe import clahe_apply
    img, luts, want = _k11_case(cuda, 480, 752, 5)
    flat = torch.empty(img.numel() + 1, device=cuda)
    flat[1:] = img.reshape(-1)
    got = clahe_apply(flat[1:].view(480, 752), luts, 5)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_clahe_apply_graph_replays(cuda):
    from rvio_tpu_torch.ops.clahe import clahe_apply
    img, luts, _ = _k11_case(cuda, 480, 752, 5)
    _graph_replays(clahe_apply, img, luts, 5)


@pytest.mark.gpu
def test_clahe_apply_two_streams(cuda):
    from rvio_tpu_torch.ops.clahe import clahe_apply
    _two_streams(clahe_apply, [_k11_case(cuda, 480, 752, 5)[:2] + (5,),
                               _k11_case(cuda, 481, 753, 8, seed=1)[:2]
                               + (8,)])


# ---- the one-dispatch frame: graphed scans against the eager frame ----

FILTER_WRAPPERS = ("propagate_block", "lm_triangulate", "jac_project",
                   "batched_quadform", "ekf_tail")


def _wrappers():
    from rvio_tpu_torch.ops import (clahe, ekf_tail, jac_project,
                                    klt_iterate, lm_triangulate,
                                    propagate_block, shi_tomasi, spd_solve,
                                    tile_gather)
    return {w.__name__: w for w in (
        propagate_block.propagate_block, lm_triangulate.lm_triangulate,
        jac_project.jac_project, spd_solve.batched_quadform,
        tile_gather.gather_tiles, klt_iterate.lk_level,
        klt_iterate.subpix_refine, shi_tomasi.shi_tomasi_nms,
        clahe.clahe_luts, clahe.clahe_apply, shi_tomasi.shi_tomasi,
        tile_gather.gather_tiles_aligned, ekf_tail.ekf_tail)}


def _feature_case(cuda):
    """The feature config's first filtered frames on the card: the initial
    state and the stacked bundles."""
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.filter.propagation import pad_imu
    from rvio_tpu_torch.runtime import (InitializationGate, SequenceDriver,
                                        batches_from_sim, bundle_imu)
    cfg = _feature_cfg()
    sim = simulate_sequence(cfg, duration=6.0, static_time=1.2, seed=11,
                            meas_noise=0.0015, imu_noise=True)
    batches = batches_from_sim(sim)
    gate = InitializationGate(cfg, torch.float32, cuda)
    state, rows = None, []
    for k, (w, a, dts) in enumerate(bundle_imu(sim.imu_t, sim.imu_w,
                                               sim.imu_a, sim.frame_t)):
        if len(w) < 2:
            continue
        if state is None:
            state = gate.feed(w, a, dts)
            continue
        b = batches[k]
        rows.append((pad_imu(w, a, dts, cfg.tpu.imu_block),
                     (b.meas, b.track_len, b.is_type2, b.valid)))
    return cfg, state, SequenceDriver(cfg, device=cuda)._stack(rows)


@pytest.mark.gpu
@pytest.mark.parametrize("unroll", [1, 8])
def test_sequence_scan_graph_is_eager(cuda, unroll):
    """The graphed sequence scan gives the eager per-frame step's outputs
    and state bitwise, twice, and each filter kernel launches once a frame
    under replay."""
    from rvio_tpu_torch.runtime import make_filter_step
    from rvio_tpu_torch.runtime.graph import tree_leaves
    from rvio_tpu_torch.runtime.step import _sequence_scan
    cfg, state0, bundles = _feature_case(cuda)
    T = bundles.imu.w.shape[0]
    step = make_filter_step(cfg, cuda)
    state, rows = state0, []
    for t in range(T):
        state, out = step(state, bundles.frame(t))
        rows.append(out)
    eager = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    run = _sequence_scan(cfg, cuda, torch.float32, unroll)
    wrappers = _wrappers()
    for _ in range(2):
        for w in wrappers.values():
            w.launches = 0
        final, got = run(state0, bundles)
        torch.cuda.synchronize()
        assert {k: wrappers[k].launches for k in FILTER_WRAPPERS} == \
            dict.fromkeys(FILTER_WRAPPERS, T)
        for k, v in eager.items():
            assert torch.equal(got[k], v), k
        for x, y in zip(tree_leaves(final), tree_leaves(state), strict=True):
            assert torch.equal(x, y)
    caps = run.frame_scan.captures
    assert [c["frames"] for c in caps] == ([unroll, 1] if unroll > 1 and
                                           (T - 1) % unroll else [unroll])


def _image_case(cuda, equalizer, B=6):
    """The small image config's init states on the card and its first B
    frames as a chunk."""
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.dataio.synthetic import render_frame
    from rvio_tpu_torch.frontend import make_tracker
    from rvio_tpu_torch.runtime import bundle_imu
    from rvio_tpu_torch.runtime.image_driver import (_find_init_frame,
                                                     _imu_chunk_arrays)
    cfg = _small_image_cfg(equalizer)
    sim = simulate_sequence(cfg, duration=4.0, static_time=1.0, ramp_time=1.5,
                            seed=6, n_landmarks=400, motion_scale=0.5)
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    fs, k0 = _find_init_frame(cfg, groups, len(sim.frame_t), torch.float32,
                              cuda)
    init_fn, _ = make_tracker(cfg, cuda)

    def u8(k):
        return np.clip(render_frame(cfg, sim, k), 0, 255).astype(np.uint8)

    ts, _ = init_fn(torch.as_tensor(u8(k0)))
    ks = list(range(k0 + 1, k0 + 1 + B))
    ch = _imu_chunk_arrays(groups, ks, cfg.tpu.imu_block, torch.float32, cuda)
    ch["image"] = torch.as_tensor(np.stack([u8(k) for k in ks]), device=cuda)
    ch["u"] = torch.rand(B, cfg.tracker.num_features,
                         generator=torch.Generator().manual_seed(3)).to(cuda)
    return cfg, (ts, fs), ch


def _eager_chunk(cfg, cuda, carry, ch):
    """The chunk frame by frame through the scans' own halves, eagerly."""
    from rvio_tpu_torch.runtime.image_driver import (_filter_outputs,
                                                     _frame_halves,
                                                     _tracker_outputs)
    front, back = _frame_halves(cfg, cuda, torch.float32)
    ts, fs = carry
    rows = []
    for i in range(len(ch["ok"])):
        f = {k: v[i] for k, v in ch.items()}
        ts, batch, dbg = front(ts, f)
        fs, out = back(fs, f, batch)
        rows.append({**_filter_outputs(out, f["ok"]),
                     **_tracker_outputs(ts, dbg)})
    return (ts, fs), {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def _assert_same_carry(a, b):
    from rvio_tpu_torch.runtime.graph import tree_leaves
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert torch.equal(x, y)


def _image_want(n, equalizer):
    eq = n if equalizer else 0
    want = dict.fromkeys(FILTER_WRAPPERS, n)
    want.update(gather_tiles=9 * n, lk_level=4 * n, subpix_refine=n,
                shi_tomasi_nms=n, clahe_luts=eq, clahe_apply=eq, shi_tomasi=0,
                gather_tiles_aligned=0)
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("equalizer", [False, True])
def test_image_chunk_scans_graph_is_eager(cuda, equalizer):
    """The fused chunk scan and the front-end then back-end scans, graphed,
    give the eager frames' outputs and carries bitwise, on two chunks (the
    second replays only), and every kernel launches as often as its frames
    imply under replay."""
    from rvio_tpu_torch.runtime import (make_backend_chunk_scan,
                                        make_frontend_chunk_scan,
                                        make_image_chunk_scan)
    cfg, carry, ch = _image_case(cuda, equalizer)
    want_carry, want = _eager_chunk(cfg, cuda, carry, ch)
    fused = make_image_chunk_scan(cfg, cuda)
    front = make_frontend_chunk_scan(cfg, cuda)
    back = make_backend_chunk_scan(cfg, cuda)
    wrappers = _wrappers()
    B = len(ch["ok"])
    for _ in range(2):
        for w in wrappers.values():
            w.launches = 0
        got_carry, got = fused(carry, ch)
        torch.cuda.synchronize()
        assert {k: w.launches for k, w in wrappers.items()} == \
            _image_want(B, equalizer)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
        _assert_same_carry(got_carry, want_carry)
        ts, fo = front(carry[0], ch)
        fs, bo = back(carry[1], {**{k: ch[k] for k in (
            "imu_w", "imu_a", "imu_dt", "imu_valid", "ok")}, **{
            k: fo[k] for k in ("meas", "track_len", "is_type2", "valid")}})
        torch.cuda.synchronize()
        for k, v in bo.items():
            assert torch.equal(v, want[k]), k
        _assert_same_carry((ts, fs), want_carry)


@pytest.mark.gpu
def test_k8_graphs_in_turn_on_one_stream(cuda):
    """Two graphs that hold K8 (the fused chunk frame and the front-end
    frame), both captured on the graph stream and replayed in turn on it,
    give the eager frames' results each time: they share the stream's
    finish ticket and never run at once."""
    from rvio_tpu_torch.runtime import (make_frontend_chunk_scan,
                                        make_image_chunk_scan)
    cfg, carry, ch = _image_case(cuda, True, B=4)
    want_carry, want = _eager_chunk(cfg, cuda, carry, ch)
    fused = make_image_chunk_scan(cfg, cuda)
    front = make_frontend_chunk_scan(cfg, cuda)
    for _ in range(3):
        got_carry, got = fused(carry, ch)
        ts, fo = front(carry[0], ch)
        torch.cuda.synchronize()
        for k, v in want.items():
            assert torch.equal(got[k], v), k
        for k in ("n_tracked", "n_lost", "n_new", "active"):
            assert torch.equal(fo[k], want[k]), k
        _assert_same_carry(got_carry, want_carry)
        _assert_same_carry(ts, want_carry[0])


@pytest.mark.gpu
def test_pipeline_graphed_outputs_not_aliased(cuda):
    """ImagePipeline.process on the card: each frame's outputs are copies
    that later frames leave alone, and the poses are the CPU pipeline's
    within the card-vs-CPU limit of test_image_driver_launches_every_kernel
    (CLAHE off: with it on the two part near the border at this config,
    ROADMAP.md section 3)."""
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.dataio.synthetic import render_frame
    from rvio_tpu_torch.runtime import ImagePipeline, bundle_imu
    cfg = _small_image_cfg(False)
    sim = simulate_sequence(cfg, duration=4.0, static_time=1.0, ramp_time=1.5,
                            seed=6, n_landmarks=400, motion_scale=0.5)
    groups = bundle_imu(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t)
    pipes = {d: ImagePipeline(cfg, device=d) for d in (cuda, "cpu")}
    outs = {d: [] for d in pipes}
    for k in range(len(sim.frame_t)):
        img = np.clip(render_frame(cfg, sim, k), 0, 255).astype(np.uint8)
        for d, pipe in pipes.items():
            out = pipe.process(sim.frame_t[k], img, *groups[k])
            if out is not None:
                outs[d].append((out, {n: v.clone() for n, v in out.items()}))
    torch.cuda.synchronize()
    assert len(outs[cuda]) == len(outs["cpu"]) > 10
    for out, kept in outs[cuda]:
        for n, v in kept.items():
            assert torch.equal(out[n], v), n
    p = torch.stack([o["p_Gk"] for o, _ in outs[cuda]]).cpu()
    q = torch.stack([o["p_Gk"] for o, _ in outs["cpu"]])
    assert float((p - q).abs().max()) < 1e-3


@pytest.mark.gpu
def test_capture_that_syncs_raises(cuda):
    """A frame body that reads a tensor back to the host runs its first
    (eager) frame, then its capture raises: nothing goes on eagerly."""
    from rvio_tpu_torch.runtime.graph import FrameScan

    def body(carry, f):
        scale = float(f["x"].sum())           # a host sync
        return carry + scale, {"y": carry * 2}

    scan = FrameScan(body, cuda)
    scan.load(torch.zeros(3, device=cuda))
    with pytest.raises(RuntimeError):
        scan.run({"x": torch.ones(4, 2, device=cuda)})
    torch.cuda.synchronize()
    assert scan.captures == []
    assert torch.equal(scan.carry, torch.full((3,), 2.0, device=cuda))
    # the process's later captures still work
    ok = FrameScan(lambda c, f: (c + f["x"].sum(), {"y": c * 2}), cuda)
    ok.load(torch.zeros(3, device=cuda))
    out = ok.run({"x": torch.ones(4, 2, device=cuda)})
    torch.cuda.synchronize()
    assert [c["frames"] for c in ok.captures] == [1]
    assert torch.equal(ok.carry, torch.full((3,), 8.0, device=cuda))
    assert torch.equal(out["y"][:, 0].cpu(), torch.tensor([0.0, 4, 8, 12]))


@pytest.mark.gpu
def test_capture_keeps_the_peak_memory(cuda):
    """A capture leaves the process's peak memory statistics alone (a
    peak set before it, above anything the capture allocates, is still
    the peak after it), records the growth of the reserved bytes, and
    the frame loop's spans count the warm frame, the capture and each
    replay."""
    from rvio_tpu_torch.runtime.graph import FrameScan
    from rvio_tpu_torch.utils import profiling
    big = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    del big
    before = torch.cuda.max_memory_allocated(cuda)
    n0 = {k: profiling.count(f"frame_scan.{k}")
          for k in ("warm", "capture", "replay")}
    scan = FrameScan(lambda c, f: (c + f["x"].sum(), {"y": c * 2}), cuda)
    scan.load(torch.zeros(3, device=cuda))
    scan.run({"x": torch.ones(4, 2, device=cuda)})
    torch.cuda.synchronize()
    assert [c["frames"] for c in scan.captures] == [1]
    assert torch.cuda.max_memory_allocated(cuda) >= before >= 64 << 20
    assert scan.captures[0]["reserved_growth_bytes"] >= 0
    assert {k: profiling.count(f"frame_scan.{k}") - n
            for k, n in n0.items()} == {"warm": 1, "capture": 1,
                                         "replay": 3}


# ---- the segment-batched filter ----

BATCH_NAMES = ["propagate_block", "lm_triangulate", "jac_project",
               "batched_quadform", "ekf_tail"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", BATCH_NAMES)
def test_batch_kernel_matches_plain(cuda, name):
    """K1-K5 at the batched filter's shapes (16 streams, 1600 feature rows,
    16 systems) against their plain versions, one launch each."""
    from rvio_tpu_torch.ops.checks import batch_checks
    chk = {c.name: c for c in batch_checks(cuda)}[name]
    before = chk.kernel.launches
    chk.check()
    torch.cuda.synchronize()
    assert chk.kernel.launches == before + chk.check_launches


def _segments(cuda, seeds=(3, 4, 5)):
    """Three feature sequences on the card, cut to one length: their
    initial states and stacked bundles."""
    from rvio_tpu_torch.bench import feature_bundles
    from rvio_tpu_torch.dataio import simulate_sequence
    cfg = _feature_cfg()
    cfg = cfg.replace(tpu=cfg.tpu.__class__(imu_block=16,
                                            parallel_propagation=False))
    built = [feature_bundles(cfg, simulate_sequence(
        cfg, duration=8.0, static_time=1.0, seed=s, meas_noise=5e-4,
        imu_noise=True), cuda) for s in seeds]
    T = min(int(b.imu.w.shape[0]) for _, b, _ in built)
    return cfg, [s for s, _, _ in built], [_frames(b, T) for _, b, _ in built]


def _frames(bundles, n):
    from rvio_tpu_torch.state.filter_state import map_fields
    return bundles.__class__(imu=map_fields(lambda x: x[:n], bundles.imu),
                             batch=map_fields(lambda x: x[:n], bundles.batch))


def _stack_bundles(bundles):
    from rvio_tpu_torch.runtime.graph import tree_leaves
    from rvio_tpu_torch.filter.propagation import ImuBlock
    from rvio_tpu_torch.filter.update import UpdateBatch
    x = [torch.stack(v) for v in zip(*(tree_leaves(b) for b in bundles))]
    return bundles[0].__class__(imu=ImuBlock(*x[:4]),
                                batch=UpdateBatch(*x[4:]))


@pytest.mark.gpu
def test_batched_scan_matches_single_scans(cuda):
    """Three segments in one graphed batched scan against each one's
    graphed single scan on the card (the same window chain form; the
    batch changes the library calls' shapes): positions within 1e-4 m,
    attitudes 1e-5 rad, and the same update decisions; each filter kernel
    launches once a batched frame under replay, in two runs."""
    from rvio_tpu_torch.runtime import (make_batched_sequence_scan,
                                        make_sequence_scan)
    from rvio_tpu_torch.state import stack_states
    cfg, states, bundles = _segments(cuda)
    T = int(bundles[0].imu.w.shape[0])
    run = make_batched_sequence_scan(cfg, cuda)
    wrappers = _wrappers()
    for _ in range(2):
        for w in wrappers.values():
            w.launches = 0
        final, out = run(stack_states(states), _stack_bundles(bundles))
        torch.cuda.synchronize()
        assert {k: wrappers[k].launches for k in FILTER_WRAPPERS} == \
            dict.fromkeys(FILTER_WRAPPERS, T)
        assert all(v == 0 for k, v in ((k, w.launches)
                                       for k, w in wrappers.items())
                   if k not in FILTER_WRAPPERS)
    assert [c["frames"] for c in run.frame_scan.captures] == [1]
    single = make_sequence_scan(cfg, cuda)
    for s, (st, bd) in enumerate(zip(states, bundles)):
        _, one = single(st, bd)
        gap = float((out["p_Gk"][s] - one["p_Gk"]).abs().max())
        assert gap < 1e-4, (s, gap)
        dq = (out["q_kG"][s] - one["q_kG"]).abs().max()
        assert float(dq) < 1e-5, s
        assert torch.equal(out["did_update"][s], one["did_update"])
        assert int(final.frame_idx[s]) == int(st.frame_idx) + T


@pytest.mark.gpu
def test_masked_scan_keeps_masked_segments(cuda):
    """The graphed masked segment scan: a segment whose frames are all
    masked keeps its state bitwise; the others run as the batched scan."""
    from rvio_tpu_torch.parallel import make_masked_segment_scan
    from rvio_tpu_torch.runtime import make_batched_sequence_scan
    from rvio_tpu_torch.runtime.graph import tree_leaves
    from rvio_tpu_torch.state import stack_states
    cfg, states, bundles = _segments(cuda)
    T = int(bundles[0].imu.w.shape[0])
    ok = torch.ones(3, T, dtype=torch.bool, device=cuda)
    ok[1] = False
    start = stack_states(states)
    final, out = make_masked_segment_scan(cfg, cuda)(
        start, _stack_bundles(bundles), ok)
    ref, rout = make_batched_sequence_scan(cfg, cuda)(
        start, _stack_bundles(bundles))
    torch.cuda.synchronize()
    for x, y, z in zip(tree_leaves(final), tree_leaves(start),
                       tree_leaves(ref), strict=True):
        assert torch.equal(x[1], y[1])
        assert torch.equal(x[0], z[0]) and torch.equal(x[2], z[2])
    assert torch.equal(out["ok"], ok)
    assert torch.equal(out["p_Gk"][0], rout["p_Gk"][0])


@pytest.mark.gpu
def test_warm_split_on_card(cuda):
    """run_segments_warm on the card in f32 (40 s, 4 segments, warm-up
    60): finite, within 0.05 m of the unsplit scan's ATE, every segment
    updating, and the repair pass's B = 1 scan where a segment's body has
    no features."""
    import dataclasses
    from rvio_tpu_torch.bench import feature_bundles
    from rvio_tpu_torch.config import (CameraConfig, ImuConfig, RVIOConfig,
                                       TpuConfig, TrackerConfig)
    from rvio_tpu_torch.dataio import simulate_sequence
    from rvio_tpu_torch.eval.ate import ate_rmse
    from rvio_tpu_torch.parallel import run_segments_warm, segment_plan
    from rvio_tpu_torch.runtime import make_sequence_scan
    cfg = RVIOConfig(imu=ImuConfig(rate_hz=100.0),
                     camera=CameraConfig(fps=10.0),
                     tracker=TrackerConfig(num_features=24,
                                           max_tracking_length=6,
                                           min_tracking_length=3),
                     tpu=TpuConfig(imu_block=16))
    sim = simulate_sequence(cfg, duration=40.0, static_time=1.0, seed=5,
                            meas_noise=5e-4, imu_noise=True)
    state0, bundles, idx0 = feature_bundles(cfg, sim, cuda)
    gt = sim.gt_p[idx0:]
    _, full = make_sequence_scan(cfg, cuda)(state0, bundles)
    stitched, outs, info = run_segments_warm(cfg, state0, bundles, 4, 60,
                                             device=cuda)
    assert np.isfinite(stitched).all() and stitched.shape == (len(gt), 3)
    assert ate_rmse(stitched, gt) <= ate_rmse(
        full["p_Gk"].double().cpu().numpy(), gt) + 0.05
    ng, ok = outs["n_good"].cpu().numpy(), outs["ok"].cpu().numpy()
    assert all(ng[s][ok[s]].mean() > 3.0 for s in range(4))
    assert info["repaired_segments"] == [] and info["repair_scan"] is None
    _, _, B = segment_plan(len(gt), 4, 60)
    valid = bundles.batch.valid.clone()
    valid[3 * B:] = False
    stripped = dataclasses.replace(bundles, batch=dataclasses.replace(
        bundles.batch, valid=valid))
    _, _, info = run_segments_warm(cfg, state0, stripped, 4, 60, device=cuda)
    assert info["repaired_segments"] == [3]
    assert [c["frames"] for c in info["repair_scan"].frame_scan.captures] \
        == [1]


# ---- the batched tracker's image kernels and the set replay ----------------

IMAGE_BATCH_NAMES = ["gather_tiles", "lk_level", "subpix_refine",
                     "shi_tomasi_nms", "clahe_luts", "clahe_apply"]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 4])
@pytest.mark.parametrize("name", IMAGE_BATCH_NAMES)
def test_image_batch_kernel_matches_plain(cuda, name, B):
    """Each image kernel at B segments (K9: B·N rows) in one launch
    against its plain version on the same inputs, segment by segment at
    the one-segment tolerance (K8 also bitwise against a single launch a
    segment)."""
    from rvio_tpu_torch.ops.checks import image_batch_checks
    chk = {c.name: c for c in image_batch_checks(cuda, B)}[name]
    before = chk.kernel.launches
    chk.check()
    torch.cuda.synchronize()
    assert chk.kernel.launches == before + chk.check_launches


def _two_T_segments(cuda):
    """K8's arguments for two segments of 24 features whose largest trip
    counts differ (the same texture moved by a small and a large shift)."""
    from rvio_tpu_torch.frontend.image import bilinear_sample
    from rvio_tpu_torch.ops.checks import _texture, lk_inputs
    rng = np.random.default_rng(3)
    H, W = 120, 160
    cases = []
    for shift in ((0.4, -0.3), (3.7, 2.9)):
        base = _texture(rng, H + 40, W + 40)
        yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                                torch.arange(W, dtype=torch.float64),
                                indexing="ij")
        img2 = bilinear_sample(base, torch.stack(
            [xx + 20 - shift[0], yy + 20 - shift[1]], -1))
        pts = rng.uniform([8, 8], [W - 9, H - 9], (24, 2))
        args, _ = lk_inputs(base[20:20 + H, 20:20 + W].float(),
                            img2.float(), pts, 15)
        cases.append(tuple(x.to(cuda) for x in args))
    kw = dict(win=15, max_iters=30, eps=1e-2, min_eig=1e-3, wander=7.5,
              last=True, hw=(H, W))
    return cases, kw


@pytest.mark.gpu
def test_lk_level_segments_keep_their_T(cuda):
    """Two segments with different T in one launch: each is its single
    launch bitwise, and the plain version's segments are its single
    calls."""
    from rvio_tpu_torch.ops.klt_iterate import (lk_level, lk_level_plain,
                                                lk_level_trips)
    cases, kw = _two_T_segments(cuda)
    T = [int(lk_level_trips(*a, **kw)[3].max()) for a in cases]
    assert T[0] != T[1]
    stacked = tuple(torch.stack(x) for x in zip(*cases))
    before = lk_level.launches
    got = lk_level(*stacked, **kw)
    assert lk_level.launches == before + 1
    plain = lk_level_plain(*stacked, **kw)
    for b, a in enumerate(cases):
        one = lk_level(*a, **kw)
        for x, y in zip(got, one):
            assert torch.equal(x[b], y)
        for x, y in zip(plain, lk_level_plain(*a, **kw)):
            assert torch.equal(x[b], y)


@pytest.mark.gpu
def test_image_batch_wrappers_refuse(cuda):
    """A batch whose parts do not match raises: origins of another segment
    count, LUTs of another, more segments than K8's tickets."""
    from rvio_tpu_torch.ops.clahe import clahe_apply
    from rvio_tpu_torch.ops.klt_iterate import lk_level
    from rvio_tpu_torch.ops.tile_gather import gather_tiles
    img = torch.zeros(2, 48, 64, device=cuda)
    with pytest.raises(ValueError):
        gather_tiles(img, torch.zeros(3, 5, 2, dtype=torch.int32,
                                      device=cuda), 40, 32)
    with pytest.raises(ValueError):
        clahe_apply(img, torch.zeros(3, 25, 256, device=cuda))
    cases, kw = _two_T_segments(cuda)
    many = tuple(torch.stack([x] * 257) for x in cases[0])
    with pytest.raises(ValueError):
        lk_level(*many, **kw)


@pytest.mark.gpu
def test_set_replay_on_the_card(cuda):
    """run_sequence_set on the card (f32, the small config of
    tests/test_replay_set.py, 6 s and 4 s): each sequence as its single
    replay within the image path's card limits, one launch a batched
    frame of every image kernel."""
    from test_torch_replay_set import _cfg, _mem_seq
    from rvio_tpu_torch import config as tconfig
    from rvio_tpu_torch.ops.klt_iterate import lk_level
    from rvio_tpu_torch.runtime import (run_euroc_sequence_scan,
                                        run_sequence_set)
    cfg = _cfg(tconfig, True)
    seqs = [_mem_seq(cfg, 6.0, 5)[0], _mem_seq(cfg, 4.0, 9)[0]]
    lk_level.launches = 0
    res = run_sequence_set(cfg, seqs, device=cuda, chunk_size=8)
    L = lk_level.launches // (cfg.tracker.klt_levels + 1)
    assert L == max(len(r.timestamps) for r in res)
    for r, s in zip(res, seqs):
        one = run_euroc_sequence_scan(cfg, s, device=cuda, chunk_size=8)
        np.testing.assert_array_equal(r.timestamps, one.timestamps)
        np.testing.assert_allclose(r.positions, one.positions, atol=5e-5)
        assert (r.active_slots == one.active_slots).mean() >= 0.99


@pytest.mark.gpu
def test_set_replay_staged_ahead_on_the_card(cuda):
    """run_sequence_set on the card in chunks of 8, each assembled into a
    page-locked buffer (two, reused in turn) and copied up while the card
    runs the chunk before it, is bitwise the one chunk that covers the
    set: a buffer rewritten while its copy is in flight, or rows held as
    views of a reused buffer, would part them."""
    from test_torch_replay_set import ONE_CHUNK, _cfg, _mem_seq
    from rvio_tpu_torch import config as tconfig
    from rvio_tpu_torch.runtime import run_sequence_set
    cfg = _cfg(tconfig, True)
    seqs = [_mem_seq(cfg, 6.0, 5)[0], _mem_seq(cfg, 4.0, 9)[0]]
    staged = run_sequence_set(cfg, seqs, device=cuda, chunk_size=8)
    whole = run_sequence_set(cfg, seqs, device=cuda, chunk_size=ONE_CHUNK)
    assert max(len(r.timestamps) for r in staged) > 16     # three chunks
    for a, b in zip(staged, whole, strict=True):
        for name in ("timestamps", "positions", "quaternions",
                     "active_slots", "landmarks"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=name)


# ---- the mesh layer ---------------------------------------------------------

@pytest.fixture
def nccl_one_rank(cuda, tmp_path):
    """A process group of one NCCL rank on the card (a file store under
    tmp_path), torn down after the test."""
    import torch.distributed as dist
    torch.cuda.set_device(cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_nccl_one_rank_mesh_is_the_batched_scan(cuda, nccl_one_rank):
    """make_parallel_sequence on a (1, 1) NCCL mesh is the graphed batched
    scan: every output and final state bitwise, one launch of each filter
    kernel a batched frame, one capture."""
    from rvio_tpu_torch.parallel import (make_mesh, make_parallel_sequence,
                                         shard_bundles, shard_states)
    from rvio_tpu_torch.runtime import make_batched_sequence_scan
    from rvio_tpu_torch.runtime.graph import tree_leaves
    from rvio_tpu_torch.state import stack_states
    cfg, states, bundles = _segments(cuda)
    T = int(bundles[0].imu.w.shape[0])
    start, bb = stack_states(states), _stack_bundles(bundles)
    mesh = make_mesh(seg=1, feat=1)
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    pfs, pout = make_parallel_sequence(cfg, mesh)(shard_states(start, mesh),
                                                  shard_bundles(bb, mesh))
    torch.cuda.synchronize()
    assert {k: wrappers[k].launches for k in FILTER_WRAPPERS} == \
        dict.fromkeys(FILTER_WRAPPERS, T)
    fs, out = make_batched_sequence_scan(cfg, cuda)(start, bb)
    for k, v in pout.items():
        assert torch.equal(v, out[k]), k
    for x, y in zip(tree_leaves(pfs), tree_leaves(fs), strict=True):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("compression", ["cholesky", "qr"])
def test_feat_decomposition_on_card(cuda, compression):
    """The update's shard-local partials of two halves of F in one
    process, merged, through the replicated tail on the card, against the
    unsharded update on frame 40 of three segments (the first 40 frames
    through the graphed scan with Cholesky compression, the update under
    test eager): positions within 1e-4 m, attitudes 1e-5, the same gate
    decisions."""
    from rvio_tpu_torch.filter.propagation import propagate
    from rvio_tpu_torch.filter.update import (UpdateBatch, merge_partials,
                                              msckf_update, update_partials)
    from rvio_tpu_torch.runtime import make_batched_sequence_scan
    from rvio_tpu_torch.state import stack_states
    cfg, states, bundles = _segments(cuda)
    bb = _stack_bundles(bundles)
    n = 40
    st, _ = make_batched_sequence_scan(cfg, cuda)(
        stack_states(states), bb.__class__(
            imu=_cut_time(bb.imu, n), batch=_cut_time(bb.batch, n)))
    i, c = cfg.imu, cfg.camera
    st = propagate(st, _at(bb.imu, n), gravity=i.gravity,
                   small_angle=i.small_angle, sigma_g=i.sigma_g,
                   sigma_wg=i.sigma_wg, sigma_a=i.sigma_a,
                   sigma_wa=i.sigma_wa)
    batch = _at(bb.batch, n)
    kw = dict(R_bc=torch.as_tensor(c.R_bc, device=cuda).float(),
              t_bc=torch.as_tensor(c.t_bc, device=cuda).float(),
              sigma_im=c.sigma_image, compression=compression,
              adaptive_noise=cfg.tpu.adaptive_noise)
    tail = dict(min_clone_states=cfg.min_clone_states)
    ref, rdiag = msckf_update(st, batch, **kw, **tail)
    F = batch.valid.shape[1]
    halves = [UpdateBatch(**{k: v[:, s] for k, v in vars(batch).items()})
              for s in (slice(0, F // 2), slice(F // 2, F))]
    other = update_partials(st, halves[1], **kw)
    got, diag = msckf_update(st, halves[0], **kw, **tail,
                             feat_reduce=lambda p: merge_partials([p, other]))
    torch.cuda.synchronize()
    assert bool(rdiag["did_update"].any())
    assert torch.equal(diag["did_update"], rdiag["did_update"])
    assert torch.equal(diag["n_good"], rdiag["n_good"])
    assert float((got.p_G - ref.p_G).abs().max()) < 1e-4
    assert float((got.q_G - ref.q_G).abs().max()) < 1e-5


def _cut_time(obj, n):
    from rvio_tpu_torch.state.filter_state import map_fields
    return map_fields(lambda x: x[:, :n], obj)


def _at(obj, t):
    from rvio_tpu_torch.state.filter_state import map_fields
    return map_fields(lambda x: x[:, t], obj)


# --- the QR route and wide windows in graphed frames; the stress shapes --------

_QR_CHILD = """
import sys
import numpy as np
sys.path.insert(0, "tests")
from test_torch_cuda import _qr_runs
np.savez(sys.argv[1], **_qr_runs("cuda"))
"""


def _feature_workload(cfg, dev, duration=20.0):
    """bench.py's synthetic sequence (seed 7), ``duration`` seconds, at
    ``cfg``: (sim, init state, stacked bundles on ``dev``, init frame)."""
    from rvio_tpu_torch.bench import feature_bundles
    from rvio_tpu_torch.dataio import simulate_sequence
    sim = simulate_sequence(cfg, duration=duration, static_time=1.5,
                            ramp_time=5.0, seed=7, n_landmarks=2000,
                            motion_scale=0.8, meas_noise=0.001,
                            imu_noise=True)
    return (sim, *feature_bundles(cfg, sim, dev))


def _qr_runs(dev, B=4):
    """The feature workload with QR compression through
    ``make_sequence_scan`` and ``make_batched_sequence_scan`` (B copies):
    every frame's pose as numpy, and the ground truth."""
    from rvio_tpu_torch.bench import batch_copies, bench_config
    from rvio_tpu_torch.runtime import (make_batched_sequence_scan,
                                        make_sequence_scan)
    from rvio_tpu_torch.state import stack_states
    cfg = bench_config({"BENCH_COMPRESSION": "qr"})
    sim, state0, bundles, idx0 = _feature_workload(cfg, dev)
    _, one = make_sequence_scan(cfg, dev)(state0, bundles)
    _, many = make_batched_sequence_scan(cfg, dev)(
        stack_states([state0] * B), batch_copies(bundles, B))
    return {"p1": one["p_Gk"].cpu().numpy(), "q1": one["q_kG"].cpu().numpy(),
            "pB": many["p_Gk"].cpu().numpy(),
            "qB": many["q_kG"].cpu().numpy(), "gt": sim.gt_p[idx0:]}


@pytest.mark.gpu
def test_qr_scans_graphed_match_eager(cuda, tmp_path):
    """QR compression in graphed frames (ROADMAP.md §3): the graphed
    sequence scan and the graphed batched scan (B = 4) run in a child
    process, so that a call that refuses capture shows as its return code
    and not as a dead pytest; their poses match the same frames run
    eagerly within the card-vs-CPU limits (1e-4 m, 1e-5 rad), and the
    single run's ATE is below 0.05 m."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from chip_smoke import eager_frames, rotation_gap
    from rvio_tpu_torch.eval.ate import ate_rmse
    root = Path(__file__).resolve().parent.parent
    out = tmp_path / "qr.npz"
    env = dict(os.environ, PYTHONPATH=str(root))
    p = subprocess.run([sys.executable, "-c", _QR_CHILD, str(out)], cwd=root,
                       env=env, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, (p.returncode, p.stderr[-3000:])
    got = np.load(out)
    with eager_frames():
        ref = _qr_runs(cuda)
    for k in ("1", "B"):
        dp = float(np.abs(got["p" + k] - ref["p" + k]).max())
        dq = rotation_gap(got["q" + k].reshape(-1, 4),
                          ref["q" + k].reshape(-1, 4))
        assert dp < 1e-4 and dq < 1e-5, (k, dp, dq)
    assert ate_rmse(got["p1"], got["gt"]) < 0.05


def _wide_cfg(length):
    import dataclasses

    from rvio_tpu_torch import RVIOConfig
    cfg = RVIOConfig()
    return cfg.replace(tracker=dataclasses.replace(
        cfg.tracker, max_tracking_length=length))


@pytest.mark.gpu
@pytest.mark.parametrize("length", [17, 20, 33, 65])
def test_wide_window_graphed_matches_cpu(cuda, length):
    """A window of 16, 19, 32 or 64 clones (K5 at n = 96, 114, 192, 384,
    past its narrow kernel's 92; K4 at m = 66 and 130 and K3 at L = 65
    past their narrow instances): the graphed sequence scan launches K5
    once a frame and stays within the card-vs-CPU limits (1e-4 m,
    1e-5 rad) of the CPU run over 100 frames, with more than 4 good
    features a frame from frame 40 on; at 64 clones, where the workload
    offers fewer usable features than that (ROADMAP.md section 3), more
    than 0.9 of those the CPU run found usable."""
    from chip_smoke import WIDE_FEW_USABLE, _head, rotation_gap
    from rvio_tpu_torch.ops.ekf_tail import ekf_tail
    from rvio_tpu_torch.runtime import make_sequence_scan
    cfg = _wide_cfg(length)
    outs = {}
    for dev in (cuda, "cpu"):
        _, state0, bundles, _ = _feature_workload(cfg, dev, duration=10.0)
        cut = _head(bundles, 100)
        ekf_tail.launches = 0
        _, out = make_sequence_scan(cfg, dev)(state0, cut)
        outs[str(dev)] = {k: v.cpu().numpy() for k, v in out.items()}
        assert ekf_tail.launches == (100 if dev == cuda else 0)
    gpu, cpu = outs[str(cuda)], outs["cpu"]
    assert len(gpu["p_Gk"]) == 100
    if length in WIDE_FEW_USABLE:
        assert gpu["n_good"][40:].mean() > 0.9 * cpu["n_usable"][40:].mean()
    else:
        assert gpu["n_good"][40:].mean() > 4
    dp = float(np.abs(gpu["p_Gk"] - cpu["p_Gk"]).max())
    dq = rotation_gap(gpu["q_kG"], cpu["q_kG"])
    assert dp < 1e-4 and dq < 1e-5, (dp, dq)


@pytest.mark.gpu
def test_wide_window_batched_rows_equal(cuda):
    """The graphed batched scan of B = 4 copies of the workload at a window
    of 32 clones (every filter kernel's wide form on the path: K5 at
    n = 192, K4 at m = 66): one launch of each filter kernel a batched
    frame, and every row bitwise the first."""
    from chip_smoke import _head
    from rvio_tpu_torch.bench import batch_copies
    from rvio_tpu_torch.ops.ekf_tail import ekf_tail
    from rvio_tpu_torch.ops.spd_solve import batched_quadform
    from rvio_tpu_torch.runtime import make_batched_sequence_scan
    from rvio_tpu_torch.state import stack_states
    cfg = _wide_cfg(33)
    _, state0, bundles, _ = _feature_workload(cfg, cuda, duration=10.0)
    cut = _head(bundles, 80)
    run = make_batched_sequence_scan(cfg, cuda)
    states, copies = stack_states([state0] * 4), batch_copies(cut, 4)
    run(states, copies)                              # capture
    ekf_tail.launches = batched_quadform.launches = 0
    _, out = run(states, copies)
    assert ekf_tail.launches == batched_quadform.launches == 80
    for k, v in out.items():
        for row in range(1, 4):
            assert torch.equal(v[row], v[0]), k
    assert float(out["n_good"][0].double().mean()) > 2


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gather_tiles", "lk_level",
                                  "subpix_refine"])
def test_stress_shapes_match_plain(cuda, name):
    """K6 and K8 at the stress config's level 4 (30 x 47, smaller than a
    tile) and K9 on a full frame, each at 800 lanes
    (ops/checks.stress_checks), against their plain versions."""
    from rvio_tpu_torch.ops.checks import stress_checks
    chk = {c.name: c for c in stress_checks(cuda)}[name]
    before = chk.kernel.launches
    chk.check()
    torch.cuda.synchronize()
    assert chk.kernel.launches == before + chk.check_launches


@pytest.mark.gpu
def test_bench_feature_path_with_qr(cuda):
    """``BENCH_COMPRESSION=qr`` through the port bench's feature path (a
    short sequence): it runs graphed, finite, with an ATE below 0.05 m."""
    from rvio_tpu_torch.bench import bench_config, feature_path
    from rvio_tpu_torch.dataio import simulate_sequence
    cfg = bench_config({"BENCH_COMPRESSION": "qr"})
    assert cfg.tpu.compression == "qr"
    sim = simulate_sequence(cfg, duration=15.0, static_time=1.5,
                            ramp_time=5.0, seed=7, n_landmarks=2000,
                            motion_scale=0.8, meas_noise=0.001,
                            imu_noise=True)
    feat = feature_path(cfg, sim, cuda)
    assert feat["frames"] > 200 and np.isfinite(feat["fps"])
    assert feat["synthetic_ate_m"] < 0.05
