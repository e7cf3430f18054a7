"""Command-line sequence runner — the offline equivalent of the ROS node.

Port of rvio_tpu/run.py (reference: src/rvio_mono.cc, launch/euroc.launch):
reads a config (native or the reference's OpenCV-YAML format verbatim),
replays a EuRoC ASL folder, a rosbag or a synthetic sequence through the
full pipeline, and writes the TUM trajectory and per-frame timing files
(the outputs of INI.RecordOutputs, System.cc:371-379), a trajectory SVG and
the landmark map.  It runs on the CUDA device unless ``--device cpu``.

Usage:
  python -m rvio_tpu_torch.run --synthetic 30 --output out/            # simulator
  python -m rvio_tpu_torch.run --euroc /data/V1_01_easy --output out/  # dataset
  python -m rvio_tpu_torch.run --rosbag /data/MH_01_easy.bag --skip 40
  python -m rvio_tpu_torch.run --euroc DIR --save-checkpoint s.npz     # then
  python -m rvio_tpu_torch.run --euroc DIR --resume s.npz              # resume
  python -m rvio_tpu_torch.run --info /data/V1_01_easy.bag             # topics
  python -m rvio_tpu_torch.run --set /data/V1_01_easy /data/V2_01_easy \
      --output out/                              # a set in lockstep, one card
  python -m rvio_tpu_torch.run --sweep 5 --noise # an N-seed synthetic sweep
  python -m rvio_tpu_torch.run --set A B --profile trace.json  # + a trace
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None):
    """The CLI's work: returns the run's DriverResult (None for --info, a
    list of them for --set, the sweep's rows for --sweep)."""
    ap = argparse.ArgumentParser(description="rvio_tpu_torch sequence runner")
    ap.add_argument("--config", default=None,
                    help="YAML config (native or reference cv-format)")
    ap.add_argument("--euroc", default=None,
                    help="EuRoC sequence dir (contains mav0/)")
    ap.add_argument("--rosbag", default=None,
                    help="rosbag v2.0 file (no ROS needed)")
    ap.add_argument("--info", default=None, metavar="BAG",
                    help="print a bag's topic inventory and exit "
                         "(like `rosbag info`)")
    ap.add_argument("--image-topic", default="/cam0/image_raw",
                    help="rosbag image topic (reference remaps this to "
                         "/camera/image_raw)")
    ap.add_argument("--imu-topic", default="/imu0",
                    help="rosbag IMU topic (reference remaps this to /imu)")
    ap.add_argument("--set", nargs="+", default=None, metavar="SEQ",
                    help="replay several sequences (EuRoC folders or .bag "
                         "files) in lockstep on one device; one output "
                         "folder each")
    ap.add_argument("--synthetic", type=float, default=None, metavar="SECONDS",
                    help="run the simulator for SECONDS instead of a dataset")
    ap.add_argument("--sweep", type=int, default=None, metavar="N",
                    help="run an N-seed synthetic accuracy/throughput sweep")
    ap.add_argument("--skip", type=float, default=0.0,
                    help="seconds of data to skip (MH_* needs ~40)")
    ap.add_argument("--output", default="out",
                    help="output directory for trajectory/timing files")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the pipeline runs (default: the CUDA device)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise", action="store_true",
                    help="synthetic: enable IMU+measurement noise")
    ap.add_argument("--per-frame", action="store_true",
                    help="dataset replay: one frame in, one pose out (the "
                         "live path's shape) instead of the chunked replay")
    ap.add_argument("--save-checkpoint", default=None, metavar="NPZ",
                    help="dataset replay: save the full session (filter + "
                         "tracker + draws + frame cursor) after the run")
    ap.add_argument("--resume", default=None, metavar="NPZ",
                    help="dataset replay: resume a prior run from its "
                         "checkpoint (same sequence); continues the exact "
                         "trajectory")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="write a Chrome trace of the run (torch.profiler: "
                         "host, card and the program's spans) to PATH")
    args = ap.parse_args(argv)
    if args.profile:
        from rvio_tpu_torch.utils.profiling import device_trace
        with device_trace(args.profile):
            return _run(ap, args)
    return _run(ap, args)


def _run(ap, args):
    """:func:`run` after its arguments are parsed."""
    if args.info:
        from rvio_tpu_torch.dataio.rosbag import bag_info
        info = bag_info(args.info)
        for t in sorted(info.topics):
            print(f"{t:32s} {info.topics[t]:24s} "
                  f"{info.message_counts[t]} msgs")
        if info.start is not None:
            print(f"duration: {info.end - info.start:.2f} s")
        return None

    import torch

    from rvio_tpu_torch.config import RVIOConfig, load_config
    from rvio_tpu_torch.dataio.tum import write_tum
    from rvio_tpu_torch.eval.ate import ate_rmse

    cfg = load_config(args.config) if args.config else RVIOConfig()
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    os.makedirs(args.output, exist_ok=True)

    if args.sweep is not None:
        from rvio_tpu_torch.eval.sweep import format_table, run_synthetic_sweep
        rows = run_synthetic_sweep(cfg, seeds=range(args.sweep), dtype=dtype,
                                   noise=args.noise, progress=True,
                                   device=args.device)
        print(format_table(rows))
        return rows

    if args.set:
        return _run_set(args, cfg, dtype)

    gt_aligned = None
    if args.synthetic is not None:
        from rvio_tpu_torch.dataio.synthetic import simulate_sequence
        from rvio_tpu_torch.runtime.driver import (SequenceDriver,
                                                   batches_from_sim)
        sim = simulate_sequence(cfg, duration=args.synthetic, seed=args.seed,
                                meas_noise=0.001 if args.noise else 0.0,
                                imu_noise=args.noise)
        driver = SequenceDriver(cfg, dtype=dtype, device=args.device)
        t0 = time.perf_counter()
        res = driver.run(sim.imu_t, sim.imu_w, sim.imu_a, sim.frame_t,
                         batches_from_sim(sim), progress=True,
                         collect_landmarks=True)
        wall = time.perf_counter() - t0
        idx = np.searchsorted(sim.frame_t, res.timestamps)
        gt_aligned = sim.gt_p[idx]
        ate = ate_rmse(res.positions, gt_aligned)
        print(f"ATE RMSE: {ate * 100:.2f} cm over {len(res.timestamps)} frames "
              f"({len(res.timestamps) / wall:.1f} fps)")
    elif args.euroc or args.rosbag:
        from rvio_tpu_torch.runtime.image_driver import (
            run_euroc_sequence, run_euroc_sequence_scan)
        if args.rosbag:
            from rvio_tpu_torch.dataio.rosbag import load_rosbag
            seq = load_rosbag(args.rosbag, image_topic=args.image_topic,
                              imu_topic=args.imu_topic, skip_s=args.skip)
            if seq.imu_drops or seq.image_drops:
                print(f"drops: {seq.imu_drops} imu, {seq.image_drops} image")
        else:
            from rvio_tpu_torch.dataio.euroc import load_euroc
            seq = load_euroc(args.euroc, skip_s=args.skip)
        t0 = time.perf_counter()
        if args.per_frame:
            if args.save_checkpoint or args.resume:
                ap.error("--save-checkpoint/--resume need the chunked replay "
                         "(drop --per-frame)")
            res = run_euroc_sequence(cfg, seq, dtype=dtype,
                                     device=args.device, seed=args.seed)
        else:
            res = run_euroc_sequence_scan(
                cfg, seq, dtype=dtype, device=args.device, seed=args.seed,
                timing_split=True, checkpoint_path=args.save_checkpoint,
                resume_from=args.resume)
        wall = time.perf_counter() - t0
        n = len(res.timestamps)
        print(f"{n} frames in {wall:.2f} s ({n / wall:.1f} frames/s; "
              f"{res.image_s:.2f} s producing images, decoder "
              f"{res.decoder})")
        if seq.gt_p is not None:
            gi = np.searchsorted(seq.gt_t, res.timestamps)
            gi = np.clip(gi, 0, len(seq.gt_t) - 1)
            gt_aligned = seq.gt_p[gi]
            ate = ate_rmse(res.positions, gt_aligned)
            print(f"ATE RMSE: {ate * 100:.2f} cm")
    else:
        ap.error("need --euroc, --rosbag, or --synthetic")

    # Reference-parity outputs (System.cc:371-379)
    write_tum(os.path.join(args.output, "stamped_pose_ests.dat"),
              res.timestamps, res.positions, res.quaternions)
    with open(os.path.join(args.output, "time_cost.dat"), "w") as f:
        for i, (fe, be) in enumerate(zip(res.frontend_ms, res.backend_ms)):
            f.write(f"{i + 1} {fe:.6f} {be:.6f}\n")
    # Headless rviz equivalent: trajectory (+GT, +landmark map) SVG.
    from rvio_tpu_torch.utils.visualize import plot_trajectory_svg
    lms = res.landmarks
    plot_trajectory_svg(os.path.join(args.output, "trajectory.svg"),
                        res.positions, gt_p=gt_aligned, landmarks=lms,
                        landmark_scale=cfg.landmark.scale)
    written = ["stamped_pose_ests.dat", "time_cost.dat", "trajectory.svg"]
    if lms is not None:
        np.savetxt(os.path.join(args.output, "landmarks.xyz"), lms,
                   fmt="%.6f")
        written.append("landmarks.xyz")
    print(f"wrote {', '.join(os.path.join(args.output, w) for w in written)}")
    return res


def _run_set(args, cfg, dtype):
    """``--set``: the sequences through ``run_sequence_set``; prints the
    aggregate frames/s and a line a sequence (its ATE where the input has
    ground truth) and writes each trajectory under the output folder, in
    a folder named after the input (made unique)."""
    from rvio_tpu_torch.dataio.tum import write_tum
    from rvio_tpu_torch.eval.ate import ate_rmse, match_nearest
    from rvio_tpu_torch.runtime.replay_set import run_sequence_set

    def load_any(path):
        if path.endswith(".bag"):
            from rvio_tpu_torch.dataio.rosbag import load_rosbag
            return load_rosbag(path, image_topic=args.image_topic,
                               imu_topic=args.imu_topic, skip_s=args.skip)
        from rvio_tpu_torch.dataio.euroc import load_euroc
        return load_euroc(path, skip_s=args.skip)

    seqs = [load_any(p) for p in args.set]
    t0 = time.perf_counter()
    results = run_sequence_set(cfg, seqs, dtype=dtype, device=args.device,
                               seed=args.seed, progress=True)
    wall = time.perf_counter() - t0
    total = sum(len(r.timestamps) for r in results)
    print(f"{total} frames / {len(seqs)} sequences in {wall:.1f} s "
          f"({total / wall:.1f} fps aggregate)")
    used = {}
    for path, seq, res in zip(args.set, seqs, results):
        name = os.path.basename(os.path.normpath(path)).replace(".bag", "")
        # two inputs with the same basename must not overwrite each other
        n = used.get(name, 0)
        used[name] = n + 1
        if n:
            name = f"{name}.{n}"
        line = f"{name:24s} {len(res.timestamps)} frames"
        if seq.gt_p is not None:
            gi, ok = match_nearest(seq.gt_t, res.timestamps)
            if ok.sum() >= 3:
                ate = ate_rmse(res.positions[ok], seq.gt_p[gi][ok])
                line += f"  ATE {ate * 100:.2f} cm ({int(ok.sum())} matched)"
            else:
                line += "  ATE n/a (no gt within tolerance)"
        print(line)
        d = os.path.join(args.output, name)
        os.makedirs(d, exist_ok=True)
        write_tum(os.path.join(d, "stamped_pose_ests.dat"), res.timestamps,
                  res.positions, res.quaternions)
    return results


if __name__ == "__main__":
    sys.exit(main())
