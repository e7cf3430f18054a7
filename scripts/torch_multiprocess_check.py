"""Real multi-process runs of the port's mesh layer (rvio_tpu_torch.parallel).

The port's counterpart of scripts/multiprocess_check.py.  The parent
starts ``--world`` processes of this script by ``subprocess`` (no fork),
joined into one ``torch.distributed`` process group by a file store in a
temporary directory (no TCP port, so concurrent runs cannot collide).
Each child sets ``torch.set_num_threads(1)``, takes the GPU of its rank
modulo the GPUs with ``--device cuda`` (two ranks on one card share it;
NCCL refuses that, gloo takes CUDA tensors for ``all_reduce`` and
``broadcast``), never imports jax, runs each ``--run`` on its own
``make_mesh(seg=..., feat=...)`` and writes its rank's arrays to
``OUT/<workload>-<seg>x<feat>.rank<r>.npz``.  The parent builds the CUDA
kernels first (with ``--device cuda``), so the children load them and do
not race on the build directory, waits for every child and prints one
JSON line: ok, the processes, each run's seconds by rank, each child's
exit code.  A failed child fails the whole check (exit 1, its log's tail
on stderr).

    python scripts/torch_multiprocess_check.py --inputs DIR --out DIR \\
        --backend gloo|nccl [--device cuda|cpu] [--world 2] \\
        --run sequence:1x2 [--run warm:2x1 ...]

As every entry point of the port, it runs on the card unless the caller
asks for the CPU (``--device cpu``); the backend has no default, the
caller names it (gloo for CPU ranks or two ranks on one card, NCCL for
one rank a card) and it is never switched.

Each workload reads ``DIR/<workload>.npz``, written by the caller
(tests/test_torch_parallel_mp.py, chip_smoke.py) with ``config`` (a name
:func:`make_config` knows) and ``dtype`` ("float32" or "float64"):

- ``sequence``: ``state.<field>`` (S, ...) stacked initial states (the
  FilterState's field names), ``imu.<field>`` and ``batch.<field>``
  (S, T, ...) bundles; ``make_parallel_sequence`` over the rank's
  segments and lanes.  Writes ``out.<key>`` (gathered, (S, T, ...)),
  ``state.<field>`` (the rank's final states), ``seconds`` (the scan, end
  in a synchronize) and ``launches.<kernel>``;
- ``warm``: ``state.<field>`` (segment 0's init), ``imu.*``/``batch.*``
  (T, ...), ``segments``, ``warmup``; ``run_segments_warm(mesh=)``.
  Writes ``stitched``, ``out.<key>`` (S, W+B, ...), ``repaired``;
- ``tracker``: ``images`` (T+1, H, W) u8, ``imu_w`` (T, K, 3), ``imu_dt``
  and ``imu_valid`` (T, K), ``u`` (T, N); ``make_tracker(mesh=)``'s
  init_fn on image 0, then track_fn a frame.  Writes the per-frame state
  fields ``pos``, ``hist``, ``length``, ``active``, the batch ``meas``,
  ``track_len``, ``is_type2``, ``valid``, ``n_tracked``, ``klt_err``;
- ``chunk``: ``image0`` (H, W) u8, ``state.<field>`` (one filter's init),
  ``chunk.<key>`` (T, ...) (runtime/image_driver.py
  ``make_image_chunk_scan``'s chunk); the tracker initialized on
  ``image0``, then ``make_image_chunk_scan(mesh=)`` over the chunk.
  Writes ``out.<key>`` and the final ``ts.<field>``.

Every run also writes ``seconds`` (its first call, building and
capturing included) and the kernels' ``launches.<name>`` counted over it
(0 on the CPU); ``sequence`` and ``chunk`` then run their scan again and
write ``warm_seconds``, ``allreduce_calls`` and ``allreduce_bytes`` (the
``all_reduce`` calls of the warm run and the largest one's bytes) and,
with feat > 1, ``allreduce_ms``, one ``all_reduce`` of that size over the
feat group.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOADS = ("sequence", "warm", "tracker", "chunk")
KERNELS = {
    "propagate_block": ("propagate_block", "propagate_block"),
    "lm_triangulate": ("lm_triangulate", "lm_triangulate"),
    "jac_project": ("jac_project", "jac_project"),
    "batched_quadform": ("spd_solve", "batched_quadform"),
    "ekf_tail": ("ekf_tail", "ekf_tail"),
    "gather_tiles": ("tile_gather", "gather_tiles"),
    "lk_level": ("klt_iterate", "lk_level"),
    "subpix_refine": ("klt_iterate", "subpix_refine"),
    "shi_tomasi_nms": ("shi_tomasi", "shi_tomasi_nms"),
    "clahe_luts": ("clahe", "clahe_luts"),
    "clahe_apply": ("clahe", "clahe_apply"),
}


def make_config(name: str):
    """The configurations a workload may name: ``default`` (RVIOConfig()),
    ``small`` (tests/test_parallel.py's), ``image-small`` and
    ``image-small-clahe`` (tests/test_torch_tracker.py's 320x240 config,
    CLAHE off and on)."""
    from rvio_tpu_torch import config as c
    if name == "default":
        return c.RVIOConfig()
    if name == "small":
        return c.RVIOConfig(
            imu=c.ImuConfig(rate_hz=100.0), camera=c.CameraConfig(fps=10.0),
            tracker=c.TrackerConfig(num_features=24, max_tracking_length=6,
                                    min_tracking_length=3),
            tpu=c.TpuConfig(imu_block=16))
    if name in ("image-small", "image-small-clahe"):
        return c.RVIOConfig(
            imu=c.ImuConfig(rate_hz=100.0),
            camera=c.CameraConfig(fps=10.0, width=320, height=240, fx=200.0,
                                  fy=200.0, cx=160.0, cy=120.0, k1=-0.05,
                                  k2=0.01, p1=0.0, p2=0.0),
            tracker=c.TrackerConfig(
                num_features=40, max_tracking_length=8, min_tracking_length=3,
                min_distance=12.0, block_size_x=80, block_size_y=60,
                enable_equalizer=name.endswith("clahe")),
            init=c.InitConfig(sigma_v0=0.1), tpu=c.TpuConfig(imu_block=16))
    raise ValueError(f"unknown config '{name}'")


def parse_run(text: str):
    """``workload:SEGxFEAT`` -> (workload, seg, feat)."""
    workload, _, layout = text.partition(":")
    if workload not in WORKLOADS:
        raise argparse.ArgumentTypeError(f"unknown workload '{workload}'")
    try:
        seg, feat = (int(x) for x in layout.split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"'{text}': a run is WORKLOAD:SEGxFEAT") from None
    return workload, seg, feat


def run_name(workload: str, seg: int, feat: int) -> str:
    return f"{workload}-{seg}x{feat}"


# ---------------------------------------------------------------- child --

def _prefixed(d, prefix: str) -> dict:
    return {k[len(prefix):]: d[k] for k in d.files if k.startswith(prefix)}


def _bundles(d, device, dtype):
    import torch

    from rvio_tpu_torch.filter.propagation import ImuBlock
    from rvio_tpu_torch.filter.update import UpdateBatch
    from rvio_tpu_torch.runtime.step import FrameBundle

    def t(x, to=None):
        x = torch.as_tensor(x, device=device)
        if to is not None:
            return x.to(to)
        return x.to(dtype) if x.is_floating_point() else x

    imu, batch = _prefixed(d, "imu."), _prefixed(d, "batch.")
    return FrameBundle(
        imu=ImuBlock(w=t(imu["w"]), a=t(imu["a"]), dt=t(imu["dt"]),
                     valid=t(imu["valid"], torch.bool)),
        batch=UpdateBatch(meas=t(batch["meas"]),
                          track_len=t(batch["track_len"], torch.int64),
                          is_type2=t(batch["is_type2"], torch.bool),
                          valid=t(batch["valid"], torch.bool)))


def _np(x):
    return x.detach().cpu().numpy()


def _fields(prefix: str, obj) -> dict:
    import dataclasses
    return {f"{prefix}{f.name}": _np(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.name != "pyramid"}


def _workload(workload, d, cfg, dtype, mesh):
    """Run one workload on this rank; returns the arrays to save and, for
    ``sequence`` and ``chunk``, a callable that runs the scan again on the
    same inputs (warm: built and captured), else None."""
    import numpy as np
    import torch

    from rvio_tpu_torch.parallel import (gather_segments,
                                         make_parallel_sequence,
                                         run_segments_warm, shard_bundles,
                                         shard_states)
    from rvio_tpu_torch.parallel.mesh import mesh_device
    from rvio_tpu_torch.state.filter_state import state_from_numpy
    dev = mesh_device(mesh)
    if workload == "sequence":
        states = state_from_numpy(_prefixed(d, "state."), "cpu", dtype)
        run = make_parallel_sequence(cfg, mesh, dtype)
        mine = (shard_states(states, mesh),
                shard_bundles(_bundles(d, "cpu", dtype), mesh))
        fs, out = run(*mine)
        out = gather_segments(out, mesh)
        return ({**{f"out.{k}": _np(v) for k, v in out.items()},
                 **_fields("state.", fs)}, lambda: run(*mine))
    if workload == "warm":
        state0 = state_from_numpy(_prefixed(d, "state."), dev, dtype)
        stitched, out, info = run_segments_warm(
            cfg, state0, _bundles(d, dev, dtype), int(d["segments"]),
            int(d["warmup"]), mesh=mesh)
        return {"stitched": stitched,
                "repaired": np.asarray(info["repaired_segments"], np.int64),
                **{f"out.{k}": _np(v) for k, v in out.items()}}, None
    from rvio_tpu_torch.frontend import make_tracker
    if workload == "tracker":
        init_fn, track_fn = make_tracker(cfg, dev, dtype, mesh=mesh)
        ts, _ = init_fn(torch.as_tensor(d["images"][0]))
        rows = []
        for i in range(len(d["u"])):
            ts, batch, dbg = track_fn(
                ts, torch.as_tensor(d["images"][i + 1]),
                *(torch.as_tensor(d[k][i], device=dev) for k in
                  ("imu_w", "imu_dt", "imu_valid", "u")))
            rows.append({**_fields("", ts), **_fields("", batch),
                         "n_tracked": _np(dbg["n_tracked"]),
                         "klt_err": _np(dbg["klt_err"])})
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}, None
    from rvio_tpu_torch.runtime import make_image_chunk_scan
    init_fn, _ = make_tracker(cfg, dev, dtype)
    ts0, _ = init_fn(torch.as_tensor(d["image0"]))
    fs0 = state_from_numpy(_prefixed(d, "state."), dev, dtype)
    chunk = {k: torch.as_tensor(v, device=dev)
             for k, v in _prefixed(d, "chunk.").items()}
    chunk = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in chunk.items()}
    scan = make_image_chunk_scan(cfg, dev, dtype, mesh=mesh)
    (ts, _), out = scan((ts0, fs0), chunk)
    return ({**{f"out.{k}": _np(v) for k, v in out.items()},
             **_fields("ts.", ts)}, lambda: scan((ts0, fs0), chunk))


def _rerun(rerun, mesh, device: str, n_feat: int) -> dict:
    """The warm run of a scan: its seconds, the ``all_reduce`` calls it
    made and the bytes of the largest, and (where it made any over feat)
    the time of one gloo/NCCL ``all_reduce`` of that size on the rank's
    device over the feat group (50 calls)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rvio_tpu_torch.parallel.mesh import mesh_device

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    sizes = []
    all_reduce = dist.all_reduce

    def counted(t, *args, **kwargs):
        sizes.append(t.numel() * t.element_size())
        return all_reduce(t, *args, **kwargs)

    dist.all_reduce = counted
    try:
        sync()
        t0 = time.perf_counter()
        rerun()
        sync()
        seconds = time.perf_counter() - t0
    finally:
        dist.all_reduce = all_reduce
    out = {"warm_seconds": seconds, "allreduce_calls": np.int64(len(sizes)),
           "allreduce_bytes": np.int64(max(sizes, default=0))}
    if sizes and n_feat > 1:
        buf = torch.zeros(max(sizes) // 4, dtype=torch.float32,
                          device=mesh_device(mesh))
        group = mesh.get_group("feat")
        dist.all_reduce(buf, group=group)
        sync()
        t0 = time.perf_counter()
        for _ in range(50):
            dist.all_reduce(buf, group=group)
        sync()
        out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3 / 50
    return out


def child(args) -> int:
    sys.path.insert(0, REPO)
    import importlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from rvio_tpu_torch.parallel import initialize_distributed, make_mesh
    torch.set_num_threads(1)
    if args.device == "cuda":
        torch.cuda.set_device(args.rank % torch.cuda.device_count())
    initialize_distributed(f"file://{args.store}", num_processes=args.world,
                           process_id=args.rank, backend=args.backend)
    wrappers = {name: getattr(importlib.import_module(
        f"rvio_tpu_torch.ops.{mod}"), fn) for name, (mod, fn) in
        KERNELS.items()}
    try:
        for workload, seg, feat in args.run:
            d = np.load(os.path.join(args.inputs, f"{workload}.npz"))
            cfg = make_config(str(d["config"]))
            dtype = getattr(torch, str(d["dtype"]))
            mesh = make_mesh(seg=seg, feat=feat, device_type=args.device)
            for w in wrappers.values():
                w.launches = 0
            if args.device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            arrays, rerun = _workload(workload, d, cfg, dtype, mesh)
            if args.device == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            arrays.update({f"launches.{k}": np.int64(w.launches)
                           for k, w in wrappers.items()})
            if rerun is not None:
                arrays.update(_rerun(rerun, mesh, args.device, feat))
            np.savez(os.path.join(args.out, f"{run_name(workload, seg, feat)}"
                                  f".rank{args.rank}.npz"),
                     seconds=seconds, **arrays)
            print(f"rank {args.rank}: {run_name(workload, seg, feat)} in "
                  f"{seconds:.3f} s", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


# --------------------------------------------------------------- parent --

def parent(args) -> int:
    import numpy as np
    if args.device == "cuda":
        sys.path.insert(0, REPO)
        from rvio_tpu_torch.ops import _lib
        _lib.build()
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="rvio_mp_") as tmp:
        store = os.path.join(tmp, "store")
        procs, logs = [], []
        try:
            for r in range(args.world):
                log = open(os.path.join(args.out, f"rank{r}.log"), "w")
                logs.append(log)
                cmd = [sys.executable, os.path.abspath(__file__),
                       "--rank", str(r), "--store", store,
                       "--world", str(args.world), "--backend", args.backend,
                       "--device", args.device, "--inputs", args.inputs,
                       "--out", args.out]
                for workload, seg, feat in args.run:
                    cmd += ["--run", f"{workload}:{seg}x{feat}"]
                procs.append(subprocess.Popen(cmd, stdout=log,
                                              stderr=subprocess.STDOUT,
                                              cwd=REPO))
            deadline = time.monotonic() + args.timeout
            for p in procs:
                try:
                    p.wait(timeout=max(deadline - time.monotonic(), 1.0))
                except subprocess.TimeoutExpired:
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
    rcs = [p.returncode for p in procs]
    ok = all(rc == 0 for rc in rcs)
    runs = {}
    if ok:
        for workload, seg, feat in args.run:
            name = run_name(workload, seg, feat)
            runs[name] = {"seconds": [float(np.load(os.path.join(
                args.out, f"{name}.rank{r}.npz"))["seconds"])
                for r in range(args.world)]}
    else:
        for r, rc in enumerate(rcs):
            if rc != 0:
                with open(os.path.join(args.out, f"rank{r}.log")) as f:
                    tail = f.read()[-4000:]
                print(f"rank {r} exited {rc}:\n{tail}", file=sys.stderr)
    print(json.dumps({"ok": ok, "processes": args.world,
                      "backend": args.backend, "device": args.device,
                      "rcs": rcs, "runs": runs,
                      "seconds": time.perf_counter() - t0}))
    return 0 if ok else 1


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inputs", required=True,
                    help="directory of the workloads' <workload>.npz")
    ap.add_argument("--out", required=True, help="directory of the outputs")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"),
                    help="the process group's backend (never switched)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the ranks' device (default: the card)")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--run", type=parse_run, action="append", required=True,
                    help="WORKLOAD:SEGxFEAT, one of " + ", ".join(WORKLOADS))
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the parent waits for the children")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    for _, seg, feat in args.run:
        if seg * feat != args.world:
            ap.error(f"a {seg}x{feat} mesh over {args.world} processes")
    return parent(args) if args.rank is None else child(args)


if __name__ == "__main__":
    sys.exit(main())
