"""The benchmark's general part: it finds a cell's configuration, traffic
mix, driver, metric readers and limits by the names ``BENCHMARK.json``
gives them, runs the cell once and prints the result line.

A cell is one ``workloads`` entry.  Its pieces are files of their own:

- ``configs/<config>.json``: the port's RVIOConfig sections as run, with
  ``source``, ``assumed`` and ``reduced``;
- ``traffic/<traffic>.json``: the mix's parameters; its ``driver`` names
  the loop in ``drivers/<driver>.py`` that sets the mix up, runs the
  window and checks it against the reference;
- ``metrics/<metric>.py``: one reader a per-layer metric, ``read(run)``,
  which returns the metric's value or None where it finds nothing;
- ``limits/<cell>.json``: the limit of each number the check compares.

A new cell, configuration, mix, metric or limit is a new file and a new
entry in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rvio_tpu")
SECTIONS = ("imu", "camera", "tracker", "init", "landmark", "tpu")


def load_spec(path: Path = CHECKOUT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def cell_entry(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def metrics_of(spec: dict, group: str, cell: str) -> list:
    """The metrics of ``group`` (end_to_end or per_layer) a cell reports:
    those that list it, and those that list no cells."""
    return [m for m in spec[group]
            if cell in m.get("workloads", [cell])]


def read_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def build_config(data: dict, config_module):
    """An RVIOConfig of ``config_module`` (the port's config module or the
    reference's copy) from a configuration file's sections."""
    m = config_module
    classes = dict(imu=m.ImuConfig, camera=m.CameraConfig,
                   tracker=m.TrackerConfig, init=m.InitConfig,
                   landmark=m.LandmarkConfig, tpu=m.TpuConfig)
    sections = {}
    for name in SECTIONS:
        kw = dict(data.get(name, {}))
        if "T_BC0" in kw:
            kw["T_BC0"] = tuple(float(x) for x in kw["T_BC0"])
        sections[name] = classes[name](**kw)
    return m.RVIOConfig(**sections)


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def device_info(count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def make_run(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", spec=None, overrides=None) -> SimpleNamespace:
    """Everything a driver needs for one run of a cell.  ``overrides``
    (the CPU tests' small sizes) replace traffic parameters and tracker
    and camera fields: ``{"traffic": {...}, "tracker": {...},
    "camera": {...}}``."""
    import rvio_tpu_torch.config as port_config
    import benchmark.reference.rvio_plain.config as ref_config
    spec = spec or load_spec()
    cell = cell_entry(spec, workload)
    conf = read_json("configs", cell["config"])
    traffic = read_json("traffic", cell["traffic"])
    overrides = overrides or {}
    traffic.update(overrides.get("traffic", {}))
    for sec in ("tracker", "camera"):
        if sec in overrides:
            conf[sec] = {**conf.get(sec, {}), **overrides[sec]}
    limits_path = HERE / "limits" / f"{workload}.json"
    limits = (json.loads(limits_path.read_text())
              if limits_path.exists() else {})
    return SimpleNamespace(
        workload=workload, cell=cell, spec=spec, seed=int(seed),
        seconds=float(seconds), trace=bool(trace),
        device=torch.device(device), traffic=traffic, limits=limits,
        cfg=build_config(conf, port_config),
        ref_cfg=build_config(conf, ref_config),
        counters={}, trace_summary=None)


def run_cell(run, t_start: float) -> dict:
    """Set the cell up, run its window, check it against the reference and
    return the result line's object (without ``device``)."""
    drv = driver(run.traffic["driver"])
    state = drv.setup(run)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    out = drv.window(run, state)
    memory = (int(torch.cuda.max_memory_allocated())
              if run.device.type == "cuda" else 0)
    t1 = time.perf_counter()
    checks = drv.check(run, state, out)
    print(f"benchmark: set-up {setup_s:.3f} s, window {t1 - t0:.3f} s, "
          f"check {time.perf_counter() - t1:.3f} s; {run.counters}",
          file=sys.stderr, flush=True)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if run.trace_summary is not None:
        print("benchmark: traced stretch " + json.dumps(
            {k: v for k, v in run.trace_summary.items()
             if k != "breakdown"}), file=sys.stderr, flush=True)
    if run.trace:
        metrics = {}
        for m in metrics_of(run.spec, "per_layer", run.workload):
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(out["end_to_end"], setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(run.spec, "end_to_end", run.workload)}
    res = {"correct": bool(correct), "attempted": int(out["attempted"]),
           "failed": int(out["failed"]), "metrics": metrics,
           "memory_peak_bytes": memory}
    if run.trace and run.trace_summary is not None:
        res["busy_s"] = run.trace_summary["busy_s"]
        res["window_s"] = run.trace_summary["window_s"]
        res["breakdown"] = run.trace_summary["breakdown"]
    res["checks"] = checks
    return res


def result_line(res: dict, device: dict) -> dict:
    """The result line's object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (with the run's peak memory, and in a traced
    run ``busy_s`` and ``window_s``), ``breakdown`` where traced, and last
    ``checks``."""
    res = dict(res)
    device = dict(device, memory_peak_bytes=res.pop("memory_peak_bytes"))
    for k in ("busy_s", "window_s"):
        if k in res:
            device[k] = res.pop(k)
    breakdown = res.pop("breakdown", None)
    checks = res.pop("checks")
    line = {**res, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def main(argv=None, t_start=None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    spec = load_spec()
    cell = cell_entry(spec, a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    run = make_run(a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
                   spec)
    res = run_cell(run, t_start)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 1
    line = result_line(res, device_info(cell["chips"]))
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
