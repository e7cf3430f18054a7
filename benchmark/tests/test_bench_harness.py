"""The harness finds every piece of a cell by name, a cell can be added
with new files alone, the result line has its keys, and each fault a
cell can have turns ``correct`` false (at the small sizes on the CPU)."""

import json
import re
import shutil
import time

import pytest

from benchmark import harness
from benchmark.tests.conftest import CELLS, small_run

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_names_units_and_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for g in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[g]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) <= {"image_frames_per_s", "filter_frames_per_s",
                        "pose_latency_p95_ms", "setup_s"}
    assert {"image_frames_per_s", "setup_s"} <= set(e2e)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert harness.metrics_of(SPEC, "per_layer", w["name"])
        assert len(harness.metrics_of(SPEC, "end_to_end", w["name"])) >= 2


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_of_a_cell_is_found_by_name(cell):
    w = harness.cell_entry(SPEC, cell)
    conf = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    data = json.loads((harness.CHECKOUT / conf["file"]).read_text())
    assert data["reduced"] == conf["reduced"] and len(data["source"]) <= 200
    traffic = harness.read_json("traffic", w["traffic"])
    drv = harness.driver(traffic["driver"])
    for fn in ("setup", "window", "outputs", "reference", "judge", "check"):
        assert callable(getattr(drv, fn))
    for m in harness.metrics_of(SPEC, "per_layer", cell):
        assert callable(harness.reader(m["name"]))
    limits = json.loads((harness.HERE / "limits" / f"{cell}.json")
                        .read_text())
    assert limits and all(v >= 0 for k, v in limits.items()
                          if not k.startswith("about"))


def test_a_cell_is_added_by_new_files_alone(tmp_path, monkeypatch):
    """A copy of the benchmark's data with a new configuration, mix,
    metric reader and limits file, and a new workloads entry: the harness
    runs the new cell with no file of it edited."""
    root = tmp_path / "benchmark"
    for d in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(harness.HERE / d, root / d)
    conf = json.loads((root / "configs" / "euroc_mono.json").read_text())
    conf["tracker"]["max_tracking_length"] = 12
    (root / "configs" / "euroc_mono_l12.json").write_text(json.dumps(conf))
    mix = json.loads((root / "traffic" / "filter_batch.json").read_text())
    mix["duration_s"] = 30
    (root / "traffic" / "filter_batch_short.json").write_text(
        json.dumps(mix))
    (root / "metrics" / "filter_poses.py").write_text(
        "def read(run):\n    return run.counters.get('poses')\n")
    (root / "limits" / "euroc_mono_l12.filter_batch_short.json").write_text(
        (root / "limits" / "euroc_mono.filter_batch.json").read_text())
    spec = json.loads(json.dumps(SPEC))
    cell = "euroc_mono_l12.filter_batch_short"
    spec["configs"].append(dict(spec["configs"][0], name="euroc_mono_l12",
                                file="benchmark/configs/euroc_mono_l12.json"))
    spec["workloads"].append({"name": cell, "config": "euroc_mono_l12",
                              "traffic": "filter_batch_short", "chips": 1,
                              "why": "a test cell"})
    rate = next(m for m in spec["end_to_end"]
                if m["name"] == "filter_frames_per_s")
    rate["workloads"].append(cell)
    spec["per_layer"].append({"name": "filter_poses", "unit": "poses",
                              "better": "higher", "source": "host_clock",
                              "layer": "frame loops",
                              "moves": "filter_frames_per_s",
                              "workloads": [cell]})
    monkeypatch.setattr(harness, "HERE", root)
    run = small_run(cell, trace=True, spec=spec)
    assert run.cfg.tracker.max_tracking_length == 8   # the small override
    res = harness.run_cell(run, time.perf_counter())
    assert res["metrics"]["filter_poses"]["value"] > 0
    assert res["correct"] is True and set(res["checks"]) == {
        "pose_gap_m", "nonfinite_poses"}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    run = small_run("euroc_mono.set_replay", trace=trace)
    res = harness.run_cell(run, time.perf_counter())
    line = harness.result_line(res, {"platform": "cpu", "kind": "test",
                                     "count": 1})
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    json.loads(json.dumps(line, allow_nan=False))
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) >= {"replay_host_ms_per_frame"}
    else:
        assert set(line["metrics"]) == {"image_frames_per_s", "setup_s"}
        assert line["correct"] is True
    assert set(line["checks"]) == {k for k in run.limits
                                   if not k.startswith("about")}


def _faulty(kind: str):
    """A filter body that returns its state unchanged (``frozen``), leaves
    the second half of the batch out (its states stay as they were,
    ``half``), shifts the position it produces by 5 cm (``altered``),
    produces positions that are not finite from each sequence's first
    frame (``nan_first``) or from its fifth (``nan_later``), or does
    either of the first and third to the last sequence of the batch alone
    (``lane_frozen``, ``lane_altered``)."""
    from dataclasses import fields

    import torch

    from rvio_tpu_torch.runtime import step
    from rvio_tpu_torch.state.filter_state import FilterState
    orig = step._segment_body

    def keep_lanes(run, st, states):
        """``st`` where ``run`` (B,) holds, else ``states``."""
        B = run.shape[0]

        def keep(new, old):
            if not isinstance(new, torch.Tensor) or new.dim() == 0:
                return new
            m = run.reshape((B,) + (1,) * (new.dim() - 1))
            return torch.where(m.to(new.device), new, old)
        return FilterState(**{f.name: keep(getattr(st, f.name),
                                           getattr(states, f.name))
                              for f in fields(FilterState)})

    def make(*args, **kwargs):
        body = orig(*args, **kwargs)

        def faulty(states, bundles):
            st, out = body(states, bundles)
            p = out["p_Gk"]
            B = p.shape[0]
            last = (torch.arange(B) == B - 1).to(p.device)
            if kind == "frozen":
                return states, out
            if kind == "half":
                return keep_lanes(torch.arange(B) < max(B // 2, 1), st,
                                  states), out
            if kind == "lane_frozen":
                return keep_lanes(~last, st, states), out
            if kind.startswith("nan"):
                first = 0 if kind == "nan_first" else 4
                bad = (states.frame_idx >= first).reshape(B, 1)
                return st, dict(out, p_Gk=torch.where(
                    bad, torch.full_like(p, float("nan")), p))
            if kind == "lane_altered":
                return st, dict(out, p_Gk=p + 0.05 * last.reshape(B, 1))
            return st, dict(out, p_Gk=p + 0.05)
        return faulty
    return make


FAULTS = [(c, f) for c in CELLS
          for f in ("frozen", "half", "altered", "nan_first", "nan_later",
                    "lane_frozen", "lane_altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_in_the_timed_path_turns_correct_false(cell, fault,
                                                       monkeypatch):
    """The harness's look for a chip skipped, the rest of a run with the
    timed path broken underneath: ``correct`` comes out false.  (One
    chip a cell: no exchange between chips to leave out.)"""
    import rvio_tpu_torch.runtime.image_driver as image_driver
    from rvio_tpu_torch.runtime import step
    make = _faulty(fault)
    monkeypatch.setattr(step, "_segment_body", make)
    monkeypatch.setattr(image_driver, "_segment_body", make)
    run = small_run(cell)
    res = harness.run_cell(run, time.perf_counter())
    assert res["correct"] is False, res["checks"]
