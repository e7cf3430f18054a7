"""The readers of the program's own spans and counts
(benchmark/program_trace.py, metrics/*_ms_per_frame*.py): each divides
its spans' host time over the window's passes (the marks of its driver
call) by its pose count there, and reads None where the program has no
such span, count or marks."""

from types import SimpleNamespace

import pytest

from benchmark import harness, program_trace
from rvio_tpu_torch.utils import profiling

# metric -> (the driver call it marks, spans it reads, the count it
# divides by)
READS = {
    "replay_init_ms_per_frame": ("replay.pass", ["replay.init"],
                                 "replay.poses"),
    "replay_assemble_ms_per_frame": ("replay.pass", ["replay.assemble"],
                                     "replay.poses"),
    "replay_upload_ms_per_frame": ("replay.pass", ["replay.upload"],
                                   "replay.poses"),
    "replay_readback_ms_per_frame": ("replay.pass", ["replay.readback"],
                                     "replay.poses"),
    "replay_rows_ms_per_frame": ("replay.pass", ["replay.rows"],
                                 "replay.poses"),
    "graph_capture_ms_per_frame.image": (
        "replay.pass", ["frame_scan.warm", "frame_scan.capture"],
        "replay.poses"),
    "graph_launch_ms_per_frame.image": ("replay.pass", ["frame_scan.replay"],
                                        "replay.poses"),
    "graph_launch_ms_per_frame.filter": (
        "sequence_scan.call", ["frame_scan.replay"], "sequence_scan.poses"),
    "scan_host_ms_per_frame.filter": (
        "sequence_scan.call", ["sequence_scan.pack", "sequence_scan.split"],
        "sequence_scan.poses"),
}


def _run(passes):
    return SimpleNamespace(counters={"passes": passes})


def _fake(monkeypatch, call, marks):
    monkeypatch.setattr(profiling, "marks",
                        lambda name: list(marks) if name == call else [])


@pytest.mark.parametrize("metric", sorted(READS))
def test_each_reader_reads_its_spans(metric, monkeypatch):
    """Marks of a set-up call, two window passes and a traced call: the
    reader takes the window's difference alone (the set-up's and the
    traced call's spans, ten times as long, stay out)."""
    call, spans, poses = READS[metric]

    def mark(k, scale):
        got = {s: (int(scale * 250_000_000 * (i + 1)), k * 3)
               for i, s in enumerate(spans)}
        got[poses] = (0, 500 * k)
        got["other.span"] = (7 * k, k)
        return got
    setup, traced = mark(1, 10), mark(4, 10)
    window = [mark(2, 11), mark(3, 12)]
    _fake(monkeypatch, call, [setup, *window, traced])
    # the window's passes: 2 x 500 poses, each span 2 x 0.25 (i + 1) s
    want = 1e3 * sum(0.5 * (i + 1) for i in range(len(spans))) / 1000
    assert harness.reader(metric)(_run(2)) == pytest.approx(want)
    spec = {m["name"]: m for m in harness.load_spec()["per_layer"]}
    assert spec[metric]["source"] == "program_span"
    assert spec[metric]["unit"] == "ms"


def test_nothing_to_read_reads_none(monkeypatch):
    call, span = "replay.pass", ["frame_scan.replay"]
    no_poses = {"frame_scan.replay": (10**8, 4)}
    _fake(monkeypatch, call, [{}, no_poses, no_poses])
    assert program_trace.ms_per_pose(_run(1), call, span,
                                     "replay.poses") is None
    poses = {"replay.poses": (0, 9)}
    _fake(monkeypatch, call, [{}, poses, poses])
    assert program_trace.ms_per_pose(_run(1), call, span,
                                     "replay.poses") is None
    # marks that do not reach back before the window's passes
    full = {"replay.poses": (0, 9), "frame_scan.replay": (10**8, 4)}
    _fake(monkeypatch, call, [full, full])
    assert program_trace.ms_per_pose(_run(1), call, span,
                                     "replay.poses") is None
    monkeypatch.delattr(profiling, "marks")
    assert program_trace.marks(call) is None
    assert program_trace.ms_per_pose(_run(1), call, ["replay.init"],
                                     "replay.poses") is None


def test_the_window_from_the_program_marks():
    """The program's own marks: the window of two passes between a first
    and a last call holds those two passes' spans and poses alone."""
    profiling.reset()
    try:
        for poses in (1, 10, 100, 1000):
            with profiling.span("replay.rows"):
                pass
            profiling.add("replay.poses", poses)
            profiling.mark("replay.pass")
        got = program_trace.window(_run(2), "replay.pass")
        assert got["replay.rows"][1] == 2 and got["replay.poses"][1] == 110
        assert got["replay.rows"][0] >= 0
        assert harness.reader("replay_rows_ms_per_frame")(_run(2)) >= 0
    finally:
        profiling.reset()
