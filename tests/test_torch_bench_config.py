"""The port bench's knobs (rvio_tpu_torch/bench.py ``bench_config``)
build the config that bench.py's own lines build (bench.py:81-95, read out
of ``bench.main`` and run on their own, without the benchmark), field by
field, for each knob alone, together, and BASELINE.json's stress config."""

import dataclasses
import inspect
import textwrap
import types

import pytest
import torch

import bench
from rvio_tpu.config import RVIOConfig as JaxConfig
from rvio_tpu_torch.bench import bench_config

torch.set_num_threads(1)


def _bench_py_config(env: dict):
    """bench.py's config step: the lines of ``bench.main`` from its
    ``BENCH_COMPRESSION`` read to its ``TpuConfig`` replacement, run with
    ``env`` as the environment."""
    lines = inspect.getsource(bench.main).splitlines()
    first = next(i for i, ln in enumerate(lines) if "BENCH_COMPRESSION" in ln)
    last = next(i for i, ln in enumerate(lines)
                if ln.strip().startswith("cfg = cfg.replace(tpu="))
    code = textwrap.dedent("\n".join(lines[first:last + 1]))
    ns = {"os": types.SimpleNamespace(environ=env), "RVIOConfig": JaxConfig}
    exec(code, ns)
    return ns["cfg"]


@pytest.mark.parametrize("env", [
    {}, {"BENCH_FEATURES": "800"}, {"BENCH_KLT_LEVELS": "4"},
    {"BENCH_FEATURES": "800", "BENCH_KLT_LEVELS": "4"},
    {"BENCH_COMPRESSION": "qr"},
    {"BENCH_FEATURES": "0", "BENCH_KLT_LEVELS": "0",
     "BENCH_COMPRESSION": "qr"}])
def test_knobs_build_bench_py_config(env):
    got = dataclasses.asdict(bench_config(env))
    want = dataclasses.asdict(_bench_py_config(env))
    assert got == want
    if env.get("BENCH_FEATURES") == "800":
        assert got["tracker"]["num_features"] == 800
    assert got["tpu"]["compression"] == env.get("BENCH_COMPRESSION",
                                                "cholesky")
