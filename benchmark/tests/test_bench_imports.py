"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port (top-level names compared whole:
``rvio_tpu_torch`` is the port, ``rvio_tpu`` the JAX package)."""

import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def _modules(pattern: str, skip=("tests",)) -> list:
    mods = []
    for p in sorted(BENCH.rglob(pattern)):
        rel = p.relative_to(ROOT).with_suffix("")
        if any(part in skip for part in rel.parts) or "." in rel.name:
            continue
        mods.append(".".join(rel.parts).removesuffix(".__init__"))
    return mods


def _loaded_after(mods: list, run: str = "") -> list:
    """Top-level names in ``sys.modules`` of a fresh interpreter after it
    imports ``mods`` and runs ``run``."""
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n" + run +
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


# a whole small run of a cell on the CPU: what the port loads then
RUN = ("import time\n"
       "from benchmark import harness\n"
       "from benchmark.tests.conftest import small_run\n"
       "run = small_run('euroc_mono.filter_batch', trace=True)\n"
       "res = harness.run_cell(run, time.perf_counter())\n"
       "assert res['checks']\n")


def test_no_module_of_the_benchmark_loads_jax():
    mods = _modules("*.py")
    assert "benchmark.harness" in mods and "benchmark.drivers.set_replay" in mods
    top = _loaded_after(mods, RUN)
    for name in ("jax", "jaxlib", "flax", "rvio_tpu"):
        assert name not in top, name
    assert "rvio_tpu_torch" in top


def test_metric_readers_load_no_jax():
    from benchmark import harness
    code = ("import json, sys\nfrom benchmark import harness\n"
            "for m in harness.load_spec()['per_layer']:\n"
            "    harness.reader(m['name'])\n"
            "print(json.dumps(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "rvio_tpu")


def test_the_reference_imports_nothing_of_the_port():
    top = _loaded_after(["benchmark.reference.pipeline"]
                        + _modules("reference/**/*.py"))
    assert "rvio_tpu_torch" not in top and "rvio_tpu" not in top
    assert "jax" not in top
