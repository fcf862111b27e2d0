"""Nothing the benchmark loads is JAX or the JAX package, and the reference
loads nothing of the program. Each check runs in a fresh process; module
names are compared by their whole top-level name, since the program
(``crosstalk_tpu_torch``) starts with the letters of the JAX package."""

import json
import subprocess
import sys

from benchmark.tests.conftest import ROOT

_PROBE = """
import json, sys, importlib, pkgutil
sys.path.insert(0, {root!r})
for name in {modules!r}:
    importlib.import_module(name)
if {metrics}:
    from benchmark import harness
    for p in sorted((harness.BENCH_DIR / "metrics").glob("*.py")):
        harness._load_file(p)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_level(modules, metrics=False):
    code = _PROBE.format(root=str(ROOT), modules=modules, metrics=metrics)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    from benchmark.harness import FORBIDDEN

    loaded = _top_level(["benchmark.run", "benchmark.harness", "benchmark.drivers.score",
                         "benchmark.drivers.train", "benchmark.drivers.serve",
                         "benchmark.drivers.serve_load", "benchmark.sweep_serve",
                         "benchmark.readings", "benchmark.reference.model",
                         "benchmark.reference.train", "benchmark.reference.metrics"],
                        metrics=True)
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(["benchmark.reference.model", "benchmark.reference.train",
                         "benchmark.reference.metrics", "benchmark.reference.rules"])
    assert "crosstalk_tpu_torch" not in loaded and "crosstalk_tpu" not in loaded


def test_a_run_loads_no_jax():
    """A whole cell, driven on the CPU, leaves no JAX module behind."""
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
from benchmark.tests.conftest import tiny_run, SMALL
from benchmark import harness
run = harness.execute(tiny_run("single.score-b64", **SMALL["single.score-b64"]))
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=600)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
