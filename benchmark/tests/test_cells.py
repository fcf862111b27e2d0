"""Whole runs of every cell on the CPU at a tiny size, past the harness's
look for a card: the result line, a cell added by files alone, and the
comparison that decides ``correct`` seeing each planted fault of the timed
path (the drivers' variants)."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT, SMALL, tiny_run

CELLS = sorted(SMALL)
FAULTS = [("single.score-b64", "altered"),
          ("single.train-b256", "unchanged"), ("single.train-b256", "half_batch"),
          ("single.train-b256", "late_change"),
          ("double.train-b256", "unchanged"), ("double.train-b256", "half_batch"),
          ("double.train-b256", "late_change")]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_prints_its_result_line(name):
    run = harness.execute(tiny_run(name, **SMALL[name]))
    line = harness.result_line(run)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in run.cell.end_to_end}
    assert set(line["metrics"]) == want and "setup_s" in want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    json.loads(json.dumps(line))


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    run = harness.execute(tiny_run(name, variant=fault, **SMALL[name]))
    assert run.correct is False, run.checks


@pytest.mark.parametrize("name", ["single.score-b64", "single.train-b256"])
def test_a_traced_run_reports_the_cell_s_per_layer_metrics(name):
    run = tiny_run(name, **SMALL[name])
    run.trace = True
    line = harness.result_line(harness.execute(run))
    allowed = {m["name"] for m in run.cell.per_layer}
    assert line["metrics"] and set(line["metrics"]) <= allowed
    assert "window_s" in line["device"] and "breakdown" in line


def test_a_cell_added_by_files_alone_is_found(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR / "configs", base / "configs")
    shutil.copytree(harness.BENCH_DIR / "metrics", base / "metrics")
    (base / "traffic").mkdir()
    (base / "workloads").mkdir()
    (base / "traffic" / "score-b16.json").write_text(json.dumps(
        {"kind": "score", "tiles": 32, "batch_size": 16, "calibration_tiles": 16,
         "metric_sample": 4}))
    (base / "workloads" / "double.score-b16.json").write_text(json.dumps(
        {"limits": {"pred_gap": 0.5, "metrics_gap": 1e-3}}))
    (base / "metrics" / "tiles_per_window.score.py").write_text(
        "def read(run):\n    return run.work.get('tiles')\n")
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    bench["workloads"].append({"name": "double.score-b16", "config": "double",
                               "traffic": "score-b16", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("double.score-b16")
    bench["per_layer"].append({"name": "tiles_per_window.score", "unit": "tiles",
                               "better": "higher", "source": "program_counter",
                               "layer": "engine", "moves": "score_tiles_per_s",
                               "workloads": ["double.score-b16"]})
    cell = harness.load_cell("double.score-b16", bench, base)
    assert cell.kind == "score" and cell.params["batch_size"] == 16
    assert [m["name"] for m in cell.per_layer] == ["tiles_per_window.score"]
    assert harness.reader("tiles_per_window.score", base) is not None
    assert harness.reader("device_idle.score", base) is not None  # a quantity's reader


def test_run_py_refuses_a_host_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "single.score-b64", "--seed", str(2**31 + 9), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_run_py_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "single.score-b64", "--seed", "3", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
