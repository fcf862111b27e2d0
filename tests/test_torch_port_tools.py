"""The port's dataset and workflow tools, dispatcher and doctor against the
JAX package on the CPU: the ``microscopy`` and ``remix`` generators and
``make_dataset`` write the same bytes; ``analyse`` writes the same CSV as
the pandas one; the dispatcher routes every command to the port; doctor
passes with ``--device cpu`` and fails without it on a host with no card;
tiny ``--device cpu`` runs of make_pretrained, sweep, distill, scale_bench,
serve_bench and unmix_demo, with K1's plain twin counted where ``--fast``
runs."""

import contextlib
import glob
import io
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import crosstalk_tpu_torch.eval.fast_forward as ff
from crosstalk_tpu.cli import analyse as janalyse
from crosstalk_tpu.data import remix as jremix
from crosstalk_tpu.data import synthetic as jsynthetic
from crosstalk_tpu_torch.__main__ import main as dispatch
from crosstalk_tpu_torch.cli import analyse
from crosstalk_tpu_torch.data import remix, synthetic
from crosstalk_tpu_torch.data.pipeline import load_tiles
from crosstalk_tpu_torch.ops.input_block import fused_input_block_packed
from crosstalk_tpu_torch.tools import (
    distill,
    make_dataset,
    make_pretrained,
    scale_bench,
    serve_bench,
    sweep,
    unmix_demo,
)
from tests.torch_ref import TorchSingle, burn_in_batch_stats
from tools.make_dataset import main as jax_make_dataset

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--initial_filters", "8", "--num_conv_blocks", "3"]


@pytest.fixture
def count_k1_calls(monkeypatch):
    calls = {"n": 0}

    def counting(*a, **k):
        calls["n"] += 1
        return fused_input_block_packed(*a, **k)

    monkeypatch.setattr(ff, "fused_input_block_packed", counting)
    return calls


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools_data")
    assert make_dataset.main([str(root), "-n", "24", "--size", "32"]) == 0
    return str(root / "Mixed"), str(root / "Source")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    torch.manual_seed(5)
    model = burn_in_batch_stats(TorchSingle(initial_filters=8, num_blocks=3, image_size=32), 32)
    path = tmp_path_factory.mktemp("tools_ckpt") / "m.pth"
    torch.save(model.state_dict(), path)
    return str(path)


def _run(main_fn, argv):
    """-> (exit code, stdout) of a tool's ``main``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    return rc, buf.getvalue()


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("preset", ["uniform", "microscopy", "remix"])
def test_make_dataset_writes_the_jax_tools_files_and_bytes(preset, data, tmp_path):
    flags = ["-n", "5", "--size", "32", "--seed", "11", "--preset", preset]
    if preset == "remix":
        flags += ["--real_mixed", data[0], "--real_source", data[1], "--texture_split", "train"]
    ours, theirs = tmp_path / "ours", tmp_path / "jax"
    rc, out = _run(make_dataset.main, [str(ours), *flags])
    assert rc == 0
    jrc, jout = _run(jax_make_dataset, [str(theirs), *flags])
    assert jrc == 0 and out.replace(str(ours), "") == jout.replace(str(theirs), "")
    mine, want = _tree(ours), _tree(theirs)
    assert len(mine) == 10 and mine == want


def test_microscopy_pairs_and_remix_draws_equal_jax(data):
    for size in (32, 48):
        a = synthetic.generate_pair_microscopy(np.random.default_rng(size), size)
        b = jsynthetic.generate_pair_microscopy(np.random.default_rng(size), size)
        assert a[2] == b[2] and np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert remix.split_texture_ids(*data) == jremix.split_texture_ids(*data)
    bank, jbank = remix.RemixBank(*data), jremix.RemixBank(*data)
    rng, jrng = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(6):
        a, b = bank.pair(rng), jbank.pair(jrng)
        assert a[2] == b[2] and np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    with pytest.raises(ValueError, match="unknown preset") as e:
        synthetic.generate_dataset("unused", preset="nope")
    with pytest.raises(ValueError) as je:
        jsynthetic.generate_dataset("unused", preset="nope")
    assert str(e.value) == str(je.value)


def test_remix_bank_rejects_one_image_id_like_jax(data, tmp_path):
    one = sorted({s for s in os.listdir(data[0])})[0]
    image_id = one.split("_")[1]
    errors = []
    for bank in (remix.RemixBank, jremix.RemixBank):
        with pytest.raises(ValueError, match="distinct image ids") as e:
            bank(*data, image_ids=[image_id])
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ---- analyse: the same CSV as the JAX (pandas) analyser ------------------

@pytest.fixture(scope="module")
def train_runs(data, tmp_path_factory):
    """Two run dirs of the port's train CLI at 32 px (tiny model)."""
    from crosstalk_tpu_torch.cli.train import main as train_main

    base = tmp_path_factory.mktemp("runs")
    for bs, lr in (("4", "0.001"), ("8", "1e-05")):
        rc, _ = _run(train_main, ["-m", data[0], "-s", data[1], "-b", bs, "-l", lr, "-n", "2",
                                  "--compute_dtype", "f32", "--output_base", str(base),
                                  "--device", "cpu", *TINY])
        assert rc == 0
    return base


def _analyse_both(base: Path, tmp_path: Path):
    """-> [(exit code, CSV text or None)] of the port's and the JAX analyser."""
    out = []
    for name, main_fn in (("ours", analyse.main), ("jax", janalyse.main)):
        path = tmp_path / f"{name}.csv"
        rc, _ = _run(main_fn, ["-d", str(base), "-o", str(path)])
        out.append((rc, path.read_text() if path.exists() else None))
    return out


def _edge_case(kind: str, base: Path, train_runs: Path) -> None:
    """The JAX analyser tests' edge cases (tests/test_analyse_cli.py:73-108)
    as run dirs, and a sweep whose int columns hold a missing value."""
    if kind in ("port_runs", "empty_base"):
        return
    run = base / "training_run_2026-01-01_00-00-00_B8_LR0.1"
    run.mkdir(parents=True)
    if kind == "extra_metadata":
        (run / "training_log_x.csv").write_text(
            "some,meta\nmore,meta\neven,more,meta\n"
            "epoch,train_loss,val_loss,learning_rate\n"
            "1,0.5,0.4,0.001\n2,0.3,0.35,0.001\n3,,0.2,0.001\n")
        (run / "test_predictions_x.csv").write_text(
            "Actual_Label,Predicted_Label\n0.1,0.15\n0.3,0.2\n0.25,0.3125\n")
    elif kind == "bad_predictions":
        (run / "test_predictions_x.csv").write_text("not,a,valid\nprediction,file,at all\n")
    elif kind == "mixed_sweep":  # the port's runs beside a run with no files
        for d in train_runs.glob("training_run_*"):
            shutil.copytree(d, base / d.name)
        (base / "training_run_notes").mkdir()  # no batch size or lr in the name


@pytest.mark.parametrize("kind", ["port_runs", "extra_metadata", "missing_files",
                                  "empty_base", "bad_predictions", "mixed_sweep"])
def test_analyse_writes_the_jax_csv(kind, train_runs, tmp_path):
    base = train_runs if kind == "port_runs" else tmp_path / "base"
    base.mkdir(exist_ok=True)
    _edge_case(kind, base, train_runs)
    (rc, text), (jrc, jtext) = _analyse_both(base, tmp_path)
    assert rc == jrc == (1 if kind == "empty_base" else 0)
    assert text == jtext
    if kind == "port_runs":  # the values are the logs' own
        rows = [line.split(",") for line in text.splitlines()[1:]]
        assert [r[1] for r in rows] == ["4", "8"] and all(float(r[3]) > 0 for r in rows)
    if kind == "mixed_sweep":
        assert ".0," in text  # batch sizes promoted to floats beside a missing one


def test_skip_rows_and_header_discovery_match_pandas(tmp_path):
    log = tmp_path / "log.csv"
    log.write_text("Learning Rate,0.001\nBatch Size,8\nScheduler Type,onecycle\n"
                   "Scheduler Params,\"{'a': 1, 'b': 2}\"\n\n"
                   "epoch,train_loss,val_loss,learning_rate\n1,0.5,0.4,0.001\n")
    for col in ("epoch", "Batch Size", "missing"):
        assert analyse.skip_rows(str(log), col) == janalyse.skip_rows(str(log), col)
    assert analyse.analyze_training_log(str(log)) == janalyse.analyze_training_log(str(log))


# ---- the dispatcher -------------------------------------------------------

def test_dispatcher_usage_and_unknown_command(capsys):
    assert dispatch([]) == 1
    assert "usage: python -m crosstalk_tpu_torch" in capsys.readouterr().out
    assert dispatch(["--help"]) == 0
    out = capsys.readouterr().out
    assert "torch.export" in out and "StableHLO" not in out and "--device cpu" in out
    assert dispatch(["frobnicate"]) == 1
    assert "unknown command 'frobnicate'" in capsys.readouterr().out


@pytest.mark.parametrize("command,module", [
    ("train", "crosstalk_tpu_torch.cli.train"),
    ("evaluate", "crosstalk_tpu_torch.cli.evaluate"),
    ("eval", "crosstalk_tpu_torch.cli.evaluate"),
    ("test", "crosstalk_tpu_torch.cli.evaluate"),
    ("predict", "crosstalk_tpu_torch.cli.predict"),
    ("serve", "crosstalk_tpu_torch.cli.serve"),
    ("remote-eval", "crosstalk_tpu_torch.cli.remote_eval"),
    ("remote_eval", "crosstalk_tpu_torch.cli.remote_eval"),
    ("analyse", "crosstalk_tpu_torch.cli.analyse"),
    ("analyze", "crosstalk_tpu_torch.cli.analyse"),
    ("doctor", "crosstalk_tpu_torch.cli.doctor"),
    ("export", "crosstalk_tpu_torch.tools.export_model"),
])
def test_dispatcher_routes_every_command_to_the_port(command, module, monkeypatch):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, "main", lambda argv: (module, argv))
    assert dispatch([command, "-x", "1"]) == (module, ["-x", "1"])


# ---- doctor ---------------------------------------------------------------

def test_doctor_passes_on_the_cpu_with_a_checkpoint(ckpt):
    """In a process of its own, as a deployment runs it: this test process
    has imported JAX, which doctor reports as a FAIL (next test)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-m", "crosstalk_tpu_torch", "doctor", "--device",
                           "cpu", "-p", ckpt, "--image_size", "32"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    out = proc.stdout
    assert proc.returncode == 0, out + proc.stderr
    for check in ("imports", "no JAX", "devices", "kernel build cache", "native TIFF decoder",
                  "TIFF round-trip", "--fast forward", "checkpoint"):
        assert re.search(rf"^  ok    {re.escape(check)} ", out, re.M), check
    assert "initial_filters=8, num_conv_blocks=3, native 32px" in out
    assert "All checks passed" in out


def test_doctor_reports_jax_in_the_process_and_runs_k1s_twin(ckpt, count_k1_calls):
    rc, out = _run(dispatch, ["doctor", "--device", "cpu", "-p", ckpt, "--image_size", "32"])
    assert rc == 1 and re.search(r"^  FAIL  no JAX — imported in this process: crosstalk_tpu",
                                out, re.M)
    assert re.search(r"^  ok    --fast forward ", out, re.M)
    assert count_k1_calls["n"] == 2  # the two --fast forward calls


def test_doctor_fails_without_device_cpu_on_a_cudaless_host(monkeypatch, ckpt, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _run(dispatch, ["doctor", "-p", ckpt])
    assert rc == 1 and "FAIL  devices" in out and "--device cpu" in out
    assert "--fast forward" not in out  # nothing ran on a fallback device
    bad = tmp_path / "bad.pth"
    bad.write_bytes(b"not a checkpoint")
    rc, out = _run(dispatch, ["doctor", "--device", "cpu", "-p", str(bad)])
    assert rc == 1 and "FAIL  checkpoint" in out
    rc, out = _run(dispatch, ["doctor", "--device", "cpu", "--url", "http://127.0.0.1:1",
                              "--timeout", "0.2"])
    assert rc == 1 and "FAIL  serving endpoint" in out
    rc, out = _run(dispatch, ["doctor", "--device", "cpu", "--image_size", "7"])
    assert rc == 1 and "--image_size" in out


# ---- workflow tools, tiny runs on the CPU -------------------------------

def test_make_pretrained_writes_the_reference_artifact_name(data, tmp_path):
    out = tmp_path / "PreTrained_Model"
    rc, _ = _run(make_pretrained.main, ["-m", data[0], "-s", data[1], "-b", "8", "-l", "5e-4",
                                        "-n", "1", "-j", "2", "--out", str(out),
                                        "--device", "cpu", *TINY])
    assert rc == 0
    (pth,) = glob.glob(str(out / "crosstalk_regression_model_trained_*_8_0.0005.pth"))
    assert re.fullmatch(r"crosstalk_regression_model_trained_\d{4}-\d{2}-\d{2}_"
                        r"\d{2}-\d{2}-\d{2}_8_0\.0005\.pth", os.path.basename(pth))
    TorchSingle(initial_filters=8, num_blocks=3, image_size=32).load_state_dict(
        torch.load(pth, map_location="cpu", weights_only=True))


def test_sweep_runs_the_grid_and_analyses_it_like_jax(data, tmp_path):
    out = tmp_path / "sweep"
    rc, _ = _run(sweep.main, ["-m", data[0], "-s", data[1], "--batch_sizes", "4", "8",
                              "--learning_rates", "1e-3", "-n", "1", "-j", "2",
                              "--compute_dtype", "f32", "--output_base", str(out),
                              "--analyse", "--device", "cpu", *TINY])
    assert rc == 0
    runs = sorted(out.glob("training_run_*"))
    assert sorted(d.name.split("_B")[1] for d in runs) == ["4_LR0.001", "8_LR0.001"]
    text = (out / "training_analysis_results.csv").read_text()
    _run(janalyse.main, ["-d", str(out), "-o", str(tmp_path / "jax.csv")])
    assert text == (tmp_path / "jax.csv").read_text()
    assert len(text.splitlines()) == 3


def test_distill_trains_the_student_on_blended_labels(data, ckpt, tmp_path):
    base = tmp_path / "out"
    rc, out = _run(distill.main, ["-m", data[0], "-s", data[1], "-p", ckpt,
                                  "--initial_filters", "4", "--num_conv_blocks", "3",
                                  "-b", "8", "-n", "1", "-r", "onecycle", "--blend", "0.2",
                                  "-j", "2", "--output_base", str(base), "--device", "cpu"])
    assert rc == 0, out
    assert "Split sizes: Train = 16, Validation = 3, Test = 5" in out  # 70/15/15, seed 43
    (run_dir,) = glob.glob(str(base / "training_run_*"))
    for pattern in ("params.txt", "model_architecture.txt", "training_log_*.csv",
                    "best_model_onecycle.pth", "crosstalk_regression_model_trained_*.pth",
                    "test_predictions_*.csv", "train_predictions_*.csv",
                    "val_predictions_*.csv"):
        assert glob.glob(os.path.join(run_dir, pattern)), pattern
    assert "distilled_from" in Path(run_dir, "params.txt").read_text()
    (student,) = glob.glob(os.path.join(run_dir, "crosstalk_regression_model_trained_*.pth"))
    TorchSingle(initial_filters=4, num_blocks=3, image_size=32).load_state_dict(
        torch.load(student, map_location="cpu", weights_only=True))
    # the scoreboard uses the TRUE labels: the train CSV's labels are the files'
    (train_csv,) = glob.glob(os.path.join(run_dir, "train_predictions_*.csv"))
    labels = sorted(float(line.split(",")[0]) for line in open(train_csv).read().split()[1:])
    alphas = sorted(float(os.path.basename(p).split("_")[3]) for p in os.listdir(data[0]))
    assert set(np.round(labels, 2)) <= set(alphas)
    rc, out = _run(distill.main, ["-m", data[0], "-s", data[1], "-p", ckpt, "--blend", "1.5",
                                  "--device", "cpu"])
    assert rc == 1 and "--blend" in out


@pytest.mark.parametrize("feed_only", [False, True])
def test_scale_bench_reports_the_cache_build_and_the_epoch(feed_only, tmp_path):
    before = dict(load_tiles.decoded)
    argv = ["-n", "16", "-b", "4", "--epochs", "1", "--size", "32", "--device", "cpu", *TINY,
            "--data_dir", str(tmp_path / "d")] + (["--feed_only"] if feed_only else [])
    rc, out = _run(scale_bench.main, argv)
    assert rc == 0
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["device"] == "cpu" and summary["cpu_count"] == os.cpu_count()
    build = summary["cache_build"]
    assert build["cold"] and build["pairs"] == 16 and build["decoded"] == {"native": 16,
                                                                          "python": 0}
    assert load_tiles.decoded["native"] - before["native"] == 16
    key = "feed_epochs" if feed_only else "epochs"
    assert summary[key][0]["tiles"] == 16 and summary[key][0]["tiles_per_s"] > 0
    assert feed_only or np.isfinite(summary["epochs"][0]["loss"])


def test_serve_bench_serves_through_k1s_twin(ckpt, count_k1_calls):
    rc, out = _run(serve_bench.main, ["-p", ckpt, "--image_size", "32", "--batch_size", "4",
                                      "--clients", "3", "--tiles_per_request", "2",
                                      "--seconds", "1.5", "--device", "cpu"])
    assert rc == 0, out
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["device"] == "cpu" and stats["tiles_per_sec"] > 0 and stats["requests"] > 0
    assert 0 < stats["latency_ms_p50"] <= stats["latency_ms_p99"] <= stats["latency_ms_max"]
    assert 0 < stats["batch_occupancy"] <= 1
    assert count_k1_calls["n"] == stats["batches"] + 1  # and the bucket's warmup


def test_unmix_demo_scores_through_predict_fast(ckpt, count_k1_calls, tmp_path):
    png = tmp_path / "demo.png"
    rc, out = _run(unmix_demo.main, ["-p", ckpt, "-o", str(png), "--pairs", "2", "--size", "32",
                                     "--device", "cpu", *TINY])
    assert rc == 0, out
    summary = json.loads(out.strip().splitlines()[-1])
    assert set(summary) == {"pairs", "mean_abs_alpha_err", "mean_bleed_removed_pct", "png"}
    assert summary["pairs"] == 2 and np.isfinite(summary["mean_bleed_removed_pct"])
    assert count_k1_calls["n"] >= 1  # predict --fast ran block 0 through K1's entry
    assert summary["png"] is None or os.path.getsize(png) > 10_000
