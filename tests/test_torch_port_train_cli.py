"""The port's train CLI on the CPU (``--device cpu``) against the JAX
package's: 24 seeded 32 px pairs, a width-8 single-branch model with 3
blocks, ``-b 8``. Checks the artifact names, the split, resume (equal to
the uninterrupted run, flips and dropout on), the usage errors, the JAX
analyser on the port's run directory, and the quickstart dataset."""

import csv
import glob
import os
import re

import numpy as np
import pytest
import torch

from tests.conftest import make_synthetic_dataset

SMALL = ["-b", "8", "--initial_filters", "8", "--num_conv_blocks", "3", "-j", "2"]
TS = re.compile(r"\d{4}-\d{2}-\d{2}_\d{2}-\d{2}-\d{2}")


def port_train(argv):
    from crosstalk_tpu_torch.cli.train import main

    return main([*argv, "--device", "cpu"])


def run_dir_of(base):
    (path,) = glob.glob(os.path.join(base, "training_run_*"))
    return path


def names(run_dir):
    """Every file under a run directory, timestamps replaced by TS."""
    out = set()
    for root, _, files in os.walk(run_dir):
        for f in files:
            out.add(TS.sub("TS", os.path.relpath(os.path.join(root, f), run_dir)))
    return out


def log_rows(run_dir):
    (path,) = glob.glob(os.path.join(run_dir, "training_log_*.csv"))
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    mixed, source = make_synthetic_dataset(str(root), n=24, size=32, seed=5)
    return root, mixed, source


@pytest.fixture(scope="module")
def port_run(data):
    root, mixed, source = data
    base = str(root / "port")
    rc = port_train(["-m", mixed, "-s", source, *SMALL, "-n", "2", "-r", "onecycle",
                     "--output_base", base])
    assert rc == 0
    return run_dir_of(base)


def test_artifact_names_equal_the_jax_cli(data, port_run):
    from crosstalk_tpu.cli.train import main as jax_train

    root, mixed, source = data
    base = str(root / "jax")
    rc = jax_train(["-m", mixed, "-s", source, *SMALL, "-n", "2", "-r", "onecycle",
                    "--output_base", base, "--num_devices", "1"])
    assert rc == 0
    jax_dir = run_dir_of(base)
    assert TS.sub("TS", os.path.basename(port_run)) == TS.sub("TS", os.path.basename(jax_dir))
    assert names(port_run) == names(jax_dir)
    assert "best_model_onecycle.pth" in names(port_run)

    rows = log_rows(port_run)
    assert rows[:4] == log_rows(jax_dir)[:4]  # the metadata rows
    assert rows[4] == ["epoch", "train_loss", "val_loss", "learning_rate"]
    assert [r[0] for r in rows[5:]] == ["1", "2"]
    assert all(np.isfinite(float(v)) for r in rows[5:] for v in r[1:])
    for split in ("test", "train", "val"):
        (pred,) = glob.glob(os.path.join(port_run, f"{split}_predictions_*_8_0.0001.csv"))
        with open(pred) as f:
            assert next(csv.reader(f)) == ["Actual_Label", "Predicted_Label"]


def test_final_pth_loads_into_build_model_and_jax(port_run):
    from crosstalk_tpu.io.torch_convert import load_pth as jax_load_pth
    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.models.registry import build_model

    for pattern in ("crosstalk_regression_model_trained_*.pth", "best_model_*.pth"):
        (path,) = glob.glob(os.path.join(port_run, pattern))
        model = build_model(ModelConfig(initial_filters=8, num_conv_blocks=3), image_size=32)
        model.load_state_dict(load_pth(path))  # strict
        jax_load_pth(path, "single")


def test_split_equals_the_jax_split(data):
    from crosstalk_tpu.data.index import PairIndex as JPairIndex
    from crosstalk_tpu.data.index import split_samples as jsplit
    from crosstalk_tpu_torch.data.index import PairIndex, split_samples

    _, mixed, source = data
    for ratios, seed in (((0.7, 0.15), 43), ((0.5, 0.3), 7)):
        ours = split_samples(PairIndex(mixed, source).samples, *ratios, seed=seed)
        theirs = jsplit(JPairIndex(mixed, source).samples, *ratios, seed=seed)
        assert [[s.mixed_path for s in part] for part in ours] == [
            [s.mixed_path for s in part] for part in theirs]


def test_resume_equals_the_uninterrupted_run(data):
    """-n 2 then --resume to -n 3 == -n 3 in one go, exactly, with flips and
    dropout (0.1) on."""
    root, mixed, source = data
    common = ["-m", mixed, "-s", source, *SMALL, "--compute_dtype", "f32"]
    assert port_train([*common, "-n", "3", "--output_base", str(root / "whole")]) == 0
    assert port_train([*common, "-n", "2", "--output_base", str(root / "cut")]) == 0
    cut = run_dir_of(str(root / "cut"))
    # the resume invocation omits -b: it is adopted from params.txt
    assert port_train(["-m", mixed, "-s", source, "-n", "3", "--resume", cut]) == 0
    whole = run_dir_of(str(root / "whole"))

    assert log_rows(cut)[5:] == log_rows(whole)[5:]
    assert len(log_rows(cut)) == 5 + 3
    assert os.path.exists(os.path.join(cut, "params_resume.txt"))

    from crosstalk_tpu_torch.io.checkpoint import load_checkpoint

    (p_cut, m_cut), (p_whole, m_whole) = load_checkpoint(cut), load_checkpoint(whole)
    for meta in (m_cut, m_whole):
        meta.pop("state_sha256")
    assert m_cut == m_whole and m_cut["epoch"] == 3
    assert p_cut["step"] == p_whole["step"] == 3 * 2
    for part in ("model", "optimizer"):
        a, b = p_cut[part], p_whole[part]
        if part == "optimizer":
            assert a["param_groups"] == b["param_groups"]
            a, b = ({f"{i}.{k}": v for i, s in d["state"].items() for k, v in s.items()}
                    for d in (a, b))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_resume_without_checkpoints_exits_1(data, tmp_path, capsys):
    _, mixed, source = data
    fake = tmp_path / "training_run_fake_B8_LR0.001"
    fake.mkdir()
    (fake / "params.txt").write_text("batch_size: 8\n")
    rc = port_train(["-m", mixed, "-s", source, "-n", "3", "--resume", str(fake)])
    assert rc == 1
    assert "no checkpoints under" in capsys.readouterr().out


@pytest.mark.parametrize("flags,name", [
    (["-b", "0"], "--batch_size"),
    (["-n", "0"], "--num_epochs"),
    (["-l", "-0.1"], "--learning_rate"),
    (["--checkpoint_every", "0"], "--checkpoint_every"),
    (["--grad_accum", "0"], "--grad_accum"),
])
def test_nonpositive_flags_exit_1(flags, name, capsys):
    assert port_train(["-m", "M", "-s", "S", *flags]) == 1
    assert f"{name} must be positive" in capsys.readouterr().out


MULTIHOST = ["--multihost", "--coordinator_address", "localhost:1"]


@pytest.mark.parametrize("flags", [
    (["--num_devices", "0"], "--num_devices 0 requested but only"),
    (["--num_devices", "100000"], "--num_devices 100000 requested but only"),
    (["--multihost"], "needs the coordinator address"),
    (["--coordinator_address", "localhost:1234"], "needs the process count"),
    ([*MULTIHOST, "--num_processes", "2", "--process_id", "2"],
     "process id 2 is outside 0..1"),
    ([*MULTIHOST, "--num_processes", "1", "--process_id", "0", "--num_devices", "2"],
     "--num_devices 2 must equal --num_processes 1"),
    (["--num_devices", "2", "--data_placement", "device"],
     "--data_placement device is single-device only"),
    (["--num_devices", "2", "-b", "6", "--grad_accum", "2"],
     "per-device batch 3 must divide by --grad_accum 2"),
])
def test_unported_flags_exit_1(flags, tmp_path, capsys):
    """The data-parallel and multi-host flags' usage errors, as the JAX CLI
    reports them (cli/train.py:196-201, :403-408, :445-449), before any
    rank starts or anything is written."""
    flags, message = flags
    rc = port_train(["-m", "M", "-s", "S", "--output_base", str(tmp_path), *flags])
    assert rc == 1
    out = capsys.readouterr().out
    assert out.startswith("Error") and message in out
    assert not list(tmp_path.glob("training_run_*"))


def test_other_usage_errors_exit_1(data, tmp_path, capsys):
    _, mixed, source = data
    base = ["-m", mixed, "-s", source, "--output_base", str(tmp_path)]
    assert port_train([*base, "-o", "double", "--num_conv_blocks", "3"]) == 1
    assert port_train([*base, "--dropout", "1.0"]) == 1
    assert port_train([*base, "-b", "6", "--grad_accum", "4"]) == 1
    out = capsys.readouterr().out
    assert "--num_conv_blocks applies" in out and "--dropout must be" in out
    assert "must divide by --grad_accum 4" in out


def test_jax_analyser_reads_the_port_run(port_run):
    from crosstalk_tpu.cli.analyse import analyze_training_directory

    (row,) = analyze_training_directory(os.path.dirname(port_run))
    assert row["batch_size"] == 8 and row["learning_rate"] == 1e-4
    assert row["min_val_epoch"] in (1, 2)
    for key in ("min_train_loss", "min_val_loss", "test_mse"):
        assert np.isfinite(row[key])


def test_generate_dataset_writes_the_jax_bytes(tmp_path):
    from crosstalk_tpu.data.synthetic import generate_dataset as jax_generate
    from crosstalk_tpu_torch.data.synthetic import generate_dataset

    generate_dataset(str(tmp_path / "port"), num_pairs=3, size=20, seed=9,
                     progress_every=0, block=4)
    jax_generate(str(tmp_path / "jax"), num_pairs=3, size=20, seed=9,
                 progress_every=0, block=4)
    for sub in ("Mixed", "Source"):
        files = sorted(os.listdir(tmp_path / "port" / sub))
        assert files == sorted(os.listdir(tmp_path / "jax" / sub)) and len(files) == 3
        for f in files:
            assert ((tmp_path / "port" / sub / f).read_bytes()
                    == (tmp_path / "jax" / sub / f).read_bytes())


def test_quickstart_bootstraps_the_sample_dataset(tmp_path, monkeypatch):
    """Zero data flags and no ./Training_Data: the CLI writes the 100-pair
    set (shrunk here to 12 pairs of 32 px) and trains on it; a second run
    reuses it."""
    import crosstalk_tpu_torch.data.synthetic as synthetic

    real_generate = synthetic.generate_dataset
    calls = []

    def small_generate(out_dir, num_pairs=100, size=256, seed=0, **kw):
        calls.append((num_pairs, size, seed))
        return real_generate(out_dir, num_pairs=12, size=32, seed=seed,
                             progress_every=0)

    monkeypatch.setattr(synthetic, "generate_dataset", small_generate)
    monkeypatch.chdir(tmp_path)
    argv = [*SMALL, "-b", "4", "-n", "1"]
    assert port_train(argv) == 0
    assert calls == [(100, 256, 0)]  # the real quickstart parameters
    assert len(list((tmp_path / "Training_Data" / "Mixed").glob("*.tif"))) == 12
    assert port_train(argv) == 0
    assert len(calls) == 1  # reused, not regenerated
    assert len(list(tmp_path.glob("training_run_*"))) >= 1
