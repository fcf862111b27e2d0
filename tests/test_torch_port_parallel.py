"""Data parallelism of the port inside one process, on the CPU: the replica
set (``parallel/mesh.py``) behind the eval, predict and serve CLIs, the
rank helpers of ``parallel/distributed.py`` without a cluster, the
cross-replica BatchNorm's ``repr`` and keys, the ``--num_devices`` checks,
and ``--profile`` / ``--debug_nans`` (utils/profiling.py) on eval and train.

Tolerances: a replica set against one device on the same rows, 1e-6 (the
same kernels on the same per-device shapes give the same bits; a whole
batch on one device sums in other orders); against the JAX mesh predictor,
5e-4 on the bf16 ``--fast`` path (two bf16 forwards, the port's with the
fused input block) and 1e-5 in float32.
"""

import csv
import glob
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from crosstalk_tpu_torch.config import ModelConfig
from crosstalk_tpu_torch.io.torch_convert import load_pth
from crosstalk_tpu_torch.parallel import distributed, mesh
from tests.conftest import make_synthetic_dataset
from tests.torch_ref import TorchSingle, burn_in_batch_stats

ROOT = Path(__file__).resolve().parents[1]
PX = 32
CPU = torch.device("cpu")
FAST_TOL = 5e-4
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    mixed, source = make_synthetic_dataset(str(root), n=10, size=PX, seed=3)
    torch.manual_seed(4)
    model = burn_in_batch_stats(TorchSingle(initial_filters=8, num_blocks=3, image_size=PX),
                                PX, steps=2)
    ckpt = str(root / "single.pth")
    torch.save(model.state_dict(), ckpt)
    return root, mixed, source, ckpt


def _cfg(fast):
    return ModelConfig(initial_filters=8, num_conv_blocks=3,
                       compute_dtype="bf16" if fast else "f32")


def _tiles(n, seed=0):
    return (np.random.default_rng(seed).random((n, PX, PX, 2)) * 1800 + 100).astype(np.float32)


# --- parallel/mesh.py and parallel/distributed.py ---------------------------

def test_data_mesh_lists_devices_and_refuses_more_than_are_visible(monkeypatch):
    assert mesh.data_mesh(3, "cpu") == [CPU] * 3
    assert mesh.data_mesh(device_type="cpu") == [CPU] * (os.cpu_count() or 1)
    with pytest.raises(ValueError, match=r"requested 100000 devices, only \d+ available"):
        mesh.data_mesh(100000, "cpu")
    with pytest.raises(ValueError, match="need at least 1"):
        mesh.data_mesh(0, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.data_mesh(1, "cuda") == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        mesh.data_mesh(2, "cuda")
    assert mesh.maybe_data_mesh("cuda") is None and mesh.maybe_data_mesh("cpu") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.maybe_data_mesh("cuda") == [torch.device("cuda", i) for i in range(4)]


def test_cluster_spec_reads_the_flags_then_the_environment(monkeypatch):
    for name in ("CROSSTALK_COORDINATOR", "CROSSTALK_NUM_PROCESSES", "CROSSTALK_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.cluster_spec("h:1", 4, 3) == ("h:1", 4, 3)
    with pytest.raises(ValueError, match="needs the coordinator address"):
        distributed.cluster_spec(None, 2, 0)
    with pytest.raises(ValueError, match="process id 2 is outside 0..1"):
        distributed.cluster_spec("h:1", 2, 2)
    monkeypatch.setenv("CROSSTALK_COORDINATOR", "env:2")
    monkeypatch.setenv("CROSSTALK_NUM_PROCESSES", "3")
    monkeypatch.setenv("CROSSTALK_PROCESS_ID", "1")
    assert distributed.cluster_spec() == ("env:2", 3, 1)
    assert distributed.cluster_spec("flag:3", None, 0) == ("flag:3", 3, 0)
    assert distributed.default_backend("cuda") == "nccl"
    assert distributed.default_backend("cpu") == "gloo"


def test_rank_helpers_outside_and_inside_a_world(monkeypatch):
    assert not torch.distributed.is_initialized()
    assert distributed.world_size() == 1 and distributed.rank() == 0
    assert distributed.is_primary()
    assert distributed.process_row_slice(8) == slice(0, 8)
    tree = ({"a": torch.arange(3.0)}, [np.ones(2, np.int64)])
    got = distributed.allgather_to_host(tree)
    assert isinstance(got[0]["a"], np.ndarray) and got[0]["a"].tolist() == [0, 1, 2]
    assert got[1][0].dtype == np.int64
    assert distributed.rank_device("cpu") == CPU
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.rank_device("cuda") == torch.device("cuda", 3)
    # rank 1 of 2 owns the second half of every global batch
    monkeypatch.setattr(distributed, "world_size", lambda group=None: 2)
    monkeypatch.setattr(distributed, "rank", lambda group=None: 1)
    assert distributed.process_row_slice(8) == slice(4, 8)
    assert not distributed.is_primary()
    with pytest.raises(ValueError, match="global batch size 7 must divide across 2"):
        distributed.process_row_slice(7)


def test_iterate_batches_assembles_only_this_ranks_rows(setup):
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import TileStore, iterate_batches

    _, mixed, source, _ = setup
    store = TileStore(PairIndex(mixed, source).samples)
    whole = list(iterate_batches(store, 4, shuffle=True, seed=2, epoch=1))
    for rows in (slice(0, 2), slice(2, 4)):
        part = list(iterate_batches(store, 4, shuffle=True, seed=2, epoch=1, assemble_rows=rows))
        assert len(part) == len(whole) == 3
        for p, w in zip(part, whole):
            for a, b in zip(p, w):
                np.testing.assert_array_equal(a, b[rows])


def test_cross_replica_batchnorm_keeps_the_repr_keys_and_eval_forward():
    from crosstalk_tpu_torch.models import layers
    from crosstalk_tpu_torch.models.registry import build_model, torch_style_repr

    for variant in ("single", "double"):
        cfg = ModelConfig(variant=variant, initial_filters=8, num_conv_blocks=3,
                          initial_filters_per_branch=4)
        plain = build_model(cfg, image_size=PX)
        group = object()  # stands for a process group: only train mode uses it
        synced = build_model(cfg, image_size=PX, process_group=group)
        assert str(synced) == str(plain) == torch_style_repr(cfg, image_size=PX)
        bns = [m for m in synced.modules() if isinstance(m, layers._CrossReplicaBatchNorm)]
        assert bns and all(m.process_group is group for m in bns)
        assert not any(isinstance(m, layers._CrossReplicaBatchNorm) for m in plain.modules())
        synced.load_state_dict(plain.state_dict())
        assert list(synced.state_dict()) == list(plain.state_dict())
        x = torch.rand(3, 2, PX, PX)
        torch.testing.assert_close(synced.eval()(x), plain.eval()(x), rtol=0, atol=0)


# --- the replica set --------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True], ids=["f32", "fast"])
def test_replicated_forward_equals_one_device(setup, fast):
    from crosstalk_tpu_torch.io.export import make_forward

    *_, ckpt = setup
    sd = load_pth(ckpt)

    def replica(d):
        return make_forward(_cfg(fast), sd, fast=fast, image_size=PX, device=d)

    one = replica(CPU)
    two = mesh.replicated_forward(replica, [CPU, CPU])
    assert two.replicas == 2
    x = torch.from_numpy(_tiles(8))
    with torch.inference_mode():
        got = two(x)
        halves = torch.cat([one(x[:4]), one(x[4:])])
        whole = one(x)
    assert torch.equal(got, halves)
    torch.testing.assert_close(got, whole, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="batch size 7 must divide across the 2 replicas"):
        two(x[:7])


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "fast"])
def test_replica_predictor_equals_one_replica_and_the_jax_mesh_predictor(setup, fast):
    from crosstalk_tpu.io.torch_convert import load_pth as jax_load_pth
    from crosstalk_tpu.parallel.mesh import data_mesh as jax_data_mesh
    from crosstalk_tpu.serve.predictor import make_predictor as jax_make_predictor
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    *_, ckpt = setup
    sd = load_pth(ckpt)
    cfg = _cfg(fast)
    one = make_predictor(sd, cfg, [4, 8], image_size=PX, fast=fast, device="cpu")
    two = make_predictor(sd, cfg, [4, 8], image_size=PX, fast=fast, devices=["cpu", "cpu"])
    x = _tiles(8, seed=1)
    got = two(x)
    assert got.shape == (8,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.concatenate([one(x[:4]), one(x[4:])]))
    np.testing.assert_allclose(got, one(x), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="serving batch size 3 must divide across the 2"):
        make_predictor(sd, cfg, [3, 8], image_size=PX, fast=fast, devices=["cpu", "cpu"])

    from crosstalk_tpu.config import ModelConfig as JaxModelConfig

    jcfg = JaxModelConfig(initial_filters=8, num_conv_blocks=3, compute_dtype=cfg.compute_dtype)
    jax_predict = jax_make_predictor(jax_load_pth(ckpt, "single"), jcfg, 8, image_size=PX,
                                     fast=fast, mesh=jax_data_mesh(2))
    np.testing.assert_allclose(got, jax_predict(x), rtol=0, atol=FAST_TOL if fast else F32_TOL)


def test_eval_engine_over_a_replica_set_equals_one_device(setup):
    """10 rows at batch 8, so the padded tail is split between replicas."""
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import TileStore
    from crosstalk_tpu_torch.eval.engine import evaluate
    from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward

    _, mixed, source, ckpt = setup
    sd = load_pth(ckpt)
    store = TileStore(PairIndex(mixed, source).samples)

    def replica(d):
        return make_fast_forward(_cfg(True), {k: v.to(d) for k, v in sd.items()})

    one_rows, one_loss = evaluate(replica(CPU), store, CPU, batch_size=8)
    two_rows, two_loss = evaluate(mesh.replicated_forward(replica, [CPU, CPU]), store, CPU,
                                  batch_size=8, replicas=2)
    assert len(two_rows) == len(one_rows) == 10
    assert [r["Image_ID"] for r in two_rows] == [r["Image_ID"] for r in one_rows]
    for a, b in zip(two_rows, one_rows):
        for k in a:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(two_loss, one_loss, rtol=1e-6)


# --- the CLIs' --num_devices ------------------------------------------------

def _csv(pattern):
    (path,) = glob.glob(pattern)
    with open(path) as f:
        return list(csv.DictReader(f))


def test_eval_and_predict_clis_over_two_cpu_replicas_equal_one(setup, tmp_path):
    from crosstalk_tpu_torch.cli.evaluate import main as eval_main
    from crosstalk_tpu_torch.cli.predict import main as predict_main

    _, mixed, source, ckpt = setup
    common = ["-m", mixed, "-s", source, "-p", ckpt, "--device", "cpu", "-j", "2"]
    for n in ("1", "2"):
        assert eval_main([*common, "--fast", "--batch_size", "3", "--num_devices", n,
                          "--output_base", str(tmp_path / f"eval{n}")]) == 0
        # 10 tiles at -b 3: batches of 3 padded to 4 over two replicas
        assert predict_main([*common, "--fast", "-b", "3", "--num_devices", n,
                             "--output_base", str(tmp_path / f"pred{n}")]) == 0
    for pattern, key in (("eval{}/eval_run_*/test_predictions_*.csv", "Predicted_Label"),
                         ("pred{}/predict_run_*/predictions_*.csv", "Predicted_Alpha")):
        one, two = (_csv(str(tmp_path / pattern.format(n))) for n in (1, 2))
        assert len(one) == len(two) == 10
        np.testing.assert_allclose([float(r[key]) for r in two], [float(r[key]) for r in one],
                                   rtol=0, atol=1e-6)


def test_serve_over_two_cpu_replicas(setup, capsys):
    from crosstalk_tpu_torch.cli.serve import build_parser, build_server, main
    from crosstalk_tpu_torch.serve.client import CrosstalkClient

    *_, ckpt = setup
    flags = ["-p", ckpt, "--device", "cpu", "--port", "0", "--batch_size", "4"]
    server, info = build_server(build_parser().parse_args([*flags, "--num_devices", "2"]))
    try:
        server.start_background()
        got = CrosstalkClient("http://%s:%d" % server.address, timeout=60).predict(
            _tiles(6, seed=2), dtype="float32")
    finally:
        server.shutdown()
    assert info["devices"] == 2
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    one = make_predictor(load_pth(ckpt), _cfg(True), 2, image_size=PX, device="cpu")
    x = _tiles(6, seed=2)
    np.testing.assert_allclose(got, np.concatenate([one(x[i:i + 2]) for i in (0, 2, 4)]),
                               rtol=0, atol=1e-6)
    assert main([*flags, "--num_devices", "2", "--batch_buckets", "3"]) == 1
    assert "serving batch size 3 must divide across the 2 replicas" in capsys.readouterr().out
    assert main(["--artifact", "m.ctkt", "--device", "cpu", "--num_devices", "2"]) == 1
    assert "--num_devices > 1 requires a checkpoint" in capsys.readouterr().out


@pytest.mark.parametrize("cli", ["evaluate", "predict", "serve", "train"])
def test_clis_refuse_more_devices_than_a_one_card_host_has(setup, cli, monkeypatch, tmp_path,
                                                           capsys):
    """On a host with one card (faked here), ``--num_devices 2`` fails with
    the JAX CLIs' message before anything touches the card or the disk."""
    import importlib

    _, mixed, source, ckpt = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = {"evaluate": ["-m", mixed, "-s", source, "-p", ckpt],
            "predict": ["-m", mixed, "-s", source, "-p", ckpt],
            "serve": ["-p", ckpt, "--port", "0"],
            "train": ["-m", mixed, "-s", source]}[cli]
    main = importlib.import_module(f"crosstalk_tpu_torch.cli.{cli}").main
    assert main([*argv, "--num_devices", "2", "--output_base", str(tmp_path)]
                if cli != "serve" else [*argv, "--num_devices", "2"]) == 1
    assert "Error: --num_devices 2 requested but only 1 device(s) are visible." in \
        capsys.readouterr().out
    assert list(tmp_path.iterdir()) == []


# --- --profile and --debug_nans ---------------------------------------------

def _cli(args, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _cli_argv(cli, mixed, source, ckpt, out):
    if cli == "evaluate":
        return ["crosstalk_tpu_torch.cli.evaluate", "-m", mixed, "-s", source, "-p", ckpt,
                "--device", "cpu", "-j", "2", "--batch_size", "4", "--output_base", out]
    return ["crosstalk_tpu_torch.cli.train", "-m", mixed, "-s", source, "-b", "4", "-n", "1",
            "--initial_filters", "8", "--num_conv_blocks", "3", "--device", "cpu", "-j", "2",
            "--output_base", out]


@pytest.mark.parametrize("cli", ["evaluate", "train"])
def test_profile_writes_a_trace_and_a_clean_run_passes_debug_nans(setup, cli, tmp_path):
    _, mixed, source, ckpt = setup
    trace = tmp_path / "trace"
    proc = _cli([*_cli_argv(cli, mixed, source, ckpt, str(tmp_path / "out")),
                 "--profile", str(trace), "--debug_nans"])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert f"Profiler trace written to {trace}" in proc.stdout
    traces = list(trace.glob("trace_*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


@pytest.mark.parametrize("cli", ["evaluate", "train"])
def test_debug_nans_fails_on_a_nan_tile(setup, cli, tmp_path):
    from crosstalk_tpu_torch.data.tiff import read_tile, write_tile

    *_, ckpt = setup
    nan_root = tmp_path / "nan"
    nan_mixed, nan_source = make_synthetic_dataset(str(nan_root), n=10, size=PX, seed=3)
    first = sorted(os.listdir(nan_mixed))[0]
    tile = read_tile(os.path.join(nan_mixed, first))
    tile[3, 5] = np.nan
    write_tile(os.path.join(nan_mixed, first), tile)
    argv = _cli_argv(cli, nan_mixed, nan_source, ckpt, str(tmp_path / "out"))
    proc = _cli([*argv, "--debug_nans"])
    assert proc.returncode != 0
    assert "FloatingPointError: non-finite value" in proc.stderr, proc.stderr[-3000:]
