"""The port's AOT serving artifact and its entry points, on the CPU.

An exported program is held to 1e-6 against the live ``make_forward`` of the
same tier with ``use_kernel=False`` (the route exported programs take: block
0 on the bf16 conv path), for both models and the three tiers, with a
symbolic and a pinned batch. Measured: 0 in every case. The export CLI, the
artifact-backed server (in process and as a subprocess) and ``predict
--artifact`` are driven end to end; the JAX export tool rejects the same
flag combinations.
"""

import glob
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from crosstalk_tpu_torch.config import ModelConfig
from crosstalk_tpu_torch.eval.int8_forward import calibrate_int8
from crosstalk_tpu_torch.io.export import (
    export_serving_model,
    load_exported,
    make_forward,
    read_exported,
    save_exported,
)
from crosstalk_tpu_torch.tools.export_model import main as export_main
from tests.conftest import make_synthetic_dataset
from tests.torch_ref import TorchDouble, TorchSingle, burn_in_batch_stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PX = 32
KW = {"single": dict(initial_filters=8, num_conv_blocks=3),
      "double": dict(initial_filters_per_branch=4)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny checkpoint of each variant, a second single-branch one, and a
    labeled 32 px dataset for calibration."""
    root = tmp_path_factory.mktemp("port_export")
    ckpts = {}
    for name, model, seed in (
        ("single", TorchSingle(initial_filters=8, num_blocks=3, image_size=PX), 4),
        ("single_b", TorchSingle(initial_filters=8, num_blocks=3, image_size=PX), 9),
        ("double", TorchDouble(filters_per_branch=4, image_size=PX), 4),
    ):
        torch.manual_seed(seed)
        burn_in_batch_stats(model, PX, steps=2, seed=seed)
        ckpts[name] = str(root / f"{name}.pth")
        torch.save(model.state_dict(), ckpts[name])
    mixed, source = make_synthetic_dataset(str(root / "data"), n=6, size=PX)
    return root, ckpts, mixed, source


def _cfg(variant, tier):
    return ModelConfig(variant=variant, compute_dtype="f32" if tier == "parity" else "bf16",
                       **KW[variant])


def _raw(n, seed=0):
    return (np.random.default_rng(seed).random((n, PX, PX, 2)) * 1800 + 100).astype(np.float32)


@pytest.mark.parametrize("variant,tier,batch", [
    ("single", "fast", None), ("single", "parity", 4), ("single", "int8", None),
    ("double", "fast", 4), ("double", "parity", None), ("double", "int8", 4),
])
def test_export_roundtrip_matches_live_model(setup, tmp_path, variant, tier, batch):
    _, ckpts, _, _ = setup
    sd = torch.load(ckpts[variant], weights_only=True)
    cfg = _cfg(variant, tier)
    scales = (calibrate_int8(cfg, sd, _raw(4, 1) / 2000, use_kernel=False)
              if tier == "int8" else None)
    program, weights = export_serving_model(sd, cfg, batch, image_size=PX,
                                            fast=tier != "parity", device="cpu",
                                            int8_scales=scales)
    path = str(tmp_path / "m.ctkt")
    save_exported(path, program, weights, {"device": "cpu", "batch_size": batch or "dynamic"})
    fn, meta = load_exported(path)
    assert meta["batch_size"] == (batch or "dynamic") and set(meta["sha256"]) == {
        "program", "weights"}
    live = make_forward(cfg, sd, fast=tier != "parity", image_size=PX, device="cpu",
                        use_kernel=False, int8_scales=scales)
    for n in ((4,) if batch else (1, 3, 4)):
        raw = _raw(n, n)
        with torch.no_grad():
            want = live(torch.from_numpy(raw)).numpy()
        got = fn(raw)
        assert got.dtype == np.float32 and got.shape == (n,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if batch:  # a pinned artifact takes its own batch only
        with pytest.raises(Exception):
            fn(_raw(3))


@pytest.fixture(scope="module")
def artifact(setup):
    """A dynamic-batch bf16 artifact of the single-branch checkpoint."""
    root, ckpts, _, _ = setup
    path = str(root / "single.ctkt")
    assert export_main(["-p", ckpts["single"], "--device", "cpu", "--out", path]) == 0
    return path


def test_export_bad_files_rejected(artifact, tmp_path):
    blob = open(artifact, "rb").read()
    program, weights, meta = read_exported(artifact)
    head = 8 + 4 + len(json.dumps(meta).encode())
    corrupt_w = bytearray(blob)
    corrupt_w[head + 8 + len(weights) // 2] ^= 0xFF
    corrupt_p = bytearray(blob)
    corrupt_p[-100] ^= 0xFF
    cases = {
        "magic": b"NOTCTKT!" + blob[8:],
        "header": blob[:10],
        "metadata": blob[:head - 5],
        "metadata_json": blob[:12] + b"{" * (head - 12) + blob[head:],
        "weights_header": blob[:head + 3],
        "weights": blob[:head + 8 + len(weights) // 2],
        "no_program": blob[:head + 8 + len(weights)],
        "corrupt_weights": bytes(corrupt_w),
        "corrupt_program": bytes(corrupt_p),
    }
    for name, data in cases.items():
        p = tmp_path / f"{name}.ctkt"
        p.write_bytes(data)
        with pytest.raises(ValueError):
            load_exported(str(p))
    with pytest.raises(FileNotFoundError):
        load_exported(str(tmp_path / "missing.ctkt"))


def test_export_runs_on_the_device_type_it_was_traced_for(artifact, tmp_path):
    with pytest.raises(ValueError, match="exported for device type 'cpu'"):
        load_exported(artifact, device="cuda")
    program, weights, meta = read_exported(artifact)
    meta = {k: v for k, v in meta.items() if k != "sha256"}
    cuda = str(tmp_path / "cuda.ctkt")
    save_exported(cuda, program, weights, {**meta, "device": "cuda"})
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no usable CUDA card"):
            load_exported(cuda)


def test_artifact_loads_with_torch_alone(artifact):
    """A fresh process in which ``import crosstalk_tpu_torch`` fails loads
    the loader by file path and runs the artifact."""
    code = (
        "import sys, importlib.util\n"
        "sys.modules['crosstalk_tpu_torch'] = None\n"
        "try:\n"
        "    import crosstalk_tpu_torch\n"
        "    sys.exit('the package imported')\n"
        "except ImportError:\n"
        "    pass\n"
        f"spec = importlib.util.spec_from_file_location('x', {os.path.join(ROOT, 'crosstalk_tpu_torch', 'io', 'export.py')!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "import numpy as np\n"
        f"fn, meta = mod.load_exported({artifact!r})\n"
        "raw = np.random.default_rng(0).random((3, 32, 32, 2)).astype(np.float32)\n"
        "print(list(map(float, fn(raw))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(artifact),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = np.array(json.loads(proc.stdout.strip().splitlines()[-1]))
    fn, _ = load_exported(artifact)
    raw = np.random.default_rng(0).random((3, 32, 32, 2)).astype(np.float32)
    np.testing.assert_allclose(got, fn(raw), rtol=0, atol=1e-6)


def test_export_cli_int8_and_meta(setup, tmp_path, capsys):
    """``--quantize int8``: the scales in the metadata are a calibration on
    the exported program's route, and the program serves them."""
    from crosstalk_tpu_torch.eval.int8_forward import load_calibration_tiles

    _, ckpts, mixed, source = setup
    out = str(tmp_path / "m8.ctkt")
    assert export_main(["-p", ckpts["single"], "--device", "cpu", "--out", out,
                        "--quantize", "int8", "--calibration_mixed_dir", mixed,
                        "--calibration_source_dir", source, "--calibration_tiles", "4",
                        "--batch_size", "2"]) == 0
    assert "Calibrating int8 activation ranges on 4 tile pairs" in capsys.readouterr().out
    fn, meta = load_exported(out)
    sd = torch.load(ckpts["single"], weights_only=True)
    cfg = _cfg("single", "int8")
    scales = calibrate_int8(cfg, sd, load_calibration_tiles(mixed, source, PX, 4),
                            use_kernel=False)
    assert meta["int8_scales"] == scales
    assert {k: meta[k] for k in ("model_options", "batch_size", "image_size", "device",
                                 "path", "calibration_tiles")} == {
        "model_options": "single", "batch_size": 2, "image_size": PX, "device": "cpu",
        "path": "int8", "calibration_tiles": 4}
    assert "kernel is left out" in meta["block0"]
    raw = _raw(2)
    with torch.no_grad():
        want = make_forward(cfg, sd, device="cpu", use_kernel=False,
                            int8_scales=scales)(torch.from_numpy(raw)).numpy()
    np.testing.assert_allclose(fn(raw), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("flags,message", [
    (["--batch_size", "0"], "--batch_size must be positive"),
    (["--quantize", "int8", "--parity", "--calibration_mixed_dir", "m",
      "--calibration_source_dir", "s"], "mutually exclusive"),
    (["--quantize", "int8", "-o", "double", "--calibration_mixed_dir", "m",
      "--calibration_source_dir", "s"], "gated to the single-branch family"),
    (["--quantize", "int8"], "requires --calibration_mixed_dir"),
    (["--quantize", "int8", "--calibration_mixed_dir", "m", "--calibration_source_dir", "s",
      "--calibration_tiles", "0"], "--calibration_tiles must be positive"),
    (["--calibration_mixed_dir", "m"], "only apply with --quantize int8"),
    (["-o", "double", "--num_conv_blocks", "3"], "single-branch model only"),
])
def test_export_cli_rejects_flags_as_the_jax_tool_does(tmp_path, flags, message, capsys):
    from tools.export_model import main as jax_export

    argv = ["-p", str(tmp_path / "m.pth"), "--out", str(tmp_path / "m.out"), *flags]
    assert export_main(argv + ["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert out.startswith("Error") and message in out
    assert jax_export(argv) == 1
    assert not list(tmp_path.iterdir())


def test_export_cli_errors_and_default_device(setup, tmp_path, capsys, monkeypatch):
    _, ckpts, mixed, source = setup
    assert export_main(["-p", str(tmp_path / "no.pth"), "--device", "cpu"]) == 1
    assert "Error loading model" in capsys.readouterr().out
    assert export_main(["-p", ckpts["single"], "--device", "cpu", "--image_size", "64"]) == 1
    assert "compatible tile sizes" in capsys.readouterr().out
    assert export_main(["-p", ckpts["single"], "--device", "cpu", "--quantize", "int8",
                        "--calibration_mixed_dir", str(tmp_path),
                        "--calibration_source_dir", str(tmp_path)]) == 1
    assert "Error loading calibration tiles" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_main(["-p", ckpts["single"], "--out", str(tmp_path / "x.ctkt")])


def test_predict_cli_artifact_matches_checkpoint(setup, artifact, tmp_path, monkeypatch):
    """``predict --artifact`` against ``predict -p --fast`` on the same
    checkpoint: the same CSV keys, alphas within the bf16 tier's 5e-4 (the
    artifact's block 0 is the bf16 conv, the checkpoint's the fused input
    block's CPU path)."""
    from crosstalk_tpu_torch.cli.predict import main as predict

    _, ckpts, mixed, source = setup
    rows = {}
    for tag, flags in (("artifact", ["--artifact", artifact]),
                       ("ckpt", ["-p", ckpts["single"], "--fast"])):
        out = str(tmp_path / tag)
        assert predict(["-m", mixed, "-s", source, "--device", "cpu", "-b", "4",
                        "--output_base", out, *flags]) == 0
        (csv_path,) = glob.glob(os.path.join(out, "predict_run_*", "predictions_*.csv"))
        with open(csv_path) as f:
            rows[tag] = [line.split(",") for line in f.read().splitlines()[1:]]
    assert [r[0] for r in rows["artifact"]] == [r[0] for r in rows["ckpt"]]
    got = np.array([float(r[3]) for r in rows["artifact"]])
    want = np.array([float(r[3]) for r in rows["ckpt"]])
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict(["-m", mixed, "-s", source, "--artifact", artifact,
                 "--output_base", str(tmp_path / "cuda")])


def test_artifact_backed_http_server(setup, artifact):
    from crosstalk_tpu_torch.cli.serve import build_parser, build_server
    from crosstalk_tpu_torch.serve.client import CrosstalkClient

    server, info = build_server(build_parser().parse_args(
        ["--artifact", artifact, "--device", "cpu", "--port", "0", "--batch_size", "4",
         "--max_delay_ms", "2"]))
    assert info["path"] == "fast" and info["batch_size"] == 4 and info["artifact"] == artifact
    try:
        server.start_background()
        client = CrosstalkClient("http://%s:%d" % server.address)
        raw = _raw(6, 3)
        got = client.predict(raw)
        health = client.health()
    finally:
        server.shutdown()
    fn, _ = load_exported(artifact)
    np.testing.assert_allclose(got, fn(raw), rtol=0, atol=1e-6)
    assert health["path"] == "fast" and health["image_size"] == PX


@pytest.mark.parametrize("flags,message", [
    (["--quantize", "int8"], "requires a checkpoint (-p)"),
    (["--batch_buckets", "2"], "--batch_buckets requires a checkpoint"),
    (["--transport_dtype", "float16"], "--transport_dtype float16 requires"),
    (["--allow_reload"], "--allow_reload requires a checkpoint"),
    (["--image_size", "64"], "does not match the artifact"),
])
def test_serve_cli_rejects_artifact_flags(artifact, flags, message, capsys):
    from crosstalk_tpu_torch.cli.serve import main

    assert main(["--artifact", artifact, "--device", "cpu", "--port", "0", *flags]) == 1
    out = capsys.readouterr().out
    assert "Error" in out and message in out


def test_serve_cli_artifact_subprocess(artifact):
    """``python -m crosstalk_tpu_torch.cli.serve --artifact``: /healthz, one
    request, SIGTERM and exit 0."""
    from crosstalk_tpu_torch.serve.client import CrosstalkClient

    proc = subprocess.Popen(
        [sys.executable, "-m", "crosstalk_tpu_torch.cli.serve", "--artifact", artifact,
         "--device", "cpu", "--port", "0", "--batch_size", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    try:
        url = None
        while url is None:
            line = lines.get(timeout=120)
            if line.startswith("Serving on "):
                url = line.split()[2]
        client = CrosstalkClient(url)
        assert client.health()["path"] == "fast"
        raw = _raw(3, 5)
        fn, _ = load_exported(artifact)
        np.testing.assert_allclose(client.predict(raw), fn(raw), rtol=0, atol=1e-6)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# --- the int8 tier through the entry points ---------------------------------

def test_predict_cli_int8_self_calibrates(setup, tmp_path, capsys):
    """``predict --int8`` equals the int8 predictor built from a calibration
    on the first tiles, within 1e-6."""
    from crosstalk_tpu_torch.cli.predict import main as predict
    from crosstalk_tpu_torch.data.index import pair_unlabeled
    from crosstalk_tpu_torch.data.pipeline import load_tiles
    from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    _, ckpts, mixed, source = setup
    out = str(tmp_path / "p8")
    assert predict(["-m", mixed, "-s", source, "-p", ckpts["single"], "--int8",
                    "--device", "cpu", "-b", "4", "--output_base", out]) == 0
    assert "Calibrating int8 activation ranges on 6 tiles" in capsys.readouterr().out
    (csv_path,) = glob.glob(os.path.join(out, "predict_run_*", "predictions_*.csv"))
    with open(csv_path) as f:
        got = np.array([float(line.split(",")[3]) for line in f.read().splitlines()[1:]])
    tiles = load_tiles(pair_unlabeled(mixed, source).samples)
    sd = torch.load(ckpts["single"], weights_only=True)
    cfg = _cfg("single", "int8")
    scales = calibrate_int8(cfg, sd, normalize_batch_nhwc(torch.from_numpy(tiles)))
    predict_fn = make_predictor(sd, cfg, 6, image_size=PX, device="cpu", int8_scales=scales)
    np.testing.assert_allclose(got, predict_fn(tiles), rtol=0, atol=1e-6)


def test_serve_cli_int8_serves_and_recalibrates_on_reload(setup):
    """``serve --quantize int8``: served alphas equal the in-process int8
    predictor's on the f32 wire; ``/reload`` recalibrates for the new
    checkpoint (its clips change) and serves it."""
    from crosstalk_tpu_torch.cli.serve import build_parser, build_server
    from crosstalk_tpu_torch.eval.int8_forward import load_calibration_tiles
    from crosstalk_tpu_torch.serve.client import CrosstalkClient
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    _, ckpts, mixed, source = setup
    server, info = build_server(build_parser().parse_args(
        ["-p", ckpts["single"], "--device", "cpu", "--port", "0", "--batch_size", "4",
         "--quantize", "int8", "--calibration_mixed_dir", mixed,
         "--calibration_source_dir", source, "--allow_reload", "--max_delay_ms", "2"]))
    calib = load_calibration_tiles(mixed, source, PX)
    cfg = _cfg("single", "int8")
    raw = _raw(4, 7)
    try:
        server.start_background()
        url = "http://%s:%d" % server.address
        client = CrosstalkClient(url)
        before = client.health()
        served = client.predict(raw)
        req = urllib.request.Request(url + "/reload", method="POST",
                                     data=json.dumps({"model_path": ckpts["single_b"]}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.load(r)["status"] == "reloaded"
        after = client.health()
        served_b = client.predict(raw)
    finally:
        server.shutdown()
    assert before["path"] == "int8-serving" and before["int8_scales"] == info["int8_scales"]
    for name, got, scales in (("single", served, before["int8_scales"]),
                              ("single_b", served_b, after["int8_scales"])):
        sd = torch.load(ckpts[name], weights_only=True)
        assert scales == calibrate_int8(cfg, sd, calib)
        direct = make_predictor(sd, cfg, 4, image_size=PX, device="cpu", int8_scales=scales)
        np.testing.assert_allclose(got, direct(raw), rtol=0, atol=1e-6)
    assert after["int8_scales"] != before["int8_scales"]
    assert after["checkpoint"] == ckpts["single_b"]


@pytest.mark.parametrize("entry", ["predict_int8", "serve_int8", "serve_artifact"])
def test_int8_and_artifact_entry_points_raise_without_a_card(setup, artifact, tmp_path,
                                                             monkeypatch, entry):
    """Without ``--device cpu`` on a host with no card each entry point
    raises rather than running on the CPU."""
    from crosstalk_tpu_torch.cli.predict import main as predict
    from crosstalk_tpu_torch.cli.serve import main as serve

    _, ckpts, mixed, source = setup
    calib = ["--calibration_mixed_dir", mixed, "--calibration_source_dir", source]
    call = {
        "predict_int8": lambda: predict(["-m", mixed, "-s", source, "-p", ckpts["single"],
                                         "--int8", "--output_base", str(tmp_path)]),
        "serve_int8": lambda: serve(["-p", ckpts["single"], "--quantize", "int8", *calib,
                                     "--port", "0"]),
        "serve_artifact": lambda: serve(["--artifact", artifact, "--port", "0"]),
    }[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert not list(tmp_path.glob("predict_run_*"))
