"""Card-only tests of the port's CLIs, server, tools and run dirs end to end:
what runs differently on an NVIDIA card (K1, cuDNN, cuBLASLt's int8
products, NCCL, pinned memory, ``cuda`` export programs, the batcher's
dispatcher thread, the native decoder built on the card's host, a CLI
subprocess holding the card) and nothing else holds. They skip on a host
without a card. This file imports neither JAX nor ``tests/conftest.py``,
so where JAX is not installed the whole card suite runs as

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_port_cuda*.py

Sizes: the eval CLI runs both models at their published widths on 256 px
tiles (K1's main-path shapes); everything else runs small models (8
filters and 3 blocks, 4 per branch) on 32 px tiles, K1 included, with
pair counts, epochs and clients cut to what each check needs. No test
here asserts a time or a rate beyond its being finite and positive:
``benchmark/run.py`` measures speed.
"""

import contextlib
import csv
import functools
import glob
import io
import json
import math
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from crosstalk_tpu_torch.ops.input_block import fused_input_block
from tests import jax_format

ROOT = Path(__file__).resolve().parents[1]
DEVICE = "cuda"
SIZE = 32              # the small models' tiles
FULL = 256             # the published tile size, for the full-width eval CLI
N_PAIRS = 40           # labeled 32 px pairs: 28 train / 6 val / 6 test
FULL_PAIRS = 24
BATCH = 8
SMALL = {"single": dict(initial_filters=8, num_conv_blocks=3),
         "double": dict(initial_filters_per_branch=4)}
SMALL_FLAGS = {"single": ["--initial_filters", "8", "--num_conv_blocks", "3"],
               "double": ["--initial_filters", "4"]}
SERVE_TOL = 2e-3       # served alphas against the same tier called directly
ARTIFACT_TOL = 1e-6    # an artifact against the live forward of its tier
SPREAD_MIN = 1e-2      # the trained weights' f32 predictions spread wider
WHOLE_PAIRS, WHOLE_SIZE = 4, 96   # whole images of 3 x 3 tiles
ULP_BF16 = 2.0 ** -7


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    from crosstalk_tpu_torch.device import set_parity_numerics

    set_parity_numerics()  # the f32 references must not run in TF32
    return torch.device(DEVICE)


def _launches(fn):
    """-> (what ``fn()`` returns, K1's launches while it ran)."""
    before = fused_input_block.launches
    out = fn()
    torch.cuda.synchronize()
    return out, fused_input_block.launches - before


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return env


def _read_csv(pattern):
    (path,) = glob.glob(pattern)
    with open(path) as f:
        return list(csv.DictReader(f))


def _read_log(run_dir):
    (path,) = glob.glob(os.path.join(run_dir, "training_log_*.csv"))
    with open(path) as f:
        return list(csv.reader(f))[5:]


def _column(rows, key):
    return np.array([float(r[key]) for r in rows])


def _in_batches(predict, arrays, batch):
    """``predict`` over the concatenated ``arrays`` in zero-padded batches."""
    rows = np.concatenate(arrays)
    out = np.empty(len(rows), np.float32)
    for start in range(0, len(rows), batch):
        chunk = rows[start:start + batch]
        real = len(chunk)
        if real < batch:
            chunk = np.concatenate([chunk, np.zeros((batch - real,) + chunk.shape[1:],
                                                    chunk.dtype)])
        out[start:start + real] = predict(chunk)[:real]
    return out


def _config(variant, **kw):
    from crosstalk_tpu_torch.config import ModelConfig

    return ModelConfig(variant=variant, **SMALL[variant], **kw)


def _random_checkpoint(path, variant, size, widths, spread=False):
    """A model from a seeded generator, its BN statistics moved off their
    init by three train-mode forwards on the card, saved as ``path``. With
    ``spread`` the running statistics are those forwards' mean batch
    statistics, so that every layer sees unit-scale activations in eval
    mode and the predictions spread over the tiles as a trained model's do
    (otherwise a full-width model's sit within ~5e-4 of one value, where
    even TF32 convolutions stay within 1e-4 of float64)."""
    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.io.torch_convert import save_pth
    from crosstalk_tpu_torch.models.registry import build_model, init_model

    model = build_model(ModelConfig(variant=variant, **widths), image_size=size)
    init_model(model, torch.Generator().manual_seed(0))
    if spread:
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.reset_running_stats()
                m.momentum = None  # a cumulative mean
    model = model.to(DEVICE).train()
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    with torch.no_grad():
        for _ in range(3):
            model(torch.rand(4, 2, size, size, device=DEVICE, generator=gen))
    save_pth(path, model.eval().state_dict())
    return model


@pytest.fixture(scope="module")
def data(card, tmp_path_factory):
    """N_PAIRS labeled 32 px pairs -> (mixed dir, source dir)."""
    from crosstalk_tpu_torch.data.synthetic import generate_dataset

    return generate_dataset(str(tmp_path_factory.mktemp("pairs")), num_pairs=N_PAIRS,
                            size=SIZE, seed=3, progress_every=0, block=4)


@pytest.fixture(scope="module")
def ckpts(card, tmp_path_factory):
    """A small random checkpoint of each model -> {variant: path}."""
    root = tmp_path_factory.mktemp("ckpts")
    out = {}
    for variant in ("single", "double"):
        out[variant] = str(root / f"{variant}.pth")
        _random_checkpoint(out[variant], variant, SIZE, SMALL[variant])
    return out


@pytest.fixture(scope="module")
def raw_tiles(data):
    """The raw f32 tiles of ``data`` in the predict CLI's order."""
    from crosstalk_tpu_torch.data.index import pair_unlabeled
    from crosstalk_tpu_torch.data.pipeline import load_tiles

    return load_tiles(pair_unlabeled(*data).samples, jobs=4)


@pytest.fixture(scope="module")
def whole(card, tmp_path_factory):
    """WHOLE_PAIRS unlabeled 96 px acquisitions -> (mixed dir, source dir,
    their decoded (n, 96, 96, 2) tiles)."""
    from crosstalk_tpu_torch.data.index import pair_unlabeled
    from crosstalk_tpu_torch.data.pipeline import load_tiles
    from crosstalk_tpu_torch.data.tiff import write_tile

    root = tmp_path_factory.mktemp("whole")
    mixed, source = str(root / "Mixed"), str(root / "Source")
    os.makedirs(mixed)
    os.makedirs(source)
    rng = np.random.default_rng(5)
    for i in range(WHOLE_PAIRS):
        src = rng.random((WHOLE_SIZE, WHOLE_SIZE))
        mix = rng.random((WHOLE_SIZE, WHOLE_SIZE)) + rng.uniform(0.01, 0.5) * src
        write_tile(os.path.join(mixed, f"acq{i:02d}_mixed.tif"), mix)
        write_tile(os.path.join(source, f"acq{i:02d}_source.tif"), src)
    return mixed, source, load_tiles(pair_unlabeled(mixed, source).samples, jobs=4)


@pytest.fixture(scope="module")
def trained(card, ckpts, data, tmp_path_factory):
    """The small single-branch checkpoint trained on in bf16 on the card
    until its f32 predictions on ``data`` spread over more than 2 x
    SPREAD_MIN (a trunk that tells no tile apart fails the int8 bounds on
    such weights) -> its path."""
    from crosstalk_tpu_torch.config import OptimConfig
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import DeviceDataset, TileStore
    from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
    from crosstalk_tpu_torch.io.torch_convert import load_pth, save_pth
    from crosstalk_tpu_torch.models.registry import build_model
    from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step

    model = build_model(_config("single"), image_size=SIZE)
    model.load_state_dict(load_pth(ckpts["single"]))
    state = init_train_state(model.to(DEVICE), OptimConfig(learning_rate=1e-3))
    step = make_train_step(state, compute_dtype="bf16", seed=0)
    resident = DeviceDataset(TileStore(PairIndex(*data).samples, jobs=4), torch.device(DEVICE))

    def spread():
        with torch.no_grad():
            preds = model.eval()(normalize_batch_nhwc(resident.tiles).permute(0, 3, 1, 2))
        return float(preds.max() - preds.min())

    epoch = 0
    while spread() <= 2 * SPREAD_MIN and state.step < 2000:
        for b in resident.batches(BATCH, shuffle=True, drop_last=True, seed=7, epoch=epoch):
            step(b.inputs, b.labels, 1e-3)
        epoch += 1
    path = str(tmp_path_factory.mktemp("trained") / "trained_single.pth")
    save_pth(path, model.state_dict())
    return path


@contextlib.contextmanager
def _serve_cli(argv, wait_s=180):
    """``python -m crosstalk_tpu_torch.cli.serve`` as a subprocess -> (its
    URL, stop(): SIGTERM, then its exit code within 60 s or None)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "crosstalk_tpu_torch.cli.serve", *argv, "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=_env())
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    try:
        url, seen, deadline = None, [], time.monotonic() + wait_s
        while url is None and time.monotonic() < deadline:
            try:
                line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                break
            seen.append(line)
            if line.startswith("Serving on "):
                url = line.split()[2]
        assert url is not None, "".join(seen[-20:])

        def stop():
            proc.send_signal(signal.SIGTERM)
            try:
                return proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                return None

        yield url, stop
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# --- the eval CLI at full width ---------------------------------------------

@pytest.fixture(scope="module")
def full_data(card, tmp_path_factory):
    from crosstalk_tpu_torch.data.synthetic import generate_dataset

    return generate_dataset(str(tmp_path_factory.mktemp("full")), num_pairs=FULL_PAIRS,
                            size=FULL, seed=4, progress_every=0)


def _eval_cli(argv, out):
    """The eval CLI in process -> its CSV rows."""
    from crosstalk_tpu_torch.cli.evaluate import main as eval_main

    assert eval_main(argv + ["--output_base", out]) == 0
    return _read_csv(os.path.join(out, "eval_run_*", "test_predictions_*.csv"))


def _float64_predictions(model, mixed, source, n):
    """The same model in float64 on the card over the first ``n`` pairs."""
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import load_tiles

    tiles = load_tiles(PairIndex(mixed, source).samples[:n]).astype(np.float64)
    lo = tiles.min(axis=(1, 2), keepdims=True)
    hi = tiles.max(axis=(1, 2), keepdims=True)
    batch = torch.from_numpy((tiles - lo) / (hi - lo)).permute(0, 3, 1, 2).to(DEVICE)
    with torch.no_grad():
        return model.double()(batch)[:, 0].cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["single", "double"])
def test_cuda_eval_cli_at_full_width_fast_f32_and_float64(card, full_data, tmp_path, variant):
    """The eval CLI on a random full-width model over 256 px pairs: one
    K1 launch per ``--fast`` batch; every row in both modes in one order,
    finite; ``--fast`` within 2e-3 (MAE) of f32. On a model whose
    predictions spread over more than 1e-2, f32 within 1e-4 x min(1,
    spread) of the same model in float64 on the card (measured on an H100:
    8.5e-6 single-branch, 6.8e-7 two-branch; with TF32 convolutions 3.0e-3
    and 2.4e-4)."""
    mixed, source = full_data
    ckpt = str(tmp_path / f"{variant}.pth")
    _random_checkpoint(ckpt, variant, FULL, {})
    common = ["-m", mixed, "-s", source, "-p", ckpt, "-j", "4", "--batch_size", str(BATCH),
              "--device", DEVICE, "-o", variant]
    fast, launches = _launches(lambda: _eval_cli(common + ["--fast"], str(tmp_path / "fast")))
    assert launches == math.ceil(FULL_PAIRS / BATCH)
    f32 = _eval_cli(common, str(tmp_path / "f32"))
    assert len(fast) == len(f32) == FULL_PAIRS
    assert [r["Image_ID"] for r in fast] == [r["Image_ID"] for r in f32]
    fast_p, f32_p = _column(fast, "Predicted_Label"), _column(f32, "Predicted_Label")
    metrics = np.array([[float(r[k]) for k in list(r)[3:]] for r in f32])
    assert np.isfinite(fast_p).all() and np.isfinite(f32_p).all() and np.isfinite(metrics).all()
    assert np.abs(fast_p - f32_p).mean() <= 2e-3

    spread_ckpt = str(tmp_path / f"{variant}_spread.pth")
    model = _random_checkpoint(spread_ckpt, variant, FULL, {}, spread=True)
    f32_p = _column(_eval_cli([spread_ckpt if a == ckpt else a for a in common],
                              str(tmp_path / "spread")), "Predicted_Label")
    want = _float64_predictions(model, mixed, source, FULL_PAIRS)
    spread = float(np.ptp(want))
    assert spread > 1e-2
    assert np.abs(f32_p - want).max() <= 1e-4 * min(1.0, spread)


# --- the server -------------------------------------------------------------

def _wire(tiles, wire, transport):
    """What the server's batcher holds for ``tiles`` sent on ``wire``: the
    client's wire transform, then the server's decode to its transport."""
    from crosstalk_tpu_torch.serve.wire import to_f16_wire

    sent = to_f16_wire(tiles, (1, 2)) if wire == "float16" else tiles.astype(np.float32)
    if sent.dtype == np.dtype(transport):
        return sent
    return to_f16_wire(sent, (1, 2)) if transport == "float16" else sent.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,transport", [("single", "float32"), ("single", "float16"),
                                               ("double", "float32")])
def test_cuda_server_answers_concurrent_clients_as_its_predictor(card, ckpts, variant,
                                                                 transport):
    """``build_server`` as the serve CLI builds it (batch 8, buckets 2 and
    4), 16 seeded requests of 1-9 tiles from 4 client threads, every other
    one on the f16 wire: each answer finite and of its request's size;
    the f32-wire alphas within 2e-3 of the server's own predictor called
    directly at its largest bucket, the f16-wire ones within 2e-3 of the
    same tiles' f32 alphas, all within 2e-3 (MAE) of the f32 parity
    forward; K1 once per bucket at warm-up and once per batch dispatched;
    ``/metrics`` lists every counter and ``/stats`` counts the requests."""
    from crosstalk_tpu_torch.cli.serve import build_parser, build_server
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.serve.client import CrosstalkClient
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    rng = np.random.default_rng(6)
    requests = [(rng.random((int(n), SIZE, SIZE, 2)) * 1800 + 100,
                 "float16" if i % 2 else "float32")
                for i, n in enumerate(rng.choice((1, 3, 5, 9), size=16))]
    n_tiles = sum(len(t) for t, _ in requests)
    argv = ["-p", ckpts[variant], "-o", variant, "--batch_size", str(BATCH), "--batch_buckets",
            "2,4", "--port", "0", "--max_delay_ms", "5", "--transport_dtype", transport,
            "--device", DEVICE]
    (server, _), warmup = _launches(lambda: build_server(build_parser().parse_args(argv)))
    results = [None] * len(requests)

    def client(t):
        c = CrosstalkClient("http://%s:%d" % server.address, timeout=120)
        for i in range(t, len(requests), 4):
            try:
                results[i] = c.predict(requests[i][0], dtype=requests[i][1])
            except Exception as e:  # reported by the assertion below
                results[i] = e

    try:
        server.start_background()
        url = "http://%s:%d" % server.address
        before = fused_input_block.launches
        threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
        stats = CrosstalkClient(url).stats()
        launches = fused_input_block.launches - before
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
    finally:
        server.shutdown()
    assert all(isinstance(r, np.ndarray) and r.shape == (len(t),) and np.isfinite(r).all()
               for r, (t, _) in zip(results, requests)), results
    assert warmup == 3 and launches == stats["batches"]
    names = {ln.split()[0] for ln in metrics.splitlines() if ln and not ln.startswith("#")}
    assert {f"crosstalk_{k}" for k in (
        "requests_total", "tiles_total", "batches_total", "padded_rows_total",
        "batch_capacity_rows_total", "device_seconds_total", "model_reloads_total",
        "batch_occupancy", "batch_size")} <= names
    assert stats["requests"] == len(requests) and stats["tiles"] == n_tiles

    direct = _in_batches(server.batcher._predict,
                         [_wire(t, w, transport) for t, w in requests], BATCH)
    sd = load_pth(ckpts[variant])
    f32_input = [t.astype(np.float32) for t, _ in requests]
    fast = _in_batches(make_predictor(sd, _config(variant), BATCH, image_size=SIZE,
                                      warmup=False, device=DEVICE), f32_input, BATCH)
    parity = _in_batches(make_predictor(sd, _config(variant, compute_dtype="f32"), BATCH,
                                        image_size=SIZE, fast=False, warmup=False,
                                        device=DEVICE), f32_input, BATCH)
    served = np.concatenate(results)
    on_f16 = np.concatenate([np.full(len(t), w == "float16") for t, w in requests])
    assert np.abs(served - direct)[~on_f16].max() <= SERVE_TOL
    assert np.abs(served - fast)[on_f16].max() <= SERVE_TOL
    assert np.abs(served - parity).mean() <= SERVE_TOL


@pytest.mark.cuda
def test_cuda_serve_cli_subprocess_scores_predict_url_and_remote_eval(card, ckpts, data,
                                                                      tmp_path):
    """The serve CLI as a subprocess holding the card: ``/healthz``;
    ``predict --url`` (f16 wire) and ``remote_eval`` over the pairs within
    2e-3 of a local ``predict --fast``; SIGTERM drains it to exit 0."""
    from crosstalk_tpu_torch.cli.predict import main as predict_main
    from crosstalk_tpu_torch.cli.remote_eval import main as remote_eval_main
    from crosstalk_tpu_torch.serve.client import CrosstalkClient

    mixed, source = data
    with _serve_cli(["-p", ckpts["single"], "--device", DEVICE]) as (url, stop):
        health = CrosstalkClient(url).health()
        assert health.get("status") == "ok" and health.get("path") == "bf16-serving", health
        assert predict_main(["-m", mixed, "-s", source, "--url", url,
                             "--output_base", str(tmp_path / "url")]) == 0
        assert remote_eval_main(["-m", mixed, "-s", source, "--url", url,
                                 "-o", str(tmp_path / "remote")]) == 0
        assert stop() == 0
    assert predict_main(["-m", mixed, "-s", source, "-p", ckpts["single"], "--fast", "-b",
                         str(BATCH), "--output_base", str(tmp_path / "local"),
                         "--device", DEVICE]) == 0
    local = {r["Image_Key"]: float(r["Predicted_Alpha"]) for r in _read_csv(
        str(tmp_path / "local" / "predict_run_*" / "predictions_*.csv"))}
    remote = _read_csv(str(tmp_path / "url" / "predict_run_*" / "predictions_*.csv"))
    assert len(remote) == len(local) == N_PAIRS
    assert max(abs(float(r["Predicted_Alpha"]) - local[r["Image_Key"]]) for r in remote) <= SERVE_TOL
    by_id = {int(re.match(r"image_(\d+)_alpha", k).group(1)): v for k, v in local.items()}
    evals = _read_csv(str(tmp_path / "remote" / "eval_run_*" / "test_predictions_*.csv"))
    assert len(evals) == N_PAIRS
    assert max(abs(float(r["Predicted_Label"]) - by_id[int(r["Image_ID"])])
               for r in evals) <= SERVE_TOL


# --- whole images -----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["single", "double"])
def test_cuda_predict_fast_unmix_over_whole_images(card, ckpts, whole, tmp_path, variant):
    """``predict --fast --unmix`` over acquisitions of 3 x 3 tiles: one row
    per image, K1 once per batch of tiles, each Predicted_Alpha the median
    of the predictor's tile alphas, each unmixed TIFF clip(mixed - alpha x
    source, 0)."""
    from crosstalk_tpu_torch.cli.predict import _grid_images
    from crosstalk_tpu_torch.cli.predict import main as predict_main
    from crosstalk_tpu_torch.data.tiff import read_tile
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    mixed, source, images = whole
    per_image = (WHOLE_SIZE // SIZE) ** 2
    out = str(tmp_path / "out")
    rc, launches = _launches(lambda: predict_main([
        "-m", mixed, "-s", source, "-p", ckpts[variant], "-o", variant, "--fast", "-b",
        str(BATCH), "--unmix", "--output_base", out, "--device", DEVICE]))
    assert rc == 0 and launches == math.ceil(WHOLE_PAIRS * per_image / BATCH)
    rows = _read_csv(os.path.join(out, "predict_run_*", "predictions_*.csv"))
    assert len(rows) == WHOLE_PAIRS and all(r["Num_Tiles"] == str(per_image) for r in rows)
    predict = make_predictor(load_pth(ckpts[variant]), _config(variant), BATCH,
                             image_size=SIZE, warmup=False, device=DEVICE)
    crops, _ = _grid_images(images, SIZE)
    medians = np.median(_in_batches(predict, [crops], BATCH).reshape(WHOLE_PAIRS, per_image),
                        axis=1)
    alphas = _column(rows, "Predicted_Alpha")
    np.testing.assert_allclose(alphas, medians, rtol=0, atol=1e-6)
    (run_dir,) = glob.glob(os.path.join(out, "predict_run_*"))
    assert len(os.listdir(os.path.join(run_dir, "unmixed"))) == WHOLE_PAIRS
    for i, r in enumerate(rows):
        got = read_tile(os.path.join(run_dir, "unmixed", f"{r['Image_Key']}_unmixed.tif"))
        want = np.clip(images[i, :, :, 0] - alphas[i] * images[i, :, :, 1], 0.0, None)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --- training ---------------------------------------------------------------

def _train_cli(argv):
    from crosstalk_tpu_torch.cli.train import main as train_main

    assert train_main(argv + ["--device", DEVICE]) == 0


def _check_run_dir(variant, run_dir, epochs):
    """The JAX package's artifact names, one log row per epoch with finite
    losses, the .pth files loading into ``build_model`` -> the newest final
    one."""
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.models.registry import build_model

    ts = re.compile(r"\d{4}-\d{2}-\d{2}_\d{2}-\d{2}-\d{2}")
    names = {ts.sub("TS", os.path.relpath(os.path.join(d, f), run_dir))
             for d, _, files in os.walk(run_dir) for f in files}
    tail = f"TS_{BATCH}_0.0001"
    want = {"params.txt", "model_architecture.txt", f"training_log_{tail}_onecycle.csv",
            "best_model_onecycle.pth", f"crosstalk_regression_model_trained_{tail}.pth",
            "checkpoints/train_ckpt.bin",
            *(f"{s}_predictions_{tail}.csv" for s in ("test", "train", "val"))}
    if epochs > 1:  # the generation a second checkpoint replaced
        want.add("checkpoints/train_ckpt.prev.bin")
    plots = {"lr_schedule_onecycle.png", f"training_validation_loss_{tail}.png",
             *(f"{s}_predictions_plot_{tail}.png" for s in ("test", "train", "val"))}
    extra = names - want - {"params_resume.txt"}
    assert want <= names and extra <= plots, (want - names, extra - plots)
    rows = _read_log(run_dir)
    assert len(rows) == epochs and np.isfinite([[float(v) for v in r[1:3]] for r in rows]).all()
    for pattern in ("best_model_*.pth", "crosstalk_regression_model_trained_*.pth"):
        paths = glob.glob(os.path.join(run_dir, pattern))  # a resume adds a final one
        assert paths
        for path in paths:
            build_model(_config(variant), image_size=SIZE).load_state_dict(load_pth(path))
    return max(paths, key=os.path.getmtime)


def _check_resume(run_dir, mixed, source):
    """--resume of a two-epoch single-branch run to three epochs: the state
    a resume restores on the card equals the saved one; the log's rows,
    the step count, the lr history and the schedule carry on."""
    from crosstalk_tpu_torch.config import OptimConfig
    from crosstalk_tpu_torch.io import checkpoint
    from crosstalk_tpu_torch.models.registry import build_model
    from crosstalk_tpu_torch.train.steps import init_train_state

    payload, meta = checkpoint.load_checkpoint(run_dir)
    rows_before = _read_log(run_dir)
    state = init_train_state(build_model(_config("single"), image_size=SIZE, device=DEVICE),
                             OptimConfig())
    checkpoint.restore_state(state, payload)
    assert all(torch.equal(v.cpu(), payload["model"][k])
               for k, v in state.model.state_dict().items())
    moments = state.optimizer.state_dict()["state"]
    assert all(torch.equal(moments[i][k].cpu(), payload["optimizer"]["state"][i][k])
               for i in moments for k in moments[i])
    assert state.step == payload["step"] == meta["global_step"]
    _train_cli(["-m", mixed, "-s", source, "-n", "3", "-j", "4", "--resume", run_dir])
    _, new_meta = checkpoint.load_checkpoint(run_dir)
    rows = _read_log(run_dir)
    assert rows[:2] == rows_before and len(rows) == 3 and new_meta["epoch"] == 3
    assert new_meta["global_step"] == meta["global_step"] + meta["global_step"] // meta["epoch"]
    assert new_meta["lr_history"][:2] == meta["lr_history"]
    assert new_meta["schedule"]["epoch"] == meta["schedule"]["epoch"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["single", "double"])
def test_cuda_train_cli_resumes_and_its_checkpoints_score_fast_as_f32(card, data, tmp_path,
                                                                      variant):
    """The train CLI (bf16, ``-b 8 -n 2 -r onecycle``): the run dir's
    artifacts; the single-branch run ``--resume``d to a third epoch; the
    trained checkpoint, as it is and with every other block-0 BN scale
    negated (two epochs learn no negative scale; K1 folds the scale into
    its conv and must turn its phase max into a min), through the eval
    CLI: K1 once per ``--fast`` batch, ``--fast`` within 2e-3 (MAE) of f32."""
    from crosstalk_tpu_torch.io.torch_convert import load_pth, save_pth

    mixed, source = data
    out = str(tmp_path / "train")
    _train_cli(["-m", mixed, "-s", source, "-b", str(BATCH), "-n", "2", "-r", "onecycle",
                "-o", variant, "-j", "4", "--output_base", out, *SMALL_FLAGS[variant]])
    (run_dir,) = glob.glob(os.path.join(out, "training_run_*"))
    final = _check_run_dir(variant, run_dir, 2)
    if variant == "single":
        _check_resume(run_dir, mixed, source)
        final = _check_run_dir(variant, run_dir, 3)

    sd = load_pth(final)
    prefixes = (["conv_layers.1."] if variant == "single" else
                ["bleed_branch.conv_blocks.1.", "source_branch.conv_blocks.1."])
    for p in prefixes:
        sd[p + "weight"][::2] *= -1
    negated = str(tmp_path / "negated.pth")
    save_pth(negated, sd)
    for name, ckpt in (("trained", final), ("negated", negated)):
        common = ["-m", mixed, "-s", source, "-p", ckpt, "-j", "4", "--batch_size", str(BATCH),
                  "--device", DEVICE, "-o", variant]
        fast, launches = _launches(lambda: _eval_cli(common + ["--fast"],
                                                     str(tmp_path / f"{name}_fast")))
        assert launches == math.ceil(N_PAIRS / BATCH)
        f32 = _eval_cli(common, str(tmp_path / f"{name}_f32"))
        fast_p, f32_p = _column(fast, "Predicted_Label"), _column(f32, "Predicted_Label")
        assert len(fast) == len(f32) == N_PAIRS and np.isfinite(fast_p).all()
        assert np.abs(fast_p - f32_p).mean() <= 2e-3, name


@pytest.fixture(scope="module")
def swin_data(card, tmp_path_factory):
    """24 labeled 64 px pairs, the smallest tiles SwinV2 takes (a 2 x 2
    last map) -> (mixed dir, source dir)."""
    from crosstalk_tpu_torch.data.synthetic import generate_dataset

    return generate_dataset(str(tmp_path_factory.mktemp("swin")), num_pairs=24, size=64,
                            seed=6, progress_every=0, block=4)


@pytest.mark.cuda
def test_cuda_swinv2_train_cli_resumes_evaluates_predicts_and_refuses_fast(
        card, swin_data, tmp_path, capsys):
    """``train -o swinv2-b`` at its published widths: two epochs, the
    checkpoint's meta naming the variant, a ``--resume`` to a third epoch;
    the trained checkpoint through ``evaluate`` in f32 and bf16 and
    ``predict``; ``--fast`` refused by name."""
    from crosstalk_tpu_torch.cli.evaluate import main as eval_main
    from crosstalk_tpu_torch.cli.predict import main as predict_main
    from crosstalk_tpu_torch.io import checkpoint

    mixed, source = swin_data
    out = str(tmp_path / "train")
    _train_cli(["-m", mixed, "-s", source, "-b", str(BATCH), "-n", "2", "-o", "swinv2-b",
                "-j", "4", "--output_base", out])
    (run_dir,) = glob.glob(os.path.join(out, "training_run_*"))
    _, meta = checkpoint.load_checkpoint(run_dir)
    assert meta["variant"] == "swinv2-b" and meta["epoch"] == 2
    _train_cli(["-m", mixed, "-s", source, "-n", "3", "-j", "4", "--resume", run_dir])
    _, resumed = checkpoint.load_checkpoint(run_dir)
    rows = _read_log(run_dir)
    assert resumed["epoch"] == 3 and len(rows) == 3
    assert resumed["global_step"] == meta["global_step"] * 3 // 2
    assert np.isfinite([[float(v) for v in r[1:3]] for r in rows]).all()
    final = max(glob.glob(os.path.join(run_dir, "crosstalk_regression_model_trained_*.pth")),
                key=os.path.getmtime)
    common = ["-m", mixed, "-s", source, "-p", final, "-j", "4", "--batch_size", str(BATCH),
              "--device", DEVICE, "-o", "swinv2-b"]
    preds = {}
    for dtype in ("f32", "bf16"):
        rows = _eval_cli(common + ["--compute_dtype", dtype], str(tmp_path / f"eval_{dtype}"))
        preds[dtype] = _column(rows, "Predicted_Label")
        assert len(rows) == 24 and np.isfinite(preds[dtype]).all()
    assert np.abs(preds["f32"] - preds["bf16"]).max() > 0  # two computations
    assert predict_main(common + ["--output_base", str(tmp_path / "predict")]) == 0
    capsys.readouterr()
    assert eval_main(common + ["--fast", "--output_base", str(tmp_path / "fast")]) == 1
    assert "swinv2-b" in capsys.readouterr().out


def _f32_state(device, dtype=torch.float32):
    """A single-branch model (16 filters, 4 blocks, 64 px) in f32 mode,
    dropout 0, the same seeded weights on every device -> its TrainState."""
    from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
    from crosstalk_tpu_torch.models.registry import build_model, init_model
    from crosstalk_tpu_torch.train.steps import init_train_state

    model = build_model(ModelConfig(compute_dtype="f32", dropout_single=0.0, initial_filters=16,
                                    num_conv_blocks=4), image_size=64)
    init_model(model, torch.Generator().manual_seed(6))
    return init_train_state(model.to(device, dtype), OptimConfig())


def _first_step_grads(device, dtype):
    """The first f32-mode step's gradient of each parameter (flips off), as
    float64 on the host; the same tiles on every device."""
    from crosstalk_tpu_torch.train.steps import make_train_step

    state = _f32_state(device, dtype)
    step = make_train_step(state, compute_dtype="f32", augment=False)
    rng = np.random.default_rng(6)
    raw = torch.from_numpy((rng.random((4, 64, 64, 2)) * 1800 + 100).astype(np.float32))
    y = torch.from_numpy(rng.uniform(0, 0.5, (4, 1)).astype(np.float32))
    assert math.isfinite(float(step(raw.to(device, dtype), y.to(device, dtype), 1e-5)))
    return {n: p.grad.double().cpu() for n, p in state.model.named_parameters()}


def _shadowed_biases(model):
    """The biases of the layers a BatchNorm directly follows: train-mode BN
    subtracts the batch mean, so their gradient is 0 up to rounding."""
    out = set()
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Sequential):
            for i, (a, b) in enumerate(zip(mod, list(mod)[1:])):
                if (isinstance(b, torch.nn.modules.batchnorm._BatchNorm)
                        and getattr(a, "bias", None) is not None):
                    out.add(f"{name}.{i}.bias")
    return out


def _worst_leaf(a, b, ref, skip=()):
    """max over parameters of |a - b| / |ref| (L2 norms; NaN reads as inf)."""
    return max(float(torch.nan_to_num((a[k] - b[k]).norm() / ref[k].norm(), nan=math.inf))
               for k in ref if k not in skip)


@pytest.mark.cuda
def test_cuda_first_step_gradients_match_cpu(card):
    """The first f32-mode step's gradients per parameter, the biases a
    BatchNorm follows left out: in float64 the card's backward equals the
    CPU's within 1e-9 (relative L2, worst leaf); in f32 the card's sit no
    further from float64 than twice the CPU's do, and within 5e-3 of the
    CPU's."""
    card64, cpu64 = _first_step_grads(DEVICE, torch.float64), _first_step_grads("cpu", torch.float64)
    card32, cpu32 = _first_step_grads(DEVICE, torch.float32), _first_step_grads("cpu", torch.float32)
    skip = _shadowed_biases(_f32_state("cpu").model)
    assert skip
    assert _worst_leaf(card64, cpu64, cpu64, skip) <= 1e-9
    assert _worst_leaf(card32, card64, card64, skip) <= 2 * _worst_leaf(cpu32, card64, card64, skip)
    assert _worst_leaf(card32, cpu32, card64, skip) <= 5e-3


@pytest.mark.cuda
def test_cuda_adam_step_matches_cpu_from_the_same_gradients(card):
    """One step of the train step's optimizer (Adam with coupled L2), lr
    1e-3, on the card and on the CPU from the same weights and gradients:
    the updates within 1e-3 x lr, both moments within 1e-5 (relative L2,
    worst leaf)."""
    grads, lr = _first_step_grads("cpu", torch.float32), 1e-3
    after = {}
    for device in (DEVICE, "cpu"):
        state = _f32_state(device)
        before = {n: p.detach().double().cpu() for n, p in state.model.named_parameters()}
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        for n, p in state.model.named_parameters():
            p.grad = grads[n].float().to(device)
        state.optimizer.step()
        names = [n for n, _ in state.model.named_parameters()]
        moments = state.optimizer.state_dict()["state"]
        after[device] = (
            {n: (p.detach().double().cpu() - before[n]) / lr
             for n, p in state.model.named_parameters()},
            {f"{names[i]}.{k}": moments[i][k].double().cpu()
             for i in moments for k in ("exp_avg", "exp_avg_sq")})
    (upd_card, mom_card), (upd_cpu, mom_cpu) = after[DEVICE], after["cpu"]
    assert max(float((upd_card[k] - upd_cpu[k]).abs().max()) for k in upd_cpu) <= 1e-3
    assert _worst_leaf(mom_card, mom_cpu, mom_cpu) <= 1e-5


# --- the int8 tier on trained weights ---------------------------------------

def _same_scales(a, b):
    return a.keys() == b.keys() and all(math.isclose(a[k], b[k], rel_tol=1e-5) for k in a)


def _calibration(data):
    from crosstalk_tpu_torch.eval.int8_forward import load_calibration_tiles

    return torch.from_numpy(load_calibration_tiles(*data, SIZE, max_tiles=256)).to(DEVICE)


def _int8_scales(ckpt, calib):
    from crosstalk_tpu_torch.eval.int8_forward import calibrate_int8
    from crosstalk_tpu_torch.io.torch_convert import load_pth

    sd = {k: v.to(DEVICE) for k, v in load_pth(ckpt).items()}
    return calibrate_int8(_config("single"), sd, calib)


def _int8_alphas(ckpt, scales, raw):
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    predict = make_predictor(load_pth(ckpt), _config("single"), BATCH, image_size=SIZE,
                             int8_scales=scales, warmup=False, device=DEVICE)
    return _in_batches(predict, [raw], BATCH)


@pytest.mark.cuda
def test_cuda_int8_tier_on_trained_weights(card, trained, data, raw_tiles, whole, tmp_path):
    """The int8 tier on weights trained until their f32 predictions spread
    over more than 1e-2: calibration launches K1 once; card against CPU
    from one set of scales on 16 tiles, the trunk from one block-0 output
    bitwise, the int8 head within 1e-6 and the bf16 head and the whole
    forward within 1% of the spread (a trunk that tells no tile apart
    misses by half of it); the tier within min(2e-2, 0.15 x spread, half
    the best constant's MAE) of f32; ``predict --int8`` over whole images
    (K1: 1 calibration + 1 a batch); ``serve --quantize int8`` in process
    calibrates as the tier does and answers as the tier's predictor."""
    from crosstalk_tpu_torch.cli.predict import main as predict_main
    from crosstalk_tpu_torch.cli.serve import build_parser, build_server
    from crosstalk_tpu_torch.eval.fast_forward import make_first_block
    from crosstalk_tpu_torch.eval.int8_forward import (
        calibrate_int8,
        make_int8_forward,
        make_int8_head,
        make_int8_trunk,
    )
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.serve.client import CrosstalkClient
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    cfg = _config("single")
    sd_cpu = load_pth(trained)
    sd = {k: v.to(DEVICE) for k, v in sd_cpu.items()}
    calib = _calibration(data)
    scales, launches = _launches(lambda: calibrate_int8(cfg, sd, calib))
    assert launches == 1

    x = calib[:16]
    with torch.inference_mode():
        block0 = make_first_block(cfg, sd_cpu)(x.cpu())
        feats = make_int8_trunk(cfg, sd_cpu, scales)(block0)
        card_feats = make_int8_trunk(cfg, sd, scales)([h.to(DEVICE) for h in block0]).cpu()
    assert torch.equal(card_feats.view(torch.int16), feats.view(torch.int16))
    for int8_dense in (False, True):
        sc = calibrate_int8(cfg, sd, calib, int8_dense=True) if int8_dense else scales
        with torch.inference_mode():
            want = make_int8_head(cfg, sd_cpu, sc)(feats)
            head = make_int8_head(cfg, sd, sc)(feats.to(DEVICE)).cpu()
            full = make_int8_forward(cfg, sd, sc)(x).cpu()
        spread = float(want.max() - want.min())
        assert bool(torch.isfinite(full).all())
        assert float((full - want).abs().max()) <= 0.01 * spread
        assert float((head - want).abs().max()) <= (1e-6 if int8_dense else 0.01 * spread)

    p8 = _int8_alphas(trained, scales, raw_tiles)
    p32 = _in_batches(make_predictor(sd_cpu, _config("single", compute_dtype="f32"), BATCH,
                                     image_size=SIZE, fast=False, warmup=False, device=DEVICE),
                      [raw_tiles], BATCH)
    spread = float(np.ptp(p32))
    constant = float(np.abs(p32 - np.median(p32)).mean())
    assert spread > SPREAD_MIN
    assert np.isfinite(p8).all()
    assert np.abs(p8 - p32).mean() <= min(2e-2, 0.15 * spread, 0.5 * constant)

    wmixed, wsource, _ = whole
    out = str(tmp_path / "whole_int8")
    rc, launches = _launches(lambda: predict_main([
        "-m", wmixed, "-s", wsource, "-p", trained, "--int8", "-b", str(BATCH),
        "--output_base", out, "--device", DEVICE]))
    n_tiles = WHOLE_PAIRS * (WHOLE_SIZE // SIZE) ** 2
    assert rc == 0 and launches == 1 + math.ceil(n_tiles / BATCH)
    rows = _read_csv(os.path.join(out, "predict_run_*", "predictions_*.csv"))
    assert len(rows) == WHOLE_PAIRS and np.isfinite(_column(rows, "Predicted_Alpha")).all()

    mixed, source = data
    flags = ["-p", trained, "--quantize", "int8", "--calibration_mixed_dir", mixed,
             "--calibration_source_dir", source, "--batch_size", str(BATCH), "--port", "0",
             "--max_delay_ms", "5", "--device", DEVICE]
    before = fused_input_block.launches
    server, info = build_server(build_parser().parse_args(flags))
    try:
        server.start_background()
        client = CrosstalkClient("http://%s:%d" % server.address, timeout=300)
        served = np.concatenate([client.predict(raw_tiles[i:i + BATCH], dtype="float32")
                                 for i in range(0, N_PAIRS, BATCH)])
        batches = client.stats()["batches"]
        torch.cuda.synchronize()
        launches = fused_input_block.launches - before
    finally:
        server.shutdown()
    assert _same_scales(info["int8_scales"], scales)
    assert launches == 2 + batches  # 1 calibration, 1 warm-up
    np.testing.assert_allclose(served, _int8_alphas(trained, info["int8_scales"], raw_tiles),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_serve_int8_subprocess_answers_and_recalibrates_on_reload(card, ckpts, trained,
                                                                       data, raw_tiles,
                                                                       tmp_path):
    """``serve --quantize int8 --allow_reload`` as a subprocess: its scales
    those of the tier's calibration; served alphas (f32 wire) within 1e-6
    of the tier's predictor with its scales, and ``predict --url``'s CSV
    within 1e-6 and its 6-decimal rounding; ``remote_eval`` writes every
    row; ``/reload`` of the trained checkpoint recalibrates to its scales;
    SIGTERM gives exit 0."""
    from crosstalk_tpu_torch.cli.predict import main as predict_main
    from crosstalk_tpu_torch.cli.remote_eval import main as remote_eval_main
    from crosstalk_tpu_torch.data.index import pair_unlabeled
    from crosstalk_tpu_torch.serve.client import CrosstalkClient

    mixed, source = data
    calib = _calibration(data)
    flags = ["-p", ckpts["single"], "--quantize", "int8", "--calibration_mixed_dir", mixed,
             "--calibration_source_dir", source, "--batch_size", str(BATCH),
             "--max_delay_ms", "5", "--allow_reload", "--device", DEVICE]
    with _serve_cli(flags) as (url, stop):
        client = CrosstalkClient(url, timeout=300)
        before = client.health()
        served = np.concatenate([client.predict(raw_tiles[i:i + BATCH], dtype="float32")
                                 for i in range(0, N_PAIRS, BATCH)])
        assert predict_main(["-m", mixed, "-s", source, "--url", url, "--dtype", "float32",
                             "--output_base", str(tmp_path / "url")]) == 0
        assert remote_eval_main(["-m", mixed, "-s", source, "--url", url, "--dtype", "float32",
                                 "-o", str(tmp_path / "remote")]) == 0
        req = urllib.request.Request(url + "/reload", method="POST",
                                     data=json.dumps({"model_path": trained}).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            reloaded = json.load(r)
        after = client.health()
        assert stop() == 0
    assert before.get("path") == "int8-serving"
    assert _same_scales(before["int8_scales"], _int8_scales(ckpts["single"], calib))
    want = _int8_alphas(ckpts["single"], before["int8_scales"], raw_tiles)
    np.testing.assert_allclose(served, want, rtol=0, atol=1e-6)
    by_key = dict(zip((s.image_id for s in pair_unlabeled(mixed, source).samples), want))
    rows = _read_csv(str(tmp_path / "url" / "predict_run_*" / "predictions_*.csv"))
    assert len(rows) == N_PAIRS
    assert max(abs(float(r["Predicted_Alpha"]) - by_key[r["Image_Key"]]) for r in rows) <= 1.5e-6
    assert len(_read_csv(str(tmp_path / "remote" / "eval_run_*" / "test_predictions_*.csv"))) == N_PAIRS
    assert reloaded.get("status") == "reloaded" and after.get("checkpoint") == trained
    assert _same_scales(after["int8_scales"], _int8_scales(trained, calib))
    assert after["int8_scales"] != before["int8_scales"]


# --- the export tool --------------------------------------------------------

@pytest.mark.cuda
def test_cuda_export_tool_artifacts_run_where_the_package_cannot_be_imported(
        card, ckpts, data, raw_tiles, tmp_path):
    """The export tool on the card: the single-branch bf16 artifact with a
    cuda and a cpu program, the two-branch bf16 and the single-branch int8
    one for the card. Each, loaded in a fresh process where ``import
    crosstalk_tpu_torch`` fails, within 1e-6 of the live forward of its
    tier without K1 and 2e-3 with it; the cpu program within 1e-6 of the
    live CPU forward; ``predict --artifact`` (int8) writes a finite row
    per pair, and ``serve --artifact`` (bf16) answers as the artifact."""
    from crosstalk_tpu_torch.cli.predict import main as predict_main
    from crosstalk_tpu_torch.cli.serve import build_parser, build_server
    from crosstalk_tpu_torch.io.export import load_exported, make_forward, read_exported
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.serve.client import CrosstalkClient
    from crosstalk_tpu_torch.tools.export_model import main as export_main

    mixed, source = data
    arts = {
        "single_fast": (["-p", ckpts["single"], "--platforms", "cuda", "cpu"], "single"),
        "double_fast": (["-p", ckpts["double"], "-o", "double", "--device", DEVICE], "double"),
        "single_int8": (["-p", ckpts["single"], "--device", DEVICE, "--quantize", "int8",
                         "--calibration_mixed_dir", mixed, "--calibration_source_dir",
                         source], "single"),
    }
    metas = {}
    for name, (flags, _) in arts.items():
        assert export_main(flags + ["--out", str(tmp_path / f"{name}.ctkt")]) == 0
        metas[name] = read_exported(str(tmp_path / f"{name}.ctkt"))[2]
    assert metas["single_fast"]["platforms"] == ["cuda", "cpu"]

    raw = raw_tiles[:BATCH]
    np.save(tmp_path / "tiles.npy", raw)
    loader = ROOT / "crosstalk_tpu_torch" / "io" / "export.py"
    code = (
        "import sys, importlib.util\n"
        "import numpy as np\n"
        "sys.modules['crosstalk_tpu_torch'] = None\n"
        "try:\n"
        "    import crosstalk_tpu_torch\n"
        "    sys.exit('crosstalk_tpu_torch imported')\n"
        "except ImportError:\n"
        "    pass\n"
        f"spec = importlib.util.spec_from_file_location('artifact_loader', {str(loader)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "tiles = np.load('tiles.npy')\n"
        f"for name in {list(arts)!r}:\n"
        "    fn, meta = mod.load_exported(name + '.ctkt')\n"
        "    np.save(name + '.out.npy', fn(tiles))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-1000:] + proc.stderr[-3000:]
    x = torch.from_numpy(raw).to(DEVICE)
    for name, (_, variant) in arts.items():
        got = np.load(tmp_path / f"{name}.out.npy")
        scales = metas[name].get("int8_scales")
        sd = load_pth(ckpts[variant])
        with torch.inference_mode():
            live = make_forward(_config(variant), sd, device=DEVICE, use_kernel=False,
                                int8_scales=scales)(x).cpu().numpy()
            with_k1 = make_forward(_config(variant), sd, device=DEVICE,
                                   int8_scales=scales)(x).cpu().numpy()
        assert got.shape == (BATCH,) and np.isfinite(got).all(), name
        np.testing.assert_allclose(got, live, rtol=0, atol=ARTIFACT_TOL, err_msg=name)
        np.testing.assert_allclose(got, with_k1, rtol=0, atol=2e-3, err_msg=name)

    fn, _ = load_exported(str(tmp_path / "single_fast.ctkt"), device="cpu")
    with torch.inference_mode():
        live = make_forward(_config("single"), load_pth(ckpts["single"]), device="cpu",
                            use_kernel=False)(torch.from_numpy(raw[:4])).numpy()
    np.testing.assert_allclose(fn(raw[:4]), live, rtol=0, atol=ARTIFACT_TOL)

    assert predict_main(["-m", mixed, "-s", source, "--artifact",
                         str(tmp_path / "single_int8.ctkt"), "-b", str(BATCH),
                         "--output_base", str(tmp_path / "predict"), "--device", DEVICE]) == 0
    rows = _read_csv(str(tmp_path / "predict" / "predict_run_*" / "predictions_*.csv"))
    assert len(rows) == N_PAIRS and np.isfinite(_column(rows, "Predicted_Alpha")).all()
    server, info = build_server(build_parser().parse_args(
        ["--artifact", str(tmp_path / "single_fast.ctkt"), "--batch_size", str(BATCH),
         "--port", "0", "--device", DEVICE]))
    try:
        server.start_background()
        got = CrosstalkClient("http://%s:%d" % server.address, timeout=300).predict(
            raw, dtype="float32")
    finally:
        server.shutdown()
    assert info["path"] == "fast"
    np.testing.assert_allclose(got, np.load(tmp_path / "single_fast.out.npy"), rtol=0,
                               atol=ARTIFACT_TOL)


# --- data parallel on the one card ------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["single", "double"])
def test_cuda_train_cli_as_a_one_rank_nccl_cluster(card, data, tmp_path, variant):
    """``train --multihost --num_processes 1``: one NCCL rank trains an
    epoch and writes the run dir's artifacts."""
    from crosstalk_tpu_torch.parallel.distributed import free_port

    mixed, source = data
    out = str(tmp_path / "nccl")
    _train_cli(["-m", mixed, "-s", source, "-b", str(BATCH), "-n", "1", "-r", "onecycle",
                "-o", variant, "-j", "4", "--output_base", out, *SMALL_FLAGS[variant],
                "--multihost", "--coordinator_address", f"localhost:{free_port()}",
                "--num_processes", "1", "--process_id", "0"])
    (run_dir,) = glob.glob(os.path.join(out, "training_run_*"))
    _check_run_dir(variant, run_dir, 1)


@pytest.mark.cuda
def test_cuda_clis_refuse_more_devices_than_the_host_has(card, ckpts, data, whole, tmp_path,
                                                         capsys):
    from crosstalk_tpu_torch.cli.evaluate import main as eval_main
    from crosstalk_tpu_torch.cli.predict import main as predict_main
    from crosstalk_tpu_torch.cli.serve import main as serve_main

    mixed, source = data
    n = torch.cuda.device_count() + 1
    refused = str(tmp_path / "refused")
    for main_fn, argv in (
            (eval_main, ["-m", mixed, "-s", source, "-p", ckpts["single"],
                         "--output_base", refused]),
            (predict_main, ["-m", whole[0], "-s", whole[1], "-p", ckpts["single"],
                            "--output_base", refused]),
            (serve_main, ["-p", ckpts["single"], "--port", "0"])):
        assert main_fn([*argv, "--num_devices", str(n), "--device", DEVICE]) == 1
        out = capsys.readouterr().out
        assert (f"Error: --num_devices {n} requested but only {n - 1} device(s) are "
                "visible.") in out
    assert not os.path.exists(refused)


@pytest.mark.cuda
def test_cuda_two_gloo_ranks_shard_the_eval_engine(card, ckpts, data, tmp_path):
    """The rank-sharded eval engine, ``--fast``, two Gloo ranks on one card
    (NCCL refuses two ranks on one GPU): the gathered rows equal one
    process at the per-rank batch (predictions 1e-6, metrics 1e-5, loss
    1e-6 relative), and each rank launches K1 once per global batch."""
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import TileStore
    from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.parallel.distributed import free_port
    from crosstalk_tpu_torch.tools.multirank import run_eval

    mixed, source = data
    cache = str(tmp_path / "cache")
    TileStore(PairIndex(mixed, source).samples, jobs=4, cache_dir=cache)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "crosstalk_tpu_torch.tools.multirank", "eval", "--rank", str(r),
         "--world", "2", "--port", str(port), "--out", str(tmp_path), "--device",
         f"{DEVICE}:0", "--backend", "gloo", "--variants", "single", "double", "--checkpoint",
         ckpts["single"], ckpts["double"], "-m", mixed, "-s", source, "--fast",
         "--compute_dtype", "bf16", "--batch_size", str(BATCH), "--cache_dir", cache],
        cwd=ROOT, env=_env()) for r in (0, 1)]
    try:
        assert [p.wait(timeout=300) for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    for variant in ("single", "double"):
        sd = {k: v.to(DEVICE) for k, v in load_pth(ckpts[variant]).items()}
        one, loss = run_eval(make_fast_forward(_config(variant), sd), mixed, source,
                             torch.device(DEVICE), BATCH // 2, cache_dir=cache)
        got = ranks[0][variant]["rows"]
        assert got.keys() == one.keys() and got["Image_ID"].tolist() == one["Image_ID"].tolist()
        assert len(got["Image_ID"]) == N_PAIRS
        np.testing.assert_allclose(got["Predicted_Label"], one["Predicted_Label"], rtol=0,
                                   atol=1e-6)
        for k in list(one)[3:]:
            np.testing.assert_allclose(got[k], one[k], rtol=0, atol=1e-5, err_msg=k)
        assert abs(ranks[0][variant]["loss"] - loss) <= 1e-6 * loss
        assert [r[variant]["launches"] for r in ranks] == [math.ceil(N_PAIRS / BATCH)] * 2


@pytest.mark.cuda
def test_cuda_eval_engine_over_two_replicas_equals_one_device(card, ckpts, data):
    """The eval engine over the replica set [cuda:0, cuda:0], ``--fast``:
    every row within 1e-6 of one device at the per-replica batch, K1
    launched by both replicas on every batch."""
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import TileStore
    from crosstalk_tpu_torch.eval.engine import evaluate
    from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.parallel.mesh import replicated_forward
    from crosstalk_tpu_torch.tools.multirank import run_eval

    sd = load_pth(ckpts["single"])

    def replica(d):
        return make_fast_forward(_config("single"), {k: v.to(d) for k, v in sd.items()})

    store = TileStore(PairIndex(*data).samples, jobs=4)
    devices = [f"{DEVICE}:0"] * 2
    (rows, _), launches = _launches(lambda: evaluate(
        replicated_forward(replica, devices), store, torch.device(devices[0]), BATCH,
        replicas=2))
    one, _ = run_eval(replica(DEVICE), *data, torch.device(DEVICE), BATCH // 2)
    assert len(rows) == N_PAIRS and launches == 2 * math.ceil(N_PAIRS / BATCH)
    np.testing.assert_allclose([r["Predicted_Label"] for r in rows], one["Predicted_Label"],
                               rtol=0, atol=1e-6)


# --- the host: the native decoder -------------------------------------------

@pytest.mark.cuda
def test_cuda_host_builds_the_native_decoder_and_it_equals_the_python_one(card, data):
    """The C++ decoder built with ``-march=native`` on the card's host
    decodes every pair (none falls back to Python) to the Python
    decoder's bytes."""
    from crosstalk_tpu_torch.data import native_loader
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import load_tiles

    samples = PairIndex(*data).samples
    before = dict(load_tiles.decoded)
    native = load_tiles(samples, jobs=4)
    counted = dict(load_tiles.decoded)
    python = load_tiles(samples, jobs=4, use_native=False)
    assert native_loader.build_status()["error"] is None
    assert counted["native"] - before["native"] == len(samples)
    assert counted["python"] == before["python"]
    assert np.array_equal(native, python)


# --- the benchmark entry point and the probes -------------------------------

def _run_main(main_fn, argv):
    """-> (exit code, the JSON of the last line ``main_fn`` printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def _finite_positive(values):
    return all(isinstance(v, float) and math.isfinite(v) and v > 0 for v in values)


@pytest.mark.cuda
def test_cuda_bench_at_reduced_sizes(card, monkeypatch, capsys):
    """``tools.bench`` on the card at 64 px, 2 steps a unit: every rate
    finite and positive, the card named; K1 launched on each inference
    measure once per step of its warm-up and 3 timed units (the int8 one
    once more to calibrate); ``--num_devices`` beyond the visible cards is
    a usage error."""
    from crosstalk_tpu_torch.tools import bench

    counts = {}

    def counted(fn, key):
        def run(*args, **kwargs):
            out, counts[key(*args)] = _launches(lambda: fn(*args, **kwargs))
            return out
        return run

    monkeypatch.setattr(bench, "bench_model", counted(bench.bench_model, lambda v, *_: v))
    monkeypatch.setattr(bench, "bench_int8_single",
                        counted(bench.bench_int8_single, lambda *_: "int8"))
    steps = 2
    rc, result = _run_main(bench.main, ["--infer_batch", "16", "--train_batch", "8",
                                        "--scan_len", str(steps), "--image_size", "64",
                                        "--device", DEVICE])
    assert rc == 0
    assert _finite_positive([result[k] for k in ("infer_tps", "train_tps",
                                                 "two_branch_infer_tps",
                                                 "two_branch_train_tps", "int8_infer_tps")])
    assert result["device"] == torch.cuda.get_device_name(0) and result["power_limit"]
    assert counts == {"single": 4 * steps, "double": 4 * steps, "int8": 4 * steps + 1}
    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit) as exit_info:
        bench.main(["--num_devices", str(n), "--device", DEVICE])
    assert exit_info.value.code == 2
    assert f"only {n - 1} cuda device(s) visible" in capsys.readouterr().err


def _narrow(monkeypatch, module):
    from crosstalk_tpu_torch.config import ModelConfig

    monkeypatch.setattr(module, "ModelConfig", functools.partial(
        ModelConfig, initial_filters=8, num_conv_blocks=3, initial_filters_per_branch=4))


def _int8_tier_probe(monkeypatch, tmp_path):
    from crosstalk_tpu_torch.tools import int8_tier_probe, make_dataset

    _narrow(monkeypatch, int8_tier_probe)
    monkeypatch.setattr(int8_tier_probe, "SIZE", SIZE)
    monkeypatch.setattr(int8_tier_probe, "SCAN_LEN", 2)
    with contextlib.redirect_stdout(io.StringIO()):
        assert make_dataset.main([str(tmp_path), "-n", "24", "--size", str(SIZE)]) == 0
    rc, result = _run_main(int8_tier_probe.main, ["--batch", "4", "--data_dir", str(tmp_path),
                                                  "--device", DEVICE])
    families = result["families"].values()
    assert _finite_positive([r[k] for r in families for k in ("bf16_tps", "int8_tps",
                                                              "speedup")])
    assert all(r["bf16_batch"] == r["int8_batch"] == 4 and r["mae_vs_f32"] <= 2e-2
               for r in families)
    # per family: 1 calibration, 4 units x 2 steps of --fast and of int8, 1 deviation
    return rc, 2 * (1 + 2 * 4 * 2 + 1)


def _int8_probe(monkeypatch, tmp_path):
    from crosstalk_tpu_torch.tools import int8_probe

    monkeypatch.setattr(int8_probe, "BLOCKS", [("blockA", 2, 8, 8, 16), ("blockB", 1, 4, 16, 8)])
    monkeypatch.setattr(int8_probe, "SCAN_LEN", 2)
    rc, result = _run_main(int8_probe.main, ["--device", DEVICE])
    blocks = result["blocks"].values()
    assert all(_finite_positive([b["bf16_us_per_img"], b["int8_us_per_img"], b["bf16_tflops"],
                                 b["int8_tops"]]) and b["int8_abs_sum"] > 0 for b in blocks)
    return rc, 0


def _bwd_audit(variant):
    def probe(monkeypatch, tmp_path):
        from crosstalk_tpu_torch.tools import bwd_audit

        _narrow(monkeypatch, bwd_audit)
        for name, value in (("B", 2), ("SCAN", 2), ("SIZE", SIZE)):
            monkeypatch.setattr(bwd_audit, name, value)
        rc, result = _run_main(bwd_audit.main, ["-o", variant, "--device", DEVICE])
        assert list(result) == ["full", "grads", "data_grads", "bf16_grads", "bf16_full"]
        assert _finite_positive(result.values())
        return rc, 0
    return probe


def _two_branch_sol_probe(monkeypatch, tmp_path):
    from crosstalk_tpu_torch.tools import two_branch_sol_probe

    _narrow(monkeypatch, two_branch_sol_probe)
    monkeypatch.setattr(two_branch_sol_probe, "SIZE", SIZE)
    monkeypatch.setattr(two_branch_sol_probe, "MATMUL_N", 64)
    rc, result = _run_main(two_branch_sol_probe.main, ["-b", "2", "--scan", "2",
                                                       "--device", DEVICE])
    assert _finite_positive([result["matmul_tflops"], result["sum_of_stages_us"],
                             result["full_forward_us"]]
                            + [s["us_per_img"] for s in result["stages"].values()])
    return rc, 2 * 4 * 2  # 4 units x 2 steps, input stage and forward


def _two_branch_input_probe(monkeypatch, tmp_path):
    from crosstalk_tpu_torch.tools import two_branch_input_probe

    _narrow(monkeypatch, two_branch_input_probe)
    rc, result = _run_main(two_branch_input_probe.main, ["-b", "2", "--scan", "2", "--size",
                                                         str(SIZE), "--device", DEVICE])
    assert _finite_positive(result["us_per_img"].values())
    assert result["prediction_max_diff"] <= 2e-3
    assert max(result["equivalence_bleed_rel"], result["equivalence_source_rel"]) <= ULP_BF16
    # 1 equivalence call, 4 x 2 kernel-stage steps, 4 x 2 shipping steps, 1 on 8 tiles
    return rc, 1 + 8 + 8 + 1


def _grouped_trunk_probe(monkeypatch, tmp_path):
    from crosstalk_tpu_torch.tools import grouped_trunk_probe

    for name, value in (("B", 2), ("SCAN", 2), ("SIZE", SIZE), ("FEATS", [4, 8, 16, 32])):
        monkeypatch.setattr(grouped_trunk_probe, name, value)
    rc, result = _run_main(grouped_trunk_probe.main, ["--device", DEVICE])
    assert all(_finite_positive(t.values()) for t in result["trunks"].values())
    assert result["equivalence"]["rel_mae"] <= ULP_BF16
    return rc, 0


@pytest.mark.cuda
@pytest.mark.parametrize("probe", [
    _int8_tier_probe, _int8_probe, _bwd_audit("single"), _bwd_audit("double"),
    _two_branch_sol_probe, _two_branch_input_probe, _grouped_trunk_probe,
], ids=["int8_tier_probe", "int8_probe", "bwd_audit_single", "bwd_audit_double",
        "two_branch_sol_probe", "two_branch_input_probe", "grouped_trunk_probe"])
def test_cuda_probe_at_reduced_sizes(card, monkeypatch, tmp_path, probe):
    """Each measuring probe's ``main`` on the card with its module's sizes
    patched small: exit 0, every rate finite and positive, what it holds
    within its bounds, and K1 launched as its measures count (never by
    ``int8_probe``, ``bwd_audit`` and ``grouped_trunk_probe``)."""
    (rc, want), launches = _launches(lambda: probe(monkeypatch, tmp_path))
    assert rc == 0 and launches == want


# --- a run dir the JAX package trained, resumed on the card -----------------

JAX_RUN_TS = "2026-01-01_00-00-00"
JAX_RUN_EPOCHS = 2


@pytest.mark.cuda
def test_cuda_resumes_a_jax_format_run_dir(card, ckpts, data, tmp_path):
    """A two-epoch single-branch run dir in the JAX package's format, written
    without JAX (``tests/jax_format.py``): ``load_checkpoint`` gives the
    written parameters, BN statistics, Adam moments and step counts (after
    layout conversion, on the CPU and restored on the card, step counts on
    the host); ``train --resume`` trains a third epoch, keeps the log's
    rows and ``train_ckpt.jax.bin`` byte for byte; the best model scores
    through ``eval --fast`` with K1 launched once per batch."""
    from crosstalk_tpu_torch.config import OptimConfig
    from crosstalk_tpu_torch.data.index import PairIndex, split_samples
    from crosstalk_tpu_torch.io import artifacts, checkpoint
    from crosstalk_tpu_torch.io.torch_convert import load_pth, save_pth
    from crosstalk_tpu_torch.models.registry import build_model
    from crosstalk_tpu_torch.train.schedules import Schedule
    from crosstalk_tpu_torch.train.steps import init_train_state

    mixed, source = data
    sd = load_pth(ckpts["single"])
    names = [n for n, _ in build_model(_config("single"), image_size=SIZE,
                                       device="meta").named_parameters()]
    rng = np.random.default_rng(14)
    exp_avg = {n: torch.from_numpy((rng.standard_normal(sd[n].shape) * 1e-3)
                                   .astype(np.float32)) for n in names}
    exp_avg_sq = {n: torch.from_numpy((rng.standard_normal(sd[n].shape) * 1e-3) ** 2
                                      + 1e-8).float() for n in names}
    n_train = len(split_samples(PairIndex(mixed, source).samples, 0.7, 0.15, seed=43)[0])
    steps_per_epoch = n_train // BATCH
    step = JAX_RUN_EPOCHS * steps_per_epoch

    run_dir = str(tmp_path / "jax_run" / f"training_run_{JAX_RUN_TS}_B{BATCH}_LR0.0001")
    os.makedirs(os.path.join(run_dir, "checkpoints"))
    artifacts.write_params_txt(run_dir, {
        "mixed_channel_data_dir": mixed, "pure_source_data_dir": source,
        "batch_size": BATCH, "learning_rate": 0.0001, "num_epochs": JAX_RUN_EPOCHS,
        "train_ratio": 0.7, "val_ratio": 0.15, "cpu_jobs": 4, "model_options": "single",
        "learning_scheduler": "onecycle", "initial_filters": 8, "num_conv_blocks": 3,
        "compute_dtype": "bf16", "dropout": None, "output_base": os.path.dirname(run_dir),
        "resume": None, "num_devices": None, "seed": 43, "profile": None,
        "checkpoint_every": 1, "grad_accum": 1, "data_placement": "auto",
        "cache_dir": None, "debug_nans": False, "multihost": False,
        "coordinator_address": None, "num_processes": None, "process_id": None})
    schedule = Schedule(OptimConfig(scheduler="onecycle"), JAX_RUN_EPOCHS, steps_per_epoch)
    train_losses, val_losses, lr_history = [0.05, 0.04], [0.045, 0.041], []
    with artifacts.TrainingLog(run_dir, JAX_RUN_TS, BATCH, 0.0001,
                               schedule.scheduler_type, schedule.params_dict) as log:
        for e in range(JAX_RUN_EPOCHS):
            lr_history.append(schedule.lr_for_step(e * steps_per_epoch))
            schedule.on_epoch_end(val_losses[e])
            log.log_epoch(e + 1, train_losses[e], val_losses[e],
                          schedule.lr_for_step((e + 1) * steps_per_epoch))
    save_pth(os.path.join(run_dir, "best_model_onecycle.pth"), sd)
    blob = jax_format.write_jax_checkpoint(
        os.path.join(run_dir, "checkpoints", "train_ckpt.bin"),
        jax_format.jax_train_state(sd, exp_avg, exp_avg_sq, step), {
            "epoch": JAX_RUN_EPOCHS, "global_step": step, "best_val_loss": min(val_losses),
            "epochs_without_improvement": 0, "train_losses": train_losses,
            "val_losses": val_losses, "lr_history": lr_history,
            "schedule": schedule.state_dict()})

    payload, meta = checkpoint.load_checkpoint(run_dir)
    assert meta["source_format"] == "jax" and meta["epoch"] == JAX_RUN_EPOCHS
    assert payload["step"] == step
    assert all(torch.equal(payload["model"][k], v) for k, v in sd.items()
               if not k.endswith("num_batches_tracked"))
    opt = payload["optimizer"]["state"]
    assert all(torch.equal(opt[i]["exp_avg"], exp_avg[n])
               and torch.equal(opt[i]["exp_avg_sq"], exp_avg_sq[n])
               and float(opt[i]["step"]) == step for i, n in enumerate(names))
    state = init_train_state(build_model(_config("single"), image_size=SIZE, device=DEVICE),
                             OptimConfig())
    checkpoint.restore_state(state, payload)
    restored = state.optimizer.state_dict()["state"]
    assert all(torch.equal(v.cpu(), payload["model"][k])
               for k, v in state.model.state_dict().items())
    assert all(torch.equal(restored[i][k].cpu(), opt[i][k])
               for i in restored for k in restored[i])
    assert all(restored[i]["step"].device.type == "cpu" for i in restored)

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _train_cli(["-m", mixed, "-s", source, "-n", str(JAX_RUN_EPOCHS + 1), "-j", "4",
                    "--resume", run_dir])
    assert "Resumed a JAX-format checkpoint (train_ckpt.bin) at epoch 2" in printed.getvalue()
    _, new_meta = checkpoint.load_checkpoint(run_dir)
    assert "source_format" not in new_meta and new_meta["epoch"] == JAX_RUN_EPOCHS + 1
    assert new_meta["global_step"] == step + steps_per_epoch
    assert new_meta["lr_history"][:JAX_RUN_EPOCHS] == lr_history
    rows = _read_log(run_dir)
    assert len(rows) == JAX_RUN_EPOCHS + 1
    assert [float(v) for v in rows[0][1:3]] == [train_losses[0], val_losses[0]]
    with open(os.path.join(run_dir, "checkpoints", checkpoint.JAX_KEPT_FILE), "rb") as f:
        assert f.read() == blob

    rows, launches = _launches(lambda: _eval_cli(
        ["-m", mixed, "-s", source, "-p", os.path.join(run_dir, "best_model_onecycle.pth"),
         "-j", "4", "--batch_size", str(BATCH), "--device", DEVICE, "-o", "single", "--fast"],
        str(tmp_path / "resumed_fast")))
    assert launches == math.ceil(N_PAIRS / BATCH) and len(rows) == N_PAIRS
    assert np.isfinite(_column(rows, "Predicted_Label")).all()
