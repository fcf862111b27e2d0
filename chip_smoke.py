#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``crosstalk_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit and no result line:

  1. environment: torch and CUDA versions, the card's name and power limit;
     requires a CUDA card;
  2. build the fused input-block kernel (K1) from csrc/ with nvcc;
  3. K1 against its plain PyTorch version on the card at both main-path
     shapes (single-branch block 0, B=64 256x256 C=2 -> 128 with negative BN
     scales; two-branch block-diagonal C=2 -> 2x64), with CUDA-event times of
     the kernel (through the packed entry, weights packed once outside the
     timed call, as on the main path), the plain version and the cuDNN
     chain, beside its bound and its share of it; the kernel's registers,
     shared memory and resident blocks per SM;
  4. the eval path: 256 seeded synthetic 256x256 TIFF pairs scored by the
     eval CLI (``crosstalk_tpu_torch.cli.evaluate.main``) with random
     full-width single- and two-branch models, ``--fast`` and f32; checks
     rows, fast-vs-f32 agreement, f32 vs a float64 run of the same model on
     the card, and K1's launch count on each ``--fast`` run; then the device
     time of each stage of one batch, and of the head's f32-output GEMMs
     against bf16-output ones;
  5. the server in-process, built by ``cli/serve.py``'s ``build_server``
     (single-branch with the f32 and the f16 transport, two-branch with the
     default one; batch 256, buckets 8 and 64) and driven by the port's
     client from 8 threads with 64 seeded requests of 1-200 tiles, half on
     the f16 wire: alphas against the same predictor called directly,
     against the f32-wire answer and against the f32 parity forward; K1's
     launches against the batches dispatched plus the warmup; /metrics;
     served tiles/s, latency, occupancy and device share; where a request's
     time goes;
  6. the serve CLI as a subprocess: /healthz, ``cli/predict.py --url`` and
     ``cli/remote_eval.py`` over the eval pairs against a local ``--fast``
     predict, then SIGTERM and exit 0;
  7. ``cli/predict.py --fast --unmix`` over 16 seeded 1024x1024 pairs (a
     4x4 grid of tiles each) with both models: rows, K1's launches, the
     median of the predictor's tile alphas, the unmixed TIFFs;
  8. training: the train CLI (``crosstalk_tpu_torch.cli.train.main``, bf16,
     ``-b 64 -n 2 -r onecycle``) on both full-width models over the phase-4
     pairs (179 train / 38 val / 39 test): artifact names, log rows, finite
     losses, both .pth files loading; ``--resume`` of the single-branch run
     to 3 epochs against its saved state; the trained checkpoints through
     the eval CLI, ``--fast`` against f32 (K1 launched); an f32 step on the
     card against the same step on the CPU; bf16 step timings at the CLI's
     default ``-b 256`` on device-resident tiles (ms, tiles/s, peak memory,
     share of the bf16 peak, the split into data, forward, backward and
     optimizer, steps/s with and without a per-step ``.item()``, one
     ``--grad_accum 4`` step and its peak memory);
  9. the int8 tier and the AOT artifact: the trained weights are phase 8's
     single-branch checkpoint trained on until its f32 predictions on the
     phase-4 tiles spread over more than 1e-2 (so that a trunk telling no
     tile apart fails the bounds below); ``calibrate_int8`` over 256 tiles
     (wall, K1 launched); one int8 conv block (single-branch block 1) on the
     card against the CPU, int32 accumulators and bf16 output bitwise; the
     full single-branch int8 forward card vs CPU, and everything after
     block 0 card vs CPU from one block-0 output (bf16 and int8 head, random
     and trained weights), each beside the spread of its predictions and,
     for the trained weights, a bound under half that spread; int8 vs f32
     MAE on the random and trained weights, beside the spread of the f32
     predictions and the best constant's MAE (the trained bound is at most
     half of it); int8 forward times per batch
     of 64 and 256 for both models, split into K1, quantize, int8 products
     and epilogue, with peak memory and the ``--fast`` time beside them;
     ``predict --int8`` over the whole
     images; ``serve --quantize int8`` in process (K1 counted) and as a
     subprocess driven by ``predict --url`` and ``remote_eval``, served
     against the in-process int8 predictor, and a ``/reload`` of the
     trained checkpoint that must recalibrate; the export tool on the card
     (both models' bf16 artifacts, the single-branch int8 one), each loaded
     in a fresh process where ``import crosstalk_tpu_torch`` fails and held
     against the live tier with and without K1, its time per batch of 64;
     then ``predict --artifact`` and ``serve --artifact``;
 10. data parallel on the one card: the train CLI as a one-rank NCCL
     cluster (``--multihost --num_processes 1``, both models, ``-b 64 -n
     1``: the run-dir artifacts), the DDP step's first loss and gradients
     against the plain step's bitwise, and ms per bf16 step at ``-b 256``
     with and without DDP; two Gloo ranks on cuda:0 (NCCL refuses two ranks
     on one card) against one rank: an f32 step at global batch 8, and the
     rank-sharded eval engine ``--fast`` on the phase-4 tiles for both
     models (K1 counted in both ranks); the replica set [cuda:0, cuda:0]
     through ``make_predictor`` and the eval engine against one replica;
     the eval, predict and serve CLIs refusing more devices than the host
     has. Two ranks on one card check the arithmetic, not scaling;
 11. the host and workflow tools: the native C++ TIFF decoder (its g++
     build wall at first use; the 256 phase-4 pairs decoded natively and by
     the Python decoder with 8 threads, bitwise equal, pairs/s of each);
     ``tools/scale_bench`` on the single-branch model at full width over
     1024 generated 256x256 pairs (the cold packed-cache build rate, one
     ``-b 128`` epoch of the train path, and with ``--feed_only`` the host
     feed alone); ``python -m crosstalk_tpu_torch evaluate --fast`` in
     process (its CSV equal to phase 4's) and ``--help`` as a subprocess;
     ``doctor`` on the single-branch checkpoint at 256 px; ``serve_bench``
     with 8 clients for 10 s; ``analyse`` over the run dirs of phases 8 and
     10 against their logs; ``unmix_demo`` (4 pairs) on phase 9's trained
     weights; a 2x1 ``sweep`` with ``--analyse`` and one ``distill`` epoch;
     and the decoder counter: no pair of phases 4-11's float64 sets fell
     back to the Python decoder;
 12. the benchmark entry point: ``crosstalk_tpu_torch.tools.bench.main([])``
     at its defaults (both models at full width, the int8 tier, 256x256
     tiles): every rate finite and positive, the batches that ran (a
     halving is printed), K1's launches on each inference measure (4 x 32:
     the warm-up and three timed units; the int8 one adds its calibration),
     its ``infer_tps`` against phase 4's normalize + ``--fast`` rate at
     batch 64 (a ratio outside 0.5-2 fails: the bench would time the wrong
     work), ``--num_devices`` beyond the visible cards as a usage error, and
     K1's time at the bench's batches (512 and 256) beside its bound there,
     its plain version's and the cuDNN chain's;
 13. the measuring probes (``crosstalk_tpu_torch/tools/``), each through its
     ``run`` at full width: ``int8_tier_probe`` (both families at batch 512
     on 100 ``make_dataset --preset microscopy`` tiles, then ``-p`` on phase
     8's single-branch checkpoint; its int8 rate against phase 12's
     ``int8_infer_tps``, 0.8-1.25; the trained MAE vs f32 within 2e-2),
     ``int8_probe`` (int32 accumulators not all zero), ``bwd_audit -o
     single`` and ``-o double``, ``two_branch_sol_probe`` and
     ``two_branch_input_probe`` at their defaults (prediction max |diff|
     within 2e-3, the kernel's branches within 2^-7 x max |y| of the cuDNN
     blocks) and ``grouped_trunk_probe`` (mean |diff| within 2^-7 x mean
     |y|): every rate finite and positive; K1's launches per probe path (0
     on ``int8_probe``, ``bwd_audit`` and ``grouped_trunk_probe``), and K1
     against its plain version at the probes' batches that phases 1 and 12
     do not hold (two-branch 512 and 8, both at 100).

Each path that runs K1 starts with its launch count at 0 and is read just
after (``launches_by_path`` in the kernels JSON). Every number is printed
beside the card's name and power limit. Before the last three lines come
the phase-8 to phase-13 JSON lines (phase 12's holds the bench's JSON,
the card and its wall; phase 13's each probe's result); the last three are the kernels JSON,
the nvidia-smi line and ``{"ok": true, "device": {...}}``.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import csv
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
N_PAIRS = 256
SIZE = 256
BATCH = 64
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak
ULP_BF16 = 2.0 ** -7
CARD = "card not read yet"  # nvidia-smi's name and power limit, set below


def check(ok: bool, msg: str) -> None:
    print(("PASS: " if ok else "FAIL: ") + msg, flush=True)
    if not ok:
        sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def phase_environment() -> str:
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    global CARD
    CARD = smi
    return smi


def phase_build() -> dict:
    """Build K1 from csrc/; -> its resources at C=2 (both main-path shapes)."""
    from crosstalk_tpu_torch.ops import _build
    from crosstalk_tpu_torch.ops.input_block import kernel_resources

    t0 = time.perf_counter()
    path = _build.build("input_block")
    _build.load("input_block")
    print(f"built {path.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    res = kernel_resources(2)
    print(f"K1 (C=2): {res['registers']} registers/thread, {res['shared_bytes']} B "
          f"shared memory/block, {res['local_bytes']} B local (spill)/block, "
          f"{res['threads']} threads/block, {res['blocks_per_sm']} resident blocks/SM",
          flush=True)
    check(res["blocks_per_sm"] >= 1, "K1 fits on an SM")
    return res


def k1_inputs(gen: torch.Generator, two_branch: bool, batch: int = BATCH):
    """Flagship block-0 inputs on the card; every fifth BN scale negative."""
    dev = "cuda"
    x = torch.rand(batch, SIZE, SIZE, 2, device=dev, generator=gen)
    f = 64 if two_branch else 128
    if two_branch:  # both branches' C=1 kernels, block-diagonal
        kernel = torch.zeros(3, 3, 2, 2 * f, device=dev)
        kernel[:, :, 0:1, :f] = torch.randn(3, 3, 1, f, device=dev, generator=gen) * 0.3
        kernel[:, :, 1:2, f:] = torch.randn(3, 3, 1, f, device=dev, generator=gen) * 0.3
        f *= 2
    else:
        kernel = torch.randn(3, 3, 2, f, device=dev, generator=gen) * 0.3
    scale = torch.randn(f, device=dev, generator=gen) * 0.3 + 1.0
    scale[::5] = -scale[::5]
    bias = torch.randn(f, device=dev, generator=gen) * 0.2
    return x, kernel, scale, bias


def cudnn_chain(x, kernel, scale, bias):
    """-> a call of the cuDNN chain computing K1's function: bf16
    channels_last conv, affine, LeakyReLU, 2x2 max pool (timed only; the
    port never calls it)."""
    x_nchw = x.permute(0, 3, 1, 2)
    w_cl = kernel.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    s_b = scale.to(torch.bfloat16).view(1, -1, 1, 1)
    b_b = bias.to(torch.bfloat16).view(1, -1, 1, 1)

    def library():
        z = F.conv2d(x_nchw.to(torch.bfloat16), w_cl, padding=1)
        return F.max_pool2d(F.leaky_relu(z * s_b + b_b, 0.01), 2)

    return library


def phase_k1(gen: torch.Generator, two_branch: bool, batch: int = BATCH) -> dict:
    """K1 at ``batch`` rows: packed and public entries byte-equal, held
    against its plain version (BATCH rows at a time, so the f32 reference
    stays small at the bench's batches), timed beside that version, the
    cuDNN chain and its bound."""
    from crosstalk_tpu_torch.ops.input_block import (
        fused_input_block,
        fused_input_block_packed,
        fused_input_block_reference,
        pack_input_block,
    )

    label = "two-branch block-diagonal" if two_branch else "single-branch"
    label = f"{label}, batch {batch}"
    x, kernel, scale, bias = k1_inputs(gen, two_branch, batch)
    packed = pack_input_block(kernel, scale, bias)
    y = fused_input_block_packed(x, packed)
    public = fused_input_block(x, kernel, scale, bias)
    torch.cuda.synchronize()
    check(torch.equal(y.view(torch.int16), public.view(torch.int16)),
          f"K1 {label}: packed and public entries give identical bytes")
    del public
    want = (batch, SIZE // 2, SIZE // 2, kernel.shape[-1])
    check(tuple(y.shape) == want and y.dtype == torch.bfloat16,
          f"K1 {label}: shape {tuple(y.shape)} {y.dtype} (expected {want} bfloat16)")
    finite, max_rel, max_abs_small, max_abs = True, 0.0, 0.0, 0.0
    for i in range(0, batch, BATCH):
        yf = y[i:i + BATCH].float()
        rf = fused_input_block_reference(x[i:i + BATCH], kernel, scale, bias).float()
        diff = (yf - rf).abs()
        big = rf.abs() > 1e-3
        finite = finite and bool(torch.isfinite(yf).all())
        if big.any():
            max_rel = max(max_rel, (diff[big] / rf.abs()[big]).max().item())
        if (~big).any():
            max_abs_small = max(max_abs_small, diff[~big].max().item())
        max_abs = max(max_abs, diff.max().item())
    del y
    check(finite and max_rel <= ULP_BF16 and max_abs_small <= 1e-5,
          f"K1 {label} vs plain: max rel {max_rel:.3e} (tol {ULP_BF16:.3e} "
          f"where |y| > 1e-3), max abs elsewhere {max_abs_small:.3e} (tol 1e-5)")

    ms = time_ms(lambda: fused_input_block_packed(x, packed))
    plain_ms = time_ms(lambda: fused_input_block_reference(x, kernel, scale, bias))
    library_ms = time_ms(cudnn_chain(x, kernel, scale, bias))

    b, h, w, c = x.shape
    f = kernel.shape[-1]
    bytes_moved = (x.numel() * 4 + kernel.numel() * 4 + (scale.numel() + bias.numel()) * 4
                   + b * (h // 2) * (w // 2) * f * 2)
    flops = 2 * b * h * w * int(torch.count_nonzero(kernel))
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"K1 {label} ({CARD}): kernel {ms:.4f} ms ({ms * 1e3 / b:.3f} us/tile), "
          f"plain {plain_ms:.4f} ms, cuDNN chain {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_ms * 1e3 / b:.3f} us/tile; "
          f"{bytes_moved} B, {flops} FLOP), share of bound {bound_ms / ms:.3f}",
          flush=True)
    return {
        "batch": batch, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_share": bound_ms / ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def write_dataset(root: str, rng: np.random.Generator):
    from crosstalk_tpu_torch.data.tiff import write_tile

    mixed_dir = os.path.join(root, "Mixed")
    source_dir = os.path.join(root, "Source")
    os.makedirs(mixed_dir)
    os.makedirs(source_dir)
    for i in range(N_PAIRS):
        alpha = round(float(rng.uniform(0.01, 0.5)), 2)
        source = rng.random((SIZE, SIZE))
        mixed = rng.random((SIZE, SIZE)) + alpha * source
        name = f"image_{1000 + i}_alpha_{alpha}"
        write_tile(os.path.join(mixed_dir, f"{name}_mixed.tif"), mixed)
        write_tile(os.path.join(source_dir, f"{name}_source.tif"), source)
    return mixed_dir, source_dir


def make_checkpoint(variant: str, path: str):
    """Random full-width model from a torch.Generator, BN statistics burnt
    in with three train-mode forwards on the card, saved as a .pth."""
    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.io.torch_convert import save_pth
    from crosstalk_tpu_torch.models.registry import build_model, count_params, init_model

    model = build_model(ModelConfig(variant=variant), image_size=SIZE)
    init_model(model, torch.Generator().manual_seed(SEED))
    model = model.cuda().train()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    with torch.no_grad():
        for _ in range(3):
            model(torch.rand(4, 2, SIZE, SIZE, device="cuda", generator=gen))
    model.eval()
    save_pth(path, model.state_dict())
    print(f"{variant}: {count_params(model):,} params -> {os.path.basename(path)}",
          flush=True)
    return model


def run_cli(args) -> tuple:
    from crosstalk_tpu_torch.cli.evaluate import main as eval_main

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = eval_main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(rc == 0, f"eval CLI {' '.join(args[-4:])} exit code {rc}")
    out_base = args[args.index("--output_base") + 1]
    csvs = glob.glob(os.path.join(out_base, "eval_run_*", "test_predictions_*.csv"))
    check(len(csvs) == 1, f"one predictions CSV under {out_base}")
    with open(csvs[0]) as f:
        rows = list(csv.DictReader(f))
    return rows, seconds


def float64_reference(model, mixed_dir, source_dir, n: int) -> np.ndarray:
    """The same model in float64 on the card over the first ``n`` samples."""
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import load_tiles

    tiles = load_tiles(PairIndex(mixed_dir, source_dir).samples[:n]).astype(np.float64)
    lo = tiles.min(axis=(1, 2), keepdims=True)
    hi = tiles.max(axis=(1, 2), keepdims=True)
    batch = torch.from_numpy((tiles - lo) / (hi - lo)).permute(0, 3, 1, 2).cuda()
    m64 = model.double()
    with torch.no_grad():
        out = m64(batch)[:, 0].cpu().numpy()
    model.float()
    return out


def phase_main_path(root: str, by_path: dict):
    """-> ({variant: checkpoint path}, mixed dir, source dir); ``by_path``
    gets K1's launches of each variant's --fast run."""
    from crosstalk_tpu_torch.ops.input_block import fused_input_block

    mixed_dir, source_dir = write_dataset(root, np.random.default_rng(SEED))
    print(f"wrote {N_PAIRS} pairs of {SIZE}x{SIZE} float64 TIFFs", flush=True)
    expect_launches = math.ceil(N_PAIRS / BATCH)
    ckpts = {}
    for variant in ("single", "double"):
        ckpt = ckpts[variant] = os.path.join(root, f"{variant}.pth")
        model = make_checkpoint(variant, ckpt)
        common = ["-m", mixed_dir, "-s", source_dir, "-p", ckpt, "-j", "8",
                  "--batch_size", str(BATCH), "--device", "cuda", "-o", variant]
        fused_input_block.launches = 0
        fast_rows, fast_s = run_cli(common + ["--output_base", os.path.join(root, f"{variant}_fast"), "--fast"])
        launches = by_path[f"eval_{variant}"] = fused_input_block.launches
        check(launches == expect_launches,
              f"{variant} --fast: K1 launched {launches} times "
              f"(expected {expect_launches} = ceil({N_PAIRS}/{BATCH}))")
        f32_rows, f32_s = run_cli(common + ["--output_base", os.path.join(root, f"{variant}_f32")])
        check(fast_rows and f32_rows and len(fast_rows) == len(f32_rows) == N_PAIRS,
              f"{variant}: {len(fast_rows)} and {len(f32_rows)} CSV rows (expected {N_PAIRS})")
        check([r["Image_ID"] for r in fast_rows] == [r["Image_ID"] for r in f32_rows],
              f"{variant}: same row order in both runs")
        fast_p = np.array([float(r["Predicted_Label"]) for r in fast_rows])
        f32_p = np.array([float(r["Predicted_Label"]) for r in f32_rows])
        metrics = np.array([[float(r[k]) for k in list(r)[3:]] for r in f32_rows])
        check(bool(np.isfinite(fast_p).all() and np.isfinite(f32_p).all()
                   and np.isfinite(metrics).all()),
              f"{variant}: predictions and metrics finite")
        mae = float(np.abs(fast_p - f32_p).mean())
        check(mae <= 2e-3, f"{variant}: --fast vs f32 Predicted_Label MAE {mae:.3e} (tol 2e-3)")
        n_ref = 64
        ref = float64_reference(model, mixed_dir, source_dir, n_ref)
        err = float(np.abs(f32_p[:n_ref] - ref).max())
        check(err <= 1e-4, f"{variant}: f32 CLI vs float64 model on the card, "
                           f"first {n_ref} tiles: max |diff| {err:.3e} (tol 1e-4)")
        print(f"{variant}: eval CLI wall (decode, model load, eval, CSV, plots "
              f"where matplotlib exists): --fast {fast_s:.2f} s = "
              f"{N_PAIRS / fast_s:.1f} tiles/s, f32 {f32_s:.2f} s = "
              f"{N_PAIRS / f32_s:.1f} tiles/s", flush=True)
        del model
        torch.cuda.empty_cache()
    return ckpts, mixed_dir, source_dir


def time_stages(variant: str, ckpt: str) -> dict:
    """Device time of each stage of one eval batch (B=64, 256x256): the
    normalize, the --fast and f32 forwards, and the five metrics. -> the
    stage times in ms."""
    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
    from crosstalk_tpu_torch.eval.engine import model_forward
    from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.models.registry import build_model
    from crosstalk_tpu_torch.ops.metrics import classical_metrics

    cfg = ModelConfig(variant=variant)
    model = build_model(cfg, image_size=SIZE, device="cuda")
    model.load_state_dict(load_pth(ckpt))

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    raw = torch.rand(BATCH, SIZE, SIZE, 2, device="cuda", generator=gen) * 3.0
    batch = normalize_batch_nhwc(raw)
    fast = make_fast_forward(cfg, model.state_dict())
    f32 = model_forward(model)
    with torch.inference_mode():
        times = {
            "normalize": time_ms(lambda: normalize_batch_nhwc(raw), iters=10),
            "fast_forward": time_ms(lambda: fast(batch), iters=10),
            "f32_forward": time_ms(lambda: f32(batch), iters=5),
            "metrics": time_ms(lambda: classical_metrics(batch), iters=5),
        }
    print(f"{variant} stages per batch of {BATCH} (ms, CUDA events, {CARD}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; --fast forward {BATCH / times['fast_forward'] * 1e3:.0f} tiles/s",
          flush=True)

    # the head's three GEMMs at this batch: bf16 products kept in f32 (the
    # port's route, cuBLAS with f32 output) against products rounded to bf16
    from crosstalk_tpu_torch.eval.fast_forward import _matmul_f32
    from crosstalk_tpu_torch.io.torch_convert import structure

    _, head = structure(variant)
    sd = model.state_dict()
    weights = [sd[f"{head}.{i}.weight"].to(torch.bfloat16).contiguous() for i in (1, 5, 9)]
    xs = [torch.randn(BATCH, w.shape[1], device="cuda", generator=gen).to(torch.bfloat16)
          for w in weights]
    with torch.inference_mode():
        f32_out = time_ms(lambda: [_matmul_f32(x, w) for x, w in zip(xs, weights)])
        bf16_out = time_ms(lambda: [F.linear(x, w).float() for x, w in zip(xs, weights)])
    print(f"{variant} head GEMMs per batch of {BATCH} ({CARD}): f32 output "
          f"{f32_out:.4f} ms, bf16 output {bf16_out:.4f} ms "
          f"(first layer {weights[0].shape[1]} -> {weights[0].shape[0]})", flush=True)
    return times


SERVE_SIZES = (1, 3, 17, 64, 200)
N_REQUESTS = 64
N_CLIENTS = 8
SERVE_TOL = 2e-3
SERVE_BATCH = 256
SERVE_FLAGS = ["--batch_size", str(SERVE_BATCH), "--batch_buckets", "8,64", "--port", "0",
               "--max_delay_ms", "5"]


def serve_requests():
    """The seeded requests: raw float64 intensities, sizes drawn from
    SERVE_SIZES; odd-numbered requests go on the f16 wire."""
    rng = np.random.default_rng(SEED + 3)
    sizes = rng.choice(SERVE_SIZES, size=N_REQUESTS)
    return [(rng.random((int(n), SIZE, SIZE, 2)) * 1800 + 100,
             "float16" if i % 2 else "float32") for i, n in enumerate(sizes)]


def decoded(tiles: np.ndarray, wire: str, transport: str) -> np.ndarray:
    """What the server's batcher holds for ``tiles`` sent on ``wire``: the
    client's wire transform, then the server's decode to its transport."""
    from crosstalk_tpu_torch.serve.wire import to_f16_wire

    sent = to_f16_wire(tiles, (1, 2)) if wire == "float16" else tiles.astype(np.float32)
    if sent.dtype == np.dtype(transport):
        return sent
    return to_f16_wire(sent, (1, 2)) if transport == "float16" else sent.astype(np.float32)


def predict_in_buckets(predict, arrays, batch: int) -> np.ndarray:
    """``predict`` over the concatenated ``arrays`` in padded batches."""
    rows = np.concatenate(arrays)
    out = np.empty(len(rows), np.float32)
    for start in range(0, len(rows), batch):
        chunk = rows[start:start + batch]
        real = len(chunk)
        if real < batch:
            chunk = np.concatenate([chunk, np.zeros((batch - real,) + chunk.shape[1:], chunk.dtype)])
        out[start:start + real] = predict(chunk)[:real]
    return out


def drive_server(url: str, requests):
    """Send ``requests`` from N_CLIENTS threads -> (alphas per request,
    latency s per request, wall s)."""
    import threading

    from crosstalk_tpu_torch.serve.client import CrosstalkClient

    results = [None] * len(requests)
    latency = [None] * len(requests)

    def worker(t):
        client = CrosstalkClient(url, timeout=300)
        for i in range(t, len(requests), N_CLIENTS):
            tiles, wire = requests[i]
            t0 = time.perf_counter()
            try:
                results[i] = client.predict(tiles, dtype=wire)
            except Exception as e:  # reported by the check below
                results[i] = e
            latency[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(N_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads), "every client thread finished")
    return results, latency, wall


def request_breakdown(label, predict_forward, transport: str, wire: str) -> None:
    """Where a 64-tile request's time goes, by stage: the client's wire
    encode (cast or f16 rescale, npz), the server's decode of the body,
    batch assembly, host-to-device copy, forward (normalize included; CUDA
    events), response encoding. Host stages are medians of 5 on the host
    clock."""
    import io as _io

    from crosstalk_tpu_torch.serve.server import _decode_request
    from crosstalk_tpu_torch.serve.wire import to_f16_wire

    rng = np.random.default_rng(SEED + 4)
    tiles = (rng.random((BATCH, SIZE, SIZE, 2)) * 1800 + 100).astype(np.float32)

    def encode():
        buf = _io.BytesIO()
        np.savez(buf, tiles=to_f16_wire(tiles, (1, 2)) if wire == "float16" else tiles)
        return buf.getvalue()

    def host_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    body = encode()
    batch = _decode_request(body, (SIZE, SIZE), 4096, np.dtype(transport))

    def assemble():
        out = np.zeros_like(batch)
        out[:] = batch

    def h2d():
        torch.from_numpy(batch).to("cuda")
        torch.cuda.synchronize()

    x = torch.from_numpy(batch).to("cuda").float()
    alphas = predict_forward(x).cpu().numpy()
    stages = {
        "encode": host_ms(encode),
        "decode": host_ms(lambda: _decode_request(body, (SIZE, SIZE), 4096, np.dtype(transport))),
        "assembly": host_ms(assemble),
        "h2d": host_ms(h2d),
        "forward": time_ms(lambda: predict_forward(x), iters=10),
        "response": host_ms(lambda: json.dumps(
            {"alpha": [float(a) for a in alphas], "n": len(alphas)}).encode()),
    }
    print(f"{label} one request of {BATCH} tiles, {wire} wire ({len(body) / 2**20:.1f} MiB "
          f"body), {transport} transport ({CARD}), ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()), flush=True)


def phase_serve(root: str, ckpts: dict, by_path: dict) -> None:
    """The server in-process, built by the serve CLI's build function."""
    import urllib.request

    from crosstalk_tpu_torch.cli.serve import build_parser, build_server
    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.io.export import make_forward
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.ops.input_block import fused_input_block
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    requests = serve_requests()
    n_tiles = sum(len(t) for t, _ in requests)
    print(f"serving: {N_REQUESTS} requests, {n_tiles} tiles of {SIZE}x{SIZE} "
          f"(sizes {sorted(set(len(t) for t, _ in requests))})", flush=True)
    references = {}
    for path, variant, transport in (("serve_single_f32", "single", "float32"),
                                     ("serve_single_f16", "single", "float16"),
                                     ("serve_double", "double", None)):
        argv = ["-p", ckpts[variant], "-o", variant, *SERVE_FLAGS]
        if transport is not None:
            argv += ["--transport_dtype", transport]
        transport = transport or "float32"
        fused_input_block.launches = 0
        server, info = build_server(build_parser().parse_args(argv))
        warmup = fused_input_block.launches
        try:
            server.start_background()
            url = "http://%s:%d" % server.address
            results, latency, wall = drive_server(url, requests)
            with urllib.request.urlopen(url + "/stats", timeout=60) as r:
                stats = json.load(r)
            launches = by_path[path] = fused_input_block.launches
            with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
                metrics = r.read().decode()
        finally:
            server.shutdown()
        bad = [r for r in results if not isinstance(r, np.ndarray)]
        check(not bad, f"{path}: every request resolved ({bad[:1]})")
        check(all(r.shape == (len(t),) and np.isfinite(r).all()
                  for r, (t, _) in zip(results, requests)),
              f"{path}: {N_REQUESTS} finite answers of the request's size")
        check(warmup == 3 and launches == stats["batches"] + warmup,
              f"{path}: K1 launched {launches} times = {stats['batches']} batches "
              f"dispatched + {warmup} warmup (one per bucket)")
        names = {ln.split()[0] for ln in metrics.splitlines() if ln and not ln.startswith("#")}
        want = {f"crosstalk_{k}" for k in (
            "requests_total", "tiles_total", "batches_total", "padded_rows_total",
            "batch_capacity_rows_total", "device_seconds_total", "model_reloads_total",
            "batch_occupancy", "batch_size")}
        check(want <= names and stats["requests"] == N_REQUESTS and stats["tiles"] == n_tiles,
              f"{path}: /metrics lists all {len(want)} counters; /stats counts "
              f"{stats['requests']} requests, {stats['tiles']} tiles")

        # the same predictor, called directly at its largest bucket on what the
        # batcher held; the f32 fast and parity forwards of the same model
        predict = server.batcher._predict
        direct = predict_in_buckets(predict, [decoded(t, w, transport) for t, w in requests],
                                    SERVE_BATCH)
        if variant not in references:
            sd = load_pth(ckpts[variant])
            cfg = ModelConfig(variant=variant)
            f32_input = [t.astype(np.float32) for t, _ in requests]
            fast = make_predictor(sd, cfg, SERVE_BATCH, image_size=SIZE, warmup=False)
            parity = make_predictor(sd, ModelConfig(variant=variant, compute_dtype="f32"),
                                    SERVE_BATCH, image_size=SIZE, fast=False, warmup=False)
            references[variant] = (predict_in_buckets(fast, f32_input, SERVE_BATCH),
                                   predict_in_buckets(parity, f32_input, SERVE_BATCH))
            del fast, parity
            torch.cuda.empty_cache()
        forward = make_forward(ModelConfig(variant=variant), load_pth(ckpts[variant]),
                               device="cuda")
        for wire in ("float32", "float16"):
            request_breakdown(path, forward, transport, wire)
        del forward
        ref_fast, ref_parity = references[variant]
        served = np.concatenate(results)
        on_f16 = np.concatenate([np.full(len(t), w == "float16") for t, w in requests])
        err_direct = float(np.abs(served - direct)[~on_f16].max())
        err_wire = float(np.abs(served - ref_fast)[on_f16].max())
        mae = float(np.abs(served - ref_parity).mean())
        check(err_direct <= SERVE_TOL, f"{path}: f32-wire alphas vs the same predictor "
                                       f"at bucket {SERVE_BATCH}: max |diff| {err_direct:.3e} (tol {SERVE_TOL})")
        check(err_wire <= SERVE_TOL, f"{path}: f16-wire alphas vs the f32 alphas of the "
                                     f"same tiles: max |diff| {err_wire:.3e} (tol {SERVE_TOL})")
        check(mae <= SERVE_TOL, f"{path}: served alphas vs the f32 parity forward: "
                                f"MAE {mae:.3e} (tol {SERVE_TOL})")
        ms = np.array(latency) * 1e3
        print(f"{path} ({CARD}): {n_tiles / wall:.1f} tiles/s served over {wall:.2f} s, "
              f"request latency p50 {np.percentile(ms, 50):.1f} ms p99 "
              f"{np.percentile(ms, 99):.1f} ms, {stats['batches']} batches, mean "
              f"occupancy {stats['mean_batch_occupancy']:.3f}, device_seconds "
              f"{stats['device_seconds']:.3f} s = {stats['device_seconds'] / wall:.3f} "
              f"of the wall", flush=True)
        del server, predict
        torch.cuda.empty_cache()


def read_csv(pattern: str):
    paths = glob.glob(pattern)
    check(len(paths) == 1, f"one CSV matches {pattern}")
    with open(paths[0]) as f:
        return list(csv.DictReader(f))


def phase_serve_cli(root: str, ckpt: str, mixed_dir: str, source_dir: str) -> None:
    """``python -m crosstalk_tpu_torch.cli.serve`` as a subprocess, scored
    over the serving wire by the predict and remote-eval CLIs."""
    import queue
    import re
    import signal
    import threading

    from crosstalk_tpu_torch.cli.predict import main as predict_main
    from crosstalk_tpu_torch.cli.remote_eval import main as remote_eval_main
    from crosstalk_tpu_torch.serve.client import CrosstalkClient

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "crosstalk_tpu_torch.cli.serve", "-p", ckpt, "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=here)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    try:
        url, seen = None, []
        deadline = time.monotonic() + 120
        while url is None and time.monotonic() < deadline:
            try:
                line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                break
            seen.append(line)
            if line.startswith("Serving on "):
                url = line.split()[2]
        check(url is not None, "serve CLI printed its 'Serving on' line within 120 s"
              + ("" if url else ":\n" + "".join(seen[-20:])))
        print(f"serve CLI subprocess listening after {time.perf_counter() - t0:.2f} s "
              f"({CARD})", flush=True)
        health = CrosstalkClient(url).health()
        check(health.get("status") == "ok" and health.get("path") == "bf16-serving",
              f"serve CLI /healthz: {health}")

        t1 = time.perf_counter()
        rc = predict_main(["-m", mixed_dir, "-s", source_dir, "--url", url,
                           "--output_base", os.path.join(root, "url")])
        url_s = time.perf_counter() - t1
        check(rc == 0, f"predict --url exit code {rc}")
        t1 = time.perf_counter()
        rc = remote_eval_main(["-m", mixed_dir, "-s", source_dir, "--url", url,
                               "-o", os.path.join(root, "remote")])
        remote_s = time.perf_counter() - t1
        check(rc == 0, f"remote_eval exit code {rc}")
        proc.send_signal(signal.SIGTERM)
        try:
            code = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            code = None
        check(code == 0, f"serve CLI exits {code} within 30 s of SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)

    rc = predict_main(["-m", mixed_dir, "-s", source_dir, "-p", ckpt, "--fast",
                       "-b", str(BATCH), "--output_base", os.path.join(root, "local")])
    check(rc == 0, f"local --fast predict exit code {rc}")
    local = {r["Image_Key"]: float(r["Predicted_Alpha"])
             for r in read_csv(os.path.join(root, "local", "predict_run_*", "predictions_*.csv"))}
    remote = read_csv(os.path.join(root, "url", "predict_run_*", "predictions_*.csv"))
    check(len(remote) == len(local) == N_PAIRS, f"{len(remote)} --url rows, {len(local)} local")
    err = max(abs(float(r["Predicted_Alpha"]) - local[r["Image_Key"]]) for r in remote)
    check(err <= SERVE_TOL, f"predict --url (f16 wire) vs local --fast: max |diff| "
                            f"{err:.3e} (tol {SERVE_TOL})")
    by_id = {int(re.match(r"image_(\d+)_alpha", k).group(1)): v for k, v in local.items()}
    evals = read_csv(os.path.join(root, "remote", "eval_run_*", "test_predictions_*.csv"))
    check(len(evals) == N_PAIRS, f"remote_eval wrote {len(evals)} rows")
    err = max(abs(float(r["Predicted_Label"]) - by_id[int(r["Image_ID"])]) for r in evals)
    check(err <= SERVE_TOL, f"remote_eval Predicted_Label vs local --fast: max |diff| "
                            f"{err:.3e} (tol {SERVE_TOL})")
    print(f"serve CLI ({CARD}): predict --url {url_s:.2f} s = {N_PAIRS / url_s:.1f} tiles/s, "
          f"remote_eval {remote_s:.2f} s = {N_PAIRS / remote_s:.1f} tiles/s "
          f"(decode, f16 wire, HTTP, CSV)", flush=True)


WHOLE_PAIRS = 16
WHOLE_SIZE = 1024


def phase_predict_whole_image(root: str, ckpts: dict, by_path: dict) -> None:
    """``cli/predict.py --fast --unmix`` over whole 1024x1024 images."""
    from crosstalk_tpu_torch.cli.predict import _grid_images
    from crosstalk_tpu_torch.cli.predict import main as predict_main
    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.data.index import pair_unlabeled
    from crosstalk_tpu_torch.data.pipeline import load_tiles
    from crosstalk_tpu_torch.data.tiff import read_tile, write_tile
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.ops.input_block import fused_input_block
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    mixed_dir = os.path.join(root, "whole", "Mixed")
    source_dir = os.path.join(root, "whole", "Source")
    os.makedirs(mixed_dir)
    os.makedirs(source_dir)
    rng = np.random.default_rng(SEED + 5)
    for i in range(WHOLE_PAIRS):
        source = rng.random((WHOLE_SIZE, WHOLE_SIZE))
        mixed = rng.random((WHOLE_SIZE, WHOLE_SIZE)) + rng.uniform(0.01, 0.5) * source
        write_tile(os.path.join(mixed_dir, f"acq{i:02d}_mixed.tif"), mixed)
        write_tile(os.path.join(source_dir, f"acq{i:02d}_source.tif"), source)
    per_image = (WHOLE_SIZE // SIZE) ** 2
    n_tiles = WHOLE_PAIRS * per_image
    samples = pair_unlabeled(mixed_dir, source_dir).samples
    images = load_tiles(samples, jobs=8)
    crops, _ = _grid_images(images, SIZE)
    expect = math.ceil(n_tiles / BATCH)
    for variant, ckpt in ckpts.items():
        out = os.path.join(root, "whole", variant)
        fused_input_block.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = predict_main(["-m", mixed_dir, "-s", source_dir, "-p", ckpt, "-o", variant,
                           "--fast", "-b", str(BATCH), "--unmix", "--output_base", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = by_path[f"predict_{variant}"] = fused_input_block.launches
        check(rc == 0, f"predict {variant} --fast --unmix exit code {rc}")
        check(launches == expect, f"predict {variant}: K1 launched {launches} times "
                                  f"(expected {expect} = ceil({n_tiles}/{BATCH}))")
        rows = read_csv(os.path.join(out, "predict_run_*", "predictions_*.csv"))
        check(len(rows) == WHOLE_PAIRS and all(r["Num_Tiles"] == str(per_image) for r in rows),
              f"predict {variant}: {len(rows)} rows with Num_Tiles {per_image}")

        predict = make_predictor(load_pth(ckpt), ModelConfig(variant=variant), BATCH,
                                 image_size=SIZE, warmup=False)
        tile_alphas = predict_in_buckets(predict, [crops], BATCH).reshape(WHOLE_PAIRS, per_image)
        medians = np.median(tile_alphas, axis=1)
        alphas = np.array([float(r["Predicted_Alpha"]) for r in rows])
        err = float(np.abs(alphas - medians).max())
        check(err <= 1e-6, f"predict {variant}: Predicted_Alpha vs the median of the "
                           f"predictor's {per_image} tile alphas: max |diff| {err:.2e} (tol 1e-6)")
        run_dir = os.path.dirname(glob.glob(os.path.join(out, "predict_run_*", "predictions_*.csv"))[0])
        unmix_err = 0.0
        for i, r in enumerate(rows):
            got = read_tile(os.path.join(run_dir, "unmixed", f"{r['Image_Key']}_unmixed.tif"))
            want = np.clip(images[i, :, :, 0] - float(r["Predicted_Alpha"]) * images[i, :, :, 1],
                           0.0, None)
            unmix_err = max(unmix_err, float(np.abs(got - want).max()))
        check(len(os.listdir(os.path.join(run_dir, "unmixed"))) == WHOLE_PAIRS
              and unmix_err <= 1e-6,
              f"predict {variant}: {WHOLE_PAIRS} unmixed TIFFs = clip(mixed - alpha*source, 0): "
              f"max |diff| {unmix_err:.2e} (tol 1e-6)")
        print(f"predict {variant} --fast --unmix ({CARD}): {WHOLE_PAIRS} images of "
              f"{WHOLE_SIZE}x{WHOLE_SIZE}, {n_tiles} tiles, CLI wall {wall:.2f} s = "
              f"{n_tiles / wall:.1f} tiles/s (decode, grid, forward, CSV, unmixed TIFFs)",
              flush=True)


TRAIN_BATCH = 64       # the CLI runs: 179 train pairs -> 2 steps per epoch
STEP_BATCH = 256       # the CLI's default -b, for the step timings
TIMED_STEPS = 5


def conv_flops_per_tile(variant: str) -> int:
    """Forward FLOPs of one 256x256 tile (2 per multiply-add): the 3x3
    convs and the head's GEMMs; BN, activations and pools are not counted."""
    if variant == "single":
        widths = [2, 128, 256, 512, 512, 512, 512]
        branches = 1
    else:
        widths = [1, 64, 128, 256, 512]
        branches = 2
    flops, side = 0, SIZE
    for cin, cout in zip(widths, widths[1:]):
        flops += branches * 2 * 9 * cin * cout * side * side
        side //= 2
    flat = branches * widths[-1] * side * side
    return flops + 2 * (flat * 512 + 512 * 128 + 128)


def train_cli(argv, label: str) -> float:
    """``crosstalk_tpu_torch.cli.train.main`` -> its wall s."""
    from crosstalk_tpu_torch.cli.train import main as train_main

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = train_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"train CLI {label}: exit code {rc}")
    return wall


def read_log(run_dir: str):
    rows = list(csv.reader(open(glob.glob(os.path.join(run_dir, "training_log_*.csv"))[0])))
    return rows[5:]


def check_run_dir(variant: str, run_dir: str, epochs: int) -> dict:
    """The JAX package's artifact names, finite losses, one log row per
    epoch, and both .pth files loading into ``build_model``."""
    import re

    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.models.registry import build_model

    ts = re.compile(r"\d{4}-\d{2}-\d{2}_\d{2}-\d{2}-\d{2}")
    names = {ts.sub("TS", os.path.relpath(os.path.join(d, f), run_dir))
             for d, _, files in os.walk(run_dir) for f in files}
    tail = f"TS_{TRAIN_BATCH}_0.0001"
    want = {"params.txt", "model_architecture.txt", f"training_log_{tail}_onecycle.csv",
            "best_model_onecycle.pth", f"crosstalk_regression_model_trained_{tail}.pth",
            "checkpoints/train_ckpt.bin",
            *(f"{s}_predictions_{tail}.csv" for s in ("test", "train", "val"))}
    if epochs > 1:  # the generation a second checkpoint replaced
        want.add("checkpoints/train_ckpt.prev.bin")
    plots = {"lr_schedule_onecycle.png", f"training_validation_loss_{tail}.png",
             *(f"{s}_predictions_plot_{tail}.png" for s in ("test", "train", "val"))}
    extra = names - want - {"params_resume.txt"}
    check(want <= names and extra <= plots,
          f"train {variant}: the JAX package's artifact names ({len(want)} files; "
          f"{len(extra)} of {len(plots)} plots, which need matplotlib)")
    rows = read_log(run_dir)
    losses = np.array([[float(v) for v in r[1:3]] for r in rows])
    check(len(rows) == epochs and np.isfinite(losses).all(),
          f"train {variant}: {len(rows)} log rows (expected {epochs}), finite losses "
          f"{losses.tolist()}")
    for pattern in ("best_model_*.pth", "crosstalk_regression_model_trained_*.pth"):
        path = glob.glob(os.path.join(run_dir, pattern))[0]
        build_model(ModelConfig(variant=variant), image_size=SIZE).load_state_dict(load_pth(path))
    print(f"PASS: train {variant}: best and final .pth load into build_model", flush=True)
    return {"final": glob.glob(os.path.join(run_dir, "crosstalk_regression_model_trained_*.pth"))[0]}


def check_resume(run_dir: str, mixed_dir: str, source_dir: str, wall_before: float) -> None:
    """--resume of the single-branch run from 2 to 3 epochs."""
    from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
    from crosstalk_tpu_torch.io import checkpoint
    from crosstalk_tpu_torch.models.registry import build_model
    from crosstalk_tpu_torch.train.steps import init_train_state

    payload, meta = checkpoint.load_checkpoint(run_dir)
    rows_before = read_log(run_dir)
    # the state a resume restores (train/loop.py's path) equals the saved one
    state = init_train_state(build_model(ModelConfig(), image_size=SIZE, device="cuda"),
                             OptimConfig())
    checkpoint.restore_state(state, payload)
    same = all(torch.equal(v.cpu(), payload["model"][k])
               for k, v in state.model.state_dict().items())
    opt_sd = state.optimizer.state_dict()["state"]
    same = same and all(torch.equal(opt_sd[i][k].cpu(), payload["optimizer"]["state"][i][k])
                        for i in opt_sd for k in opt_sd[i])
    check(same and state.step == payload["step"] == meta["global_step"],
          f"resume: restored model, Adam moments and step ({state.step}) equal the saved ones")
    del state, payload
    torch.cuda.empty_cache()

    wall = train_cli(["-m", mixed_dir, "-s", source_dir, "-n", "3", "-j", "8",
                      "--resume", run_dir], "single --resume -n 3")
    _, new_meta = checkpoint.load_checkpoint(run_dir)
    rows = read_log(run_dir)
    steps_per_epoch = meta["global_step"] // meta["epoch"]
    check(rows[:2] == rows_before and len(rows) == 3 and new_meta["epoch"] == 3
          and new_meta["global_step"] == meta["global_step"] + steps_per_epoch
          and new_meta["lr_history"][:2] == meta["lr_history"]
          and new_meta["schedule"]["epoch"] == meta["schedule"]["epoch"] + 1,
          f"resume: started at epoch 3 from step {meta['global_step']}, log rows 1-2 kept, "
          f"3 rows, now step {new_meta['global_step']} ({wall:.2f} s, first run {wall_before:.2f} s)")


def step_timings(variant: str, resident) -> dict:
    """bf16 train steps at -b 256 on device-resident tiles: ms per step
    (CUDA events), tiles/s, peak memory, share of the bf16 peak, steps/s
    with and without a per-step .item(), the split of a step into data,
    forward, backward and optimizer, and one --grad_accum 4 step."""
    import torch.nn.functional as F

    from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
    from crosstalk_tpu_torch.data.transforms import prepare_train_batch
    from crosstalk_tpu_torch.models.registry import build_model, init_model
    from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step

    model = build_model(ModelConfig(variant=variant), image_size=SIZE)
    init_model(model, torch.Generator().manual_seed(SEED))
    state = init_train_state(model.cuda(), OptimConfig())
    step = make_train_step(state, compute_dtype="bf16", seed=SEED)
    epoch = iter(range(10 ** 6))

    def batch():
        return next(resident.batches(STEP_BATCH, shuffle=True, drop_last=True,
                                     seed=SEED, epoch=next(epoch)))

    for _ in range(2):  # warmup: cuDNN algorithm search, allocator
        b = batch()
        step(b.inputs, b.labels, 1e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batches = [batch() for _ in range(TIMED_STEPS)]
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for b in batches:
        loss = step(b.inputs, b.labels, 1e-4)
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1) / TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(loss)), f"step timing {variant}: finite loss {float(loss):.4f}")

    rates = {}
    for sync in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            loss = step(b.inputs, b.labels, 1e-4)
            if sync:
                loss.item()
        torch.cuda.synchronize()
        rates[sync] = TIMED_STEPS / (time.perf_counter() - t0)

    # the step's parts, one after another on the stream (CUDA events)
    model, opt = state.model, state.optimizer
    parts = dict.fromkeys(("data", "forward", "backward", "optimizer"), 0.0)
    for i in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        b = batch()
        x = prepare_train_batch(b.inputs, SEED, i, True).permute(0, 3, 1, 2)
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            preds = model.train()(x)
        loss = F.mse_loss(preds.float(), b.labels)
        ev[2].record()
        loss.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        ev[4].synchronize()
        for k, (a, c) in zip(parts, zip(ev, ev[1:])):
            parts[k] += a.elapsed_time(c) / 3

    accum_step = make_train_step(state, compute_dtype="bf16", seed=SEED, grad_accum=4)
    b = batch()
    accum_step(b.inputs, b.labels, 1e-4)  # warmup at the microbatch shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b = batch()
    e0.record()
    accum_step(b.inputs, b.labels, 1e-4)
    e1.record()
    e1.synchronize()
    accum_ms, accum_peak = e0.elapsed_time(e1), torch.cuda.max_memory_allocated()

    flops_step = 3 * conv_flops_per_tile(variant) * STEP_BATCH
    bound_ms = flops_step / BF16_FLOP_PER_S * 1e3
    out = {
        "ms_per_step": ms, "tiles_per_s": STEP_BATCH / ms * 1e3,
        "peak_gib": peak / 2 ** 30, "fwd_gflop_per_tile": conv_flops_per_tile(variant) / 1e9,
        "bf16_peak_share": bound_ms / ms,
        "steps_per_s_no_sync": rates[False], "steps_per_s_item_each_step": rates[True],
        "split_ms": parts, "grad_accum4_ms": accum_ms,
        "grad_accum4_peak_gib": accum_peak / 2 ** 30,
    }
    print(f"train step {variant} bf16 -b {STEP_BATCH} ({CARD}): {ms:.2f} ms/step = "
          f"{out['tiles_per_s']:.0f} tiles/s, peak {out['peak_gib']:.2f} GiB, "
          f"{out['fwd_gflop_per_tile']:.2f} GFLOP/tile forward (x3 per train step) -> "
          f"{bound_ms:.2f} ms at the bf16 peak = {out['bf16_peak_share']:.3f} of it; "
          f"steps/s {rates[False]:.3f} without and {rates[True]:.3f} with a per-step "
          f".item(); split ms: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
          + f"; --grad_accum 4 step {accum_ms:.2f} ms, peak {out['grad_accum4_peak_gib']:.2f} GiB",
          flush=True)
    check(accum_peak < peak, f"step timing {variant}: --grad_accum 4 peak "
          f"{accum_peak / 2 ** 30:.2f} GiB < {peak / 2 ** 30:.2f} GiB")
    del state, step, accum_step, model, opt
    torch.cuda.empty_cache()
    return out


def shadowed_biases(model) -> set:
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


def f32_model(device: str, dtype: torch.dtype):
    """The full-width single-branch model in f32 mode (dropout 0) with the
    same seeded weights on every device -> its TrainState."""
    from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
    from crosstalk_tpu_torch.models.registry import build_model, init_model
    from crosstalk_tpu_torch.train.steps import init_train_state

    model = build_model(ModelConfig(compute_dtype="f32", dropout_single=0.0), image_size=SIZE)
    init_model(model, torch.Generator().manual_seed(SEED + 6))
    return init_train_state(model.to(device, dtype), OptimConfig())


def f32_trajectory(device: str, dtype: torch.dtype, lr: float, steps: int = 3):
    """``steps`` f32-mode steps (TF32 off, flips off, dropout 0) of the
    full-width single-branch model at batch 4 -> (losses, eval predictions
    afterwards, the first step's gradient of each parameter as float64 on
    the host); the same seeded weights and tiles on every device."""
    from crosstalk_tpu_torch.train.steps import make_train_step

    state = f32_model(device, dtype)
    step = make_train_step(state, compute_dtype="f32", augment=False)
    rng = np.random.default_rng(SEED + 6)
    losses, grads = [], {}
    for i in range(steps):
        raw = torch.from_numpy((rng.random((4, SIZE, SIZE, 2)) * 1800 + 100).astype(np.float32))
        y = torch.from_numpy(rng.uniform(0, 0.5, (4, 1)).astype(np.float32))
        losses.append(float(step(raw.to(device, dtype), y.to(device, dtype), lr)))
        if i == 0:
            grads = {n: p.grad.double().cpu() for n, p in state.model.named_parameters()}
    x = torch.from_numpy(rng.random((4, 2, SIZE, SIZE)).astype(np.float32))
    with torch.no_grad():
        preds = state.model.eval()(x.to(device, dtype)).double().cpu()
    return np.array(losses), preds, grads


def worst_leaf(a: dict, b: dict, ref: dict, skip: set):
    """max over parameters of |a - b| / |ref| (L2 norms; NaN reads as inf)
    -> (value, name)."""
    return max((float(torch.nan_to_num((a[k] - b[k]).norm() / ref[k].norm(), nan=math.inf)), k)
               for k in ref if k not in skip)


def adam_step_card_vs_cpu(grads: dict, lr: float) -> dict:
    """One step of the train step's optimizer (Adam with coupled L2) on the
    card and on the CPU, from the same weights and the same gradients: the
    updates as a share of lr, and both moments, per parameter."""
    after = {}
    for device in ("cuda", "cpu"):
        state = f32_model(device, torch.float32)
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
             for i in moments for k in ("exp_avg", "exp_avg_sq")},
        )
        del state
    (upd_card, mom_card), (upd_cpu, mom_cpu) = after["cuda"], after["cpu"]
    upd = max((float((upd_card[k] - upd_cpu[k]).abs().max()), k) for k in upd_cpu)
    mom = worst_leaf(mom_card, mom_cpu, mom_cpu, set())
    check(upd[0] <= 1e-3 and mom[0] <= 1e-5,
          f"Adam+L2 step, card vs CPU on the same full-width weights and gradients, lr {lr:g} "
          f"({CARD}): update max |diff| / lr {upd[0]:.2e} ({upd[1]}; tol 1e-3), moments "
          f"worst leaf |diff| / |CPU| {mom[0]:.2e} ({mom[1]}; tol 1e-5)")
    return {"update_diff_over_lr": upd[0], "moment_rel": mom[0]}


def f32_step_card_vs_cpu() -> dict:
    """The f32 step on the card against the same steps on the CPU, with a
    float64 run on the card beside them.

    The first step's gradients are compared per parameter: deterministic,
    and ahead of Adam, whose first update is lr times the sign of the
    gradient and so amplifies rounding in the gradient's small elements.
    In float64 the card's backward must equal the CPU's; in f32 the card's
    gradients must be as close to float64 as the CPU's are (f32 itself is
    1-2e-3 from float64 in block 0 at this size, on either device). The
    optimizer is held apart, from identical gradients. Over three steps, at
    full width with batch 4, lr 1e-3 is chaotic: any f32 run leaves the
    float64 trajectory by more than the loss and prediction bounds
    (printed, not checked); those bounds are checked at lr 1e-5."""
    out = {}
    for lr in (1e-5, 1e-3):
        card, card_p, card_g = f32_trajectory("cuda", torch.float32, lr)
        cpu, cpu_p, cpu_g = f32_trajectory("cpu", torch.float32, lr)
        f64, f64_p, f64_g = f32_trajectory("cuda", torch.float64, lr)
        rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
        err = float((card_p - cpu_p).abs().max())
        rel64 = float(np.max(np.abs(card - f64) / np.abs(f64)))
        err64 = float((card_p - f64_p).abs().max())
        out[lr] = {"loss_rel_card_vs_cpu": rel, "pred_card_vs_cpu": err,
                   "loss_rel_card_vs_f64": rel64, "pred_card_vs_f64": err64}
        msg = (f"f32 train step lr {lr:g}, card vs CPU (full-width single-branch, batch 4, "
               f"3 steps, {CARD}): loss max rel diff {rel:.2e}, eval predictions max "
               f"|diff| {err:.2e}; card f32 vs card float64: {rel64:.2e}, {err64:.2e}")
        finite = bool(np.isfinite(card).all() and np.isfinite(cpu).all())
        if lr == 1e-5:
            check(finite and rel <= 2e-3 and err <= 1e-4, msg + " (tol 2e-3, 1e-4)")
            _, _, cpu64_g = f32_trajectory("cpu", torch.float64, lr, steps=1)
            skip = shadowed_biases(f32_model("cpu", torch.float32).model)
            g = {"f64_card_vs_cpu": worst_leaf(f64_g, cpu64_g, cpu64_g, skip),
                 "card_vs_cpu": worst_leaf(card_g, cpu_g, f64_g, skip),
                 "card_vs_f64": worst_leaf(card_g, f64_g, f64_g, skip),
                 "cpu_vs_f64": worst_leaf(cpu_g, f64_g, f64_g, skip)}
            out["grad_rel"] = {k: v[0] for k, v in g.items()}
            check(g["f64_card_vs_cpu"][0] <= 1e-9
                  and g["card_vs_f64"][0] <= 2 * g["cpu_vs_f64"][0]
                  and g["card_vs_cpu"][0] <= 5e-3,
                  f"first-step gradients per parameter, worst leaf |diff| / |float64| "
                  f"(full-width single-branch, batch 4, {len(f64_g) - len(skip)} parameters; "
                  f"{len(skip)} biases a BatchNorm follows left out; {CARD}): float64 card vs "
                  f"CPU {g['f64_card_vs_cpu'][0]:.2e} ({g['f64_card_vs_cpu'][1]}; tol 1e-9); "
                  f"f32 card vs float64 {g['card_vs_f64'][0]:.2e} ({g['card_vs_f64'][1]}; tol "
                  f"2x the CPU's), f32 CPU vs float64 {g['cpu_vs_f64'][0]:.2e} "
                  f"({g['cpu_vs_f64'][1]}); f32 card vs f32 CPU {g['card_vs_cpu'][0]:.2e} "
                  f"({g['card_vs_cpu'][1]}; tol 5e-3)")
            out["adam"] = adam_step_card_vs_cpu(cpu_g, 1e-3)
        else:
            check(finite, msg + " (finite; chaotic at this lr, not held to the bounds)")
    return out


def phase_train(root: str, mixed_dir: str, source_dir: str, by_path: dict) -> dict:
    """Phase 8: the train CLI on both models at full width, --resume, the
    trained checkpoints through the eval CLI's --fast, an f32 step against
    the CPU, and bf16 step timings at the CLI's default batch."""
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import DeviceDataset, TileStore
    from crosstalk_tpu_torch.io.torch_convert import load_pth, save_pth
    from crosstalk_tpu_torch.ops.input_block import fused_input_block

    t_phase = time.perf_counter()
    walls, finals = {}, {}
    for variant in ("single", "double"):
        out = os.path.join(root, f"train_{variant}")
        walls[variant] = train_cli(
            ["-m", mixed_dir, "-s", source_dir, "-b", str(TRAIN_BATCH), "-n", "2",
             "-r", "onecycle", "-o", variant, "-j", "8", "--output_base", out],
            f"{variant} -b {TRAIN_BATCH} -n 2 -r onecycle")
        (run_dir,) = glob.glob(os.path.join(out, "training_run_*"))
        finals[variant] = check_run_dir(variant, run_dir, 2)["final"]
        print(f"train CLI {variant} ({CARD}): {walls[variant]:.2f} s wall (decode, init, "
              f"2 epochs, checkpoints, 3-split evaluation)", flush=True)
        if variant == "single":
            check_resume(run_dir, mixed_dir, source_dir, walls[variant])
            check_run_dir(variant, run_dir, 3)

    expect = math.ceil(N_PAIRS / BATCH)
    for variant, final in finals.items():
        # the trained weights as they are, and with the scale of every other
        # block-0 BN channel negated: two epochs learn no negative scale, and
        # K1 folds the scale into the conv before its phase max, so a
        # negative one must turn that max into a min
        sd = load_pth(final)
        prefixes = (["conv_layers.1."] if variant == "single" else
                    ["bleed_branch.conv_blocks.1.", "source_branch.conv_blocks.1."])
        learned = sum(int((sd[p + "weight"] < 0).sum()) for p in prefixes)
        for p in prefixes:
            sd[p + "weight"][::2] *= -1
        negated = os.path.join(root, f"trained_{variant}_negated_bn.pth")
        save_pth(negated, sd)
        n_neg = sum(int((sd[p + "weight"] < 0).sum()) for p in prefixes)
        n_all = sum(sd[p + "weight"].numel() for p in prefixes)
        for path, ckpt, what in (
                (f"eval_trained_{variant}", final,
                 f"trained BN statistics, block-0 BN scales: {learned} negative of {n_all}"),
                (f"eval_trained_{variant}_negated_bn", negated,
                 f"trained BN statistics, block-0 BN scales: {n_neg} negative of {n_all}")):
            common = ["-m", mixed_dir, "-s", source_dir, "-p", ckpt, "-j", "8",
                      "--batch_size", str(BATCH), "--device", "cuda", "-o", variant]
            fused_input_block.launches = 0
            fast_rows, _ = run_cli(common + ["--output_base", os.path.join(root, f"{path}_fast"),
                                             "--fast"])
            launches = by_path[path] = fused_input_block.launches
            check(launches == expect, f"{path} --fast: K1 launched {launches} times "
                                      f"(expected {expect})")
            f32_rows, _ = run_cli(common + ["--output_base", os.path.join(root, f"{path}_f32")])
            fast_p = np.array([float(r["Predicted_Label"]) for r in fast_rows])
            f32_p = np.array([float(r["Predicted_Label"]) for r in f32_rows])
            mae = float(np.abs(fast_p - f32_p).mean())
            check(len(fast_rows) == len(f32_rows) == N_PAIRS and np.isfinite(fast_p).all()
                  and mae <= 2e-3,
                  f"{path}: --fast vs f32 MAE {mae:.3e} (tol 2e-3) on {what}")

    card_vs_cpu = f32_step_card_vs_cpu()

    store = TileStore(PairIndex(mixed_dir, source_dir).samples, jobs=8)
    resident = DeviceDataset(store, torch.device("cuda"))
    timings = {v: step_timings(v, resident) for v in ("single", "double")}
    del resident
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"phase 8 (training) wall: {wall:.1f} s ({CARD})", flush=True)
    return {"cli_wall_s": walls, "f32_card_vs_cpu": card_vs_cpu, "step": timings,
            "phase_wall_s": wall, "finals": finals}


INT8_ENVELOPE = 2e-2   # int8 tier vs f32 MAE (tests/test_int8_forward.py:160-180)
INT8_SPREAD_SHARE = 0.15  # ... and MAE below this share of the f32 spread (:151-154)
INT8_CARD_CPU_TOL = 1e-3  # the int8 forward, card vs CPU, one set of scales
INT8_HEAD_TOL = 1e-6   # the int8 head, card vs CPU from one feature tensor
INT8_BF16_HEAD_TOL = 5e-4  # its bf16 head, as the --fast path's card-vs-CPU bound
INT8_COMPARE_TILES = 16
ARTIFACT_TOL = 1e-6    # an artifact vs the live forward of its tier (DEPLOY.md)
ARTIFACT_K1_TOL = 2e-3  # an artifact vs the same tier with K1 on block 0
INT8_BATCHES = (64, 256)
SPREAD_MIN = 1e-2      # phase 9's trained weights spread their f32 predictions wider
SPREAD_LR = 1e-3
SPREAD_BATCH = 32
SPREAD_MAX_STEPS = 800
SPREAD_EVERY = 50


def make_spread_checkpoint(root: str, start: str, mixed_dir: str, source_dir: str) -> str:
    """Phase 9's trained single-branch checkpoint: ``start`` (phase 8's)
    trained on in bf16 at lr SPREAD_LR, batch SPREAD_BATCH, flips on, over
    the phase-4 pairs, until its f32 predictions on them spread over more
    than 2 x SPREAD_MIN (read every SPREAD_EVERY steps, at most
    SPREAD_MAX_STEPS). Phase 8's two epochs leave them within 1e-3, which
    is no wider than the int8 tier's error, so a trunk that tells no tile
    apart would pass phase 9's bounds on such weights."""
    from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import DeviceDataset, TileStore
    from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
    from crosstalk_tpu_torch.io.torch_convert import load_pth, save_pth
    from crosstalk_tpu_torch.models.registry import build_model
    from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step

    t0 = time.perf_counter()
    model = build_model(ModelConfig(), image_size=SIZE)
    model.load_state_dict(load_pth(start))
    state = init_train_state(model.cuda(), OptimConfig(learning_rate=SPREAD_LR))
    step = make_train_step(state, compute_dtype="bf16", seed=SEED)
    data = DeviceDataset(TileStore(PairIndex(mixed_dir, source_dir).samples, jobs=8),
                         torch.device("cuda"))

    def spread() -> float:
        with torch.no_grad():
            preds = torch.cat([model.eval()(normalize_batch_nhwc(data.tiles[i:i + BATCH])
                                            .permute(0, 3, 1, 2))
                               for i in range(0, len(data), BATCH)])
        return float(preds.max() - preds.min())

    history = [(0, spread())]
    epoch = 0
    while history[-1][1] <= 2 * SPREAD_MIN and state.step < SPREAD_MAX_STEPS:
        for b in data.batches(SPREAD_BATCH, shuffle=True, drop_last=True, seed=SEED + 7,
                              epoch=epoch):
            step(b.inputs, b.labels, SPREAD_LR)
            if state.step % SPREAD_EVERY == 0:
                history.append((state.step, spread()))
        epoch += 1
    path = os.path.join(root, "trained_spread_single.pth")
    save_pth(path, model.state_dict())
    print(f"trained weights for phase 9: phase 8's single-branch checkpoint + {state.step} bf16 "
          f"steps (lr {SPREAD_LR:g}, batch {SPREAD_BATCH}) in {time.perf_counter() - t0:.1f} s; "
          f"f32 prediction spread over {N_PAIRS} tiles by step: "
          + ", ".join(f"{n} {v:.3e}" for n, v in history) + f" ({CARD})", flush=True)
    check(history[-1][1] > SPREAD_MIN, f"trained weights spread {history[-1][1]:.3e} > "
                                       f"{SPREAD_MIN}")
    del state, step, data, model
    torch.cuda.empty_cache()
    return path


def load_raw(mixed_dir: str, source_dir: str, n: int) -> np.ndarray:
    """The raw f32 tiles of the first ``n`` pairs, in the predict CLI's order."""
    from crosstalk_tpu_torch.data.index import pair_unlabeled
    from crosstalk_tpu_torch.data.pipeline import load_tiles

    return load_tiles(pair_unlabeled(mixed_dir, source_dir).samples[:n], jobs=8)


def int8_block_card_vs_cpu(sd: dict, x_nhwc: torch.Tensor) -> dict:
    """One int8 conv block (single-branch block 1: 128 -> 256 channels at
    128x128) from one bf16 input with the same folded weights and clip:
    int32 accumulators and the bf16 output on the card against the CPU."""
    from crosstalk_tpu_torch.eval.fast_forward import _block_affine
    from crosstalk_tpu_torch.eval.int8_forward import (
        _conv3x3_int8,
        _mse_clip,
        _quant_act,
        conv_block_int8,
        prepare_conv_int8,
    )

    sx = float(_mse_clip(x_nhwc))
    kernel, scale, bias = _block_affine(sd, "conv_layers", 1, 1e-5)
    out = {}
    for dev in ("cuda", "cpu"):
        x = x_nhwc.to(dev)
        blk = prepare_conv_int8(kernel.to(dev), scale.to(dev), bias.to(dev), sx)
        out[dev] = (_conv3x3_int8(_quant_act(x, sx), blk.weight).cpu(),
                    conv_block_int8(x, blk, 0.01).cpu())
    acc_equal = torch.equal(out["cuda"][0], out["cpu"][0])
    out_equal = torch.equal(out["cuda"][1].view(torch.int16), out["cpu"][1].view(torch.int16))
    check(acc_equal and out_equal,
          f"int8 block 1 ({tuple(x_nhwc.shape)} bf16 -> {tuple(out['cpu'][1].shape)}), card vs "
          f"CPU from one input, weights and clip {sx:.6g}: int32 accumulators bitwise "
          f"{'equal' if acc_equal else 'DIFFERENT'}, bf16 output bitwise "
          f"{'equal' if out_equal else 'DIFFERENT'} ({CARD})")
    return {"block1_shape": list(x_nhwc.shape), "accumulators_equal": acc_equal,
            "output_equal": out_equal}


def int8_forward_card_vs_cpu(cfg, weights: dict, calib: torch.Tensor) -> dict:
    """The full-width single-branch int8 forward on the card against the
    CPU, for each of ``weights`` (name -> CPU state_dict) and each head,
    with one set of scales calibrated on the card over ``calib``, on its
    first INT8_COMPARE_TILES tiles, beside the spread (max - min) of the
    CPU's predictions. The whole forward differs by K1's rounding against
    its plain version, which moves a few int8 activations by a step. So
    each stage is also held on its own, from the CPU's input to it: the
    trunk (int8 blocks, concat, flatten) bitwise, the int8 head within
    INT8_HEAD_TOL (the final product sums f32 in another order), the bf16
    head within INT8_BF16_HEAD_TOL (its bf16 casts between the layers round
    some of those f32 differences apart)."""
    from crosstalk_tpu_torch.eval.fast_forward import make_first_block
    from crosstalk_tpu_torch.eval.int8_forward import (
        calibrate_int8,
        make_int8_forward,
        make_int8_head,
        make_int8_trunk,
    )

    x = calib[:INT8_COMPARE_TILES]
    x_cpu = x.cpu()
    out = {}
    for name, sd_cpu in weights.items():
        sd = {k: v.cuda() for k, v in sd_cpu.items()}
        scales = calibrate_int8(cfg, sd, calib)
        with torch.inference_mode():
            block0 = make_first_block(cfg, sd_cpu)(x_cpu)
            feats = make_int8_trunk(cfg, sd_cpu, scales)(block0)
            card_feats = make_int8_trunk(cfg, sd, scales)([h.cuda() for h in block0]).cpu()
        trunk_equal = torch.equal(card_feats.view(torch.int16), feats.view(torch.int16))
        check(trunk_equal,
              f"int8 trunk ({name} single-branch weights, blocks 1-5, concat, flatten -> "
              f"{tuple(feats.shape)} bf16), card vs CPU from one block-0 output: bitwise "
              f"{'equal' if trunk_equal else 'DIFFERENT'} ({CARD})")
        for head, int8_dense in (("bf16_head", False), ("int8_head", True)):
            if int8_dense:
                scales = calibrate_int8(cfg, sd, calib, int8_dense=True)
            with torch.inference_mode():
                cpu = make_int8_head(cfg, sd_cpu, scales)(feats)
                card_head = make_int8_head(cfg, sd, scales)(feats.cuda()).cpu()
                full = make_int8_forward(cfg, sd, scales)(x).cpu()
            spread = float(cpu.max() - cpu.min())
            err_full = float((full - cpu).abs().max())
            err_head = float((card_head - cpu).abs().max())
            head_tol = INT8_HEAD_TOL if int8_dense else INT8_BF16_HEAD_TOL
            # a trunk that tells no tile apart misses some tile by at least
            # half the spread: the trained weights' bounds are 1% of it
            # (their outputs, and the rounding of K1 and of the bf16 head's
            # casts with them, scale with the spread)
            full_tol = INT8_CARD_CPU_TOL
            if name == "trained":
                full_tol = 0.01 * spread
                head_tol = head_tol if int8_dense else 0.01 * spread
            check(bool(torch.isfinite(full).all()) and err_full <= full_tol,
                  f"int8 forward, {name} single-branch weights, {head}, {len(x)} tiles, card vs "
                  f"CPU: max |diff| {err_full:.3e} (tol {full_tol:.3e}); CPU predictions "
                  f"spread {spread:.3e}, a constant trunk's max |diff| >= {spread / 2:.3e} "
                  f"({CARD})")
            check(err_head <= head_tol,
                  f"int8 forward's {head}, {name} weights, card vs CPU from one feature tensor: "
                  f"max |diff| {err_head:.3e} (tol {head_tol}); spread {spread:.3e} ({CARD})")
            out[f"{name}_{head}"] = {"full": err_full, "head": err_head, "spread": spread}
        out[f"{name}_trunk_equal"] = trunk_equal
        del sd
    return out


def int8_split(cfg, sd: dict, scales: dict, x: torch.Tensor) -> dict:
    """Device time of one int8 forward (CUDA events) split into block 0
    (K1), quantize, int8 products and epilogue of blocks 1+, and the rest
    (concat and head); peak memory; the --fast forward beside it."""
    from crosstalk_tpu_torch.eval.fast_forward import (
        _block_affine,
        make_fast_forward,
        make_first_block,
    )
    from crosstalk_tpu_torch.eval.int8_forward import (
        _conv3x3_int8,
        _int8_epilogue,
        _quantize,
        make_int8_forward,
        prepare_conv_int8,
    )
    from crosstalk_tpu_torch.io.torch_convert import count_blocks, structure

    prefixes = [p for p, _ in structure(cfg.variant)[0]]
    names = ["bleed_", "source_"] if cfg.variant == "double" else ["conv_"]
    first = make_first_block(cfg, sd)
    trunks = [[prepare_conv_int8(*_block_affine(sd, p, i, cfg.bn_eps), scales[f"{n}{i}"])
               for i in range(1, count_blocks(sd, p))] for p, n in zip(prefixes, names)]
    forward = make_int8_forward(cfg, sd, scales)
    fast = make_fast_forward(cfg, sd)
    parts = dict.fromkeys(("k1", "quantize", "products", "epilogue"), 0.0)
    with torch.inference_mode():
        parts["k1"] = time_ms(lambda: first(x), iters=5)
        for h, blocks in zip(first(x), trunks):
            h = h.permute(0, 2, 3, 1)
            for blk in blocks:
                parts["quantize"] += time_ms(lambda: _quantize(h, blk.qs), iters=5)
                xq = _quantize(h, blk.qs)
                parts["products"] += time_ms(lambda: _conv3x3_int8(xq, blk.weight), iters=5)
                acc = _conv3x3_int8(xq, blk.weight)
                parts["epilogue"] += time_ms(
                    lambda: _int8_epilogue(acc, blk.eff_scale, blk.bias, cfg.leaky_slope), iters=5)
                h = _int8_epilogue(acc, blk.eff_scale, blk.bias, cfg.leaky_slope)
                del xq, acc
        total = time_ms(lambda: forward(x), iters=5)
        fast_ms = time_ms(lambda: fast(x), iters=5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        forward(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    parts["rest"] = total - sum(parts.values())
    b = x.shape[0]
    print(f"int8 forward {cfg.variant} batch {b} ({CARD}): {total:.3f} ms = "
          f"{b / total * 1e3:.0f} tiles/s (--fast {fast_ms:.3f} ms); split ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f"; peak max_memory_allocated {peak / 2 ** 30:.2f} GiB", flush=True)
    return {"ms": total, "fast_ms": fast_ms, "split_ms": parts, "peak_gib": peak / 2 ** 30}


def phase_int8(root: str, ckpts: dict, trained: str, mixed_dir: str, source_dir: str,
               by_path: dict) -> dict:
    """Phase 9a: the int8 tier on the card (calibration, block and forward
    against the CPU, accuracy, times) and through predict --int8 and the
    serve CLI with --quantize int8."""
    import queue
    import signal
    import threading
    import urllib.request

    from crosstalk_tpu_torch.cli.predict import main as predict_main
    from crosstalk_tpu_torch.cli.remote_eval import main as remote_eval_main
    from crosstalk_tpu_torch.cli.serve import build_parser, build_server
    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.data.index import pair_unlabeled
    from crosstalk_tpu_torch.eval.fast_forward import make_first_block
    from crosstalk_tpu_torch.eval.int8_forward import calibrate_int8, load_calibration_tiles
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.ops.input_block import fused_input_block
    from crosstalk_tpu_torch.serve.client import CrosstalkClient
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    out = {}
    cfg = ModelConfig()
    sd_cpu = load_pth(ckpts["single"])
    sd = {k: v.cuda() for k, v in sd_cpu.items()}
    t0 = time.perf_counter()
    calib = load_calibration_tiles(mixed_dir, source_dir, SIZE, max_tiles=256, jobs=8)
    load_s = time.perf_counter() - t0
    calib_t = torch.from_numpy(calib).cuda()
    fused_input_block.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scales = calibrate_int8(cfg, sd, calib_t)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    launches = by_path["calibrate_single"] = fused_input_block.launches
    check(launches == 1, f"calibrate_int8 over 256 tiles launched K1 {launches} time(s) "
                         "(expected 1: block 0 of the calibration batch)")
    print(f"int8 calibration, single-branch, 256 tiles ({CARD}): calibrate_int8 "
          f"{calib_s:.3f} s wall, tile loading {load_s:.3f} s; scales "
          + ", ".join(f"{k} {v:.5g}" for k, v in scales.items()), flush=True)
    out["calibration_s"] = calib_s
    out["calibration_load_s"] = load_s

    # one int8 block, and the whole forward, card against the CPU
    with torch.inference_mode():
        x1 = make_first_block(cfg, sd)(calib_t[:16])[0].permute(0, 2, 3, 1)
    out["block_card_vs_cpu"] = int8_block_card_vs_cpu(sd_cpu, x1)
    del x1
    out["forward_card_vs_cpu"] = int8_forward_card_vs_cpu(
        cfg, {"random": sd_cpu, "trained": load_pth(trained)}, calib_t)

    # accuracy against the f32 forward, random and trained weights. The
    # best constant predictor's MAE (mean |f32 - median|) is what a trunk
    # that tells no tile apart scores; on the trained weights, which spread
    # over more than SPREAD_MIN, the bound is at most half of it, so such a
    # trunk fails. Random weights spread too little for that: their bound is
    # the JAX tests' alone, and the trained weights carry the check.
    raw = torch.from_numpy(load_raw(mixed_dir, source_dir, N_PAIRS))
    out["mae_vs_f32"] = {}
    for name, ckpt in (("random", ckpts["single"]), ("trained", trained)):
        w = load_pth(ckpt)
        sc = calibrate_int8(cfg, {k: v.cuda() for k, v in w.items()}, calib_t)
        int8 = make_predictor(w, cfg, BATCH, image_size=SIZE, int8_scales=sc, warmup=False)
        f32 = make_predictor(w, ModelConfig(compute_dtype="f32"), BATCH, image_size=SIZE,
                             fast=False, warmup=False)
        fast = make_predictor(w, cfg, BATCH, image_size=SIZE, warmup=False)
        p8, p32, pf = (predict_in_buckets(p, [raw.numpy()], BATCH) for p in (int8, f32, fast))
        mae, mae_fast = float(np.abs(p8 - p32).mean()), float(np.abs(pf - p32).mean())
        spread = float(np.ptp(p32))
        constant = float(np.abs(p32 - np.median(p32)).mean())
        tol = min(INT8_ENVELOPE, INT8_SPREAD_SHARE * max(spread, 1e-3))
        rule = f"min({INT8_ENVELOPE}, {INT8_SPREAD_SHARE} x max(f32 spread, 1e-3)"
        if name == "trained":
            check(spread > SPREAD_MIN, f"trained weights: f32 predictions over {N_PAIRS} tiles "
                                       f"spread {spread:.3e} (need > {SPREAD_MIN})")
            tol = min(tol, 0.5 * constant)
            rule += ", 0.5 x the best constant's MAE"
        out["mae_vs_f32"][name] = {"int8": mae, "fast": mae_fast, "f32_spread": spread,
                                   "constant_mae": constant, "tol": tol}
        check(np.isfinite(p8).all() and mae <= tol,
              f"int8 tier vs f32 on {name} single-branch weights, {N_PAIRS} tiles: MAE "
              f"{mae:.3e} (tol {tol:.3e} = {rule})); f32 spread {spread:.3e}; a constant "
              f"trunk's best MAE {constant:.3e} ({'fails' if constant > tol else 'PASSES'} "
              f"the bound); --fast vs f32 {mae_fast:.3e} ({CARD})")
        del int8, f32, fast
        torch.cuda.empty_cache()

    # times: single-branch at 64 and 256, the two-branch library forward
    out["times"] = {}
    for variant in ("single", "double"):
        w = {k: v.cuda() for k, v in load_pth(ckpts[variant]).items()}
        vcfg = ModelConfig(variant=variant)
        sc = calibrate_int8(vcfg, w, calib_t[:64])
        for b in INT8_BATCHES:
            out["times"][f"{variant}_{b}"] = int8_split(vcfg, w, sc, calib_t[:b])
        del w
        torch.cuda.empty_cache()

    # predict --int8 over the whole 1024x1024 images
    whole_m, whole_s = os.path.join(root, "whole", "Mixed"), os.path.join(root, "whole", "Source")
    n_tiles = WHOLE_PAIRS * (WHOLE_SIZE // SIZE) ** 2
    fused_input_block.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = predict_main(["-m", whole_m, "-s", whole_s, "-p", ckpts["single"], "--int8",
                       "-b", str(BATCH), "--output_base", os.path.join(root, "whole_int8")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = by_path["predict_int8_single"] = fused_input_block.launches
    expect = 1 + math.ceil(n_tiles / BATCH)
    check(rc == 0 and launches == expect,
          f"predict --int8 exit code {rc}, K1 launched {launches} times (expected {expect} = "
          f"1 calibration + ceil({n_tiles}/{BATCH}))")
    rows = read_csv(os.path.join(root, "whole_int8", "predict_run_*", "predictions_*.csv"))
    alphas = np.array([float(r["Predicted_Alpha"]) for r in rows])
    check(len(rows) == WHOLE_PAIRS and np.isfinite(alphas).all(),
          f"predict --int8: {len(rows)} finite rows ({WHOLE_PAIRS} images of {WHOLE_SIZE}x"
          f"{WHOLE_SIZE}, CLI wall {wall:.2f} s = {n_tiles / wall:.1f} tiles/s, {CARD})")
    out["predict_int8_wall_s"] = wall

    # the serve CLI with --quantize int8: in process (K1 counted) ...
    serve_flags = ["-p", ckpts["single"], "--quantize", "int8", "--calibration_mixed_dir",
                   mixed_dir, "--calibration_source_dir", source_dir, "--batch_size",
                   str(BATCH), "--port", "0", "--max_delay_ms", "5"]

    def in_process(sc):
        """The in-process int8 predictor with the scales ``sc``, over the
        phase-4 tiles."""
        direct = make_predictor(sd_cpu, cfg, BATCH, image_size=SIZE, int8_scales=sc,
                                warmup=False)
        return predict_in_buckets(direct, [raw.numpy()], BATCH)

    def same_scales(a, b):
        return a.keys() == b.keys() and all(math.isclose(a[k], b[k], rel_tol=1e-5) for k in a)

    fused_input_block.launches = 0
    server, info = build_server(build_parser().parse_args(serve_flags))
    try:
        server.start_background()
        client = CrosstalkClient("http://%s:%d" % server.address, timeout=300)
        served = np.concatenate([client.predict(raw.numpy()[i:i + BATCH], dtype="float32")
                                 for i in range(0, N_PAIRS, BATCH)])
        batches = client.stats()["batches"]
        launches = by_path["serve_int8_single"] = fused_input_block.launches
    finally:
        server.shutdown()
    err = float(np.abs(served - in_process(info["int8_scales"])).max())
    check(same_scales(info["int8_scales"], scales) and launches == 2 + batches
          and err <= 1e-6,
          f"serve --quantize int8 in process: scales {'equal' if info['int8_scales'] == scales else 'within rtol 1e-5 of'} "
          f"the in-process calibration; K1 launched {launches} times = 1 calibration + 1 "
          f"warmup + {batches} batches; served vs the in-process int8 predictor max |diff| "
          f"{err:.2e} (tol 1e-6, f32 wire)")

    # ... and as a subprocess, driven by predict --url and remote_eval, with
    # a /reload of the trained checkpoint that must recalibrate
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "crosstalk_tpu_torch.cli.serve", *serve_flags, "--allow_reload"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=here)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    try:
        url, seen, deadline = None, [], time.monotonic() + 180
        while url is None and time.monotonic() < deadline:
            try:
                line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                break
            seen.append(line)
            if line.startswith("Serving on "):
                url = line.split()[2]
        check(url is not None, "serve --quantize int8 printed 'Serving on' within 180 s"
              + ("" if url else ":\n" + "".join(seen[-20:])))
        client = CrosstalkClient(url, timeout=300)
        before = client.health()
        served = np.concatenate([client.predict(raw.numpy()[i:i + BATCH], dtype="float32")
                                 for i in range(0, N_PAIRS, BATCH)])
        t0 = time.perf_counter()
        rc = predict_main(["-m", mixed_dir, "-s", source_dir, "--url", url, "--dtype", "float32",
                           "--output_base", os.path.join(root, "url_int8")])
        url_s = time.perf_counter() - t0
        check(rc == 0, f"predict --url against serve --quantize int8: exit code {rc}")
        rc = remote_eval_main(["-m", mixed_dir, "-s", source_dir, "--url", url, "--dtype",
                               "float32", "-o", os.path.join(root, "remote_int8")])
        check(rc == 0, f"remote_eval against serve --quantize int8: exit code {rc}")
        req = urllib.request.Request(url + "/reload", method="POST",
                                     data=json.dumps({"model_path": trained}).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            reloaded = json.load(r)
        after = client.health()
        proc.send_signal(signal.SIGTERM)
        try:
            code = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            code = None
        check(code == 0, f"serve --quantize int8 exits {code} within 60 s of SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    want = in_process(before["int8_scales"])
    err = float(np.abs(served - want).max())
    by_key = dict(zip((s.image_id for s in pair_unlabeled(mixed_dir, source_dir).samples), want))
    rows = read_csv(os.path.join(root, "url_int8", "predict_run_*", "predictions_*.csv"))
    err_csv = max(abs(float(r["Predicted_Alpha"]) - by_key[r["Image_Key"]]) for r in rows)
    evals = read_csv(os.path.join(root, "remote_int8", "eval_run_*", "test_predictions_*.csv"))
    check(before.get("path") == "int8-serving" and same_scales(before["int8_scales"], scales)
          and len(rows) == len(evals) == N_PAIRS and err <= 1e-6 and err_csv <= 1.5e-6,
          f"serve --quantize int8 subprocess: /healthz path {before.get('path')}, scales within "
          f"rtol 1e-5 of the in-process calibration; served (f32 wire) vs the in-process int8 "
          f"predictor with its scales: max |diff| {err:.2e} (tol 1e-6); predict --url CSV "
          f"{err_csv:.2e} (tol 1e-6 + its 6-decimal rounding), {N_PAIRS / url_s:.1f} tiles/s; "
          f"remote_eval {len(evals)} rows ({CARD})")
    trained_scales = calibrate_int8(cfg, {k: v.cuda() for k, v in load_pth(trained).items()},
                                    calib_t)
    check(reloaded.get("status") == "reloaded" and after.get("checkpoint") == trained
          and same_scales(after["int8_scales"], trained_scales)
          and after["int8_scales"] != before["int8_scales"],
          f"/reload of the trained checkpoint recalibrated: scales {before['int8_scales']} "
          f"-> {after['int8_scales']}")
    return out


def phase_export(root: str, ckpts: dict, mixed_dir: str, source_dir: str) -> dict:
    """Phase 9b: the export tool on the card (both models' bf16 artifacts,
    the single-branch int8 one), each loaded in a fresh process in which
    ``import crosstalk_tpu_torch`` fails, held against the live forwards,
    then served and predicted through --artifact."""
    from crosstalk_tpu_torch.cli.predict import main as predict_main
    from crosstalk_tpu_torch.cli.serve import build_parser, build_server
    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.io.export import load_exported, make_forward, read_exported
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.serve.client import CrosstalkClient
    from crosstalk_tpu_torch.tools.export_model import main as export_main

    here = os.path.dirname(os.path.abspath(__file__))
    arts = {
        "single_fast": (["-p", ckpts["single"]], "single"),
        "double_fast": (["-p", ckpts["double"], "-o", "double"], "double"),
        "single_int8": (["-p", ckpts["single"], "--quantize", "int8", "--calibration_mixed_dir",
                         mixed_dir, "--calibration_source_dir", source_dir], "single"),
    }
    out, metas = {}, {}
    for name, (flags, _) in arts.items():
        path = os.path.join(root, f"{name}.ctkt")
        t0 = time.perf_counter()
        rc = export_main(flags + ["--out", path])
        check(rc == 0, f"export_model {name}: exit code {rc} ({time.perf_counter() - t0:.2f} s)")
        out[name] = {"export_s": time.perf_counter() - t0, "mb": os.path.getsize(path) / 1e6}
        metas[name] = read_exported(path)[2]

    raw = load_raw(mixed_dir, source_dir, BATCH)
    np.save(os.path.join(root, "tiles.npy"), raw)
    loader = os.path.join(here, "crosstalk_tpu_torch", "io", "export.py")
    code = (
        "import sys, importlib.util\n"
        "import numpy as np\n"
        "sys.modules['crosstalk_tpu_torch'] = None\n"
        "try:\n"
        "    import crosstalk_tpu_torch\n"
        "    sys.exit('crosstalk_tpu_torch imported')\n"
        "except ImportError:\n"
        "    pass\n"
        f"spec = importlib.util.spec_from_file_location('artifact_loader', {loader!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"tiles = np.load({os.path.join(root, 'tiles.npy')!r})\n"
        f"for name in {list(arts)!r}:\n"
        f"    fn, meta = mod.load_exported({root!r} + '/' + name + '.ctkt')\n"
        f"    np.save({root!r} + '/' + name + '.out.npy', fn(tiles))\n"
        "print('loaded without the package:', sorted(m for m in sys.modules "
        "if m.startswith('crosstalk')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, "the artifacts load and run in a fresh process where "
          f"`import crosstalk_tpu_torch` fails:\n{proc.stdout[-1000:]}{proc.stderr[-3000:]}")
    x = torch.from_numpy(raw).cuda()
    for name, (_, variant) in arts.items():
        got = np.load(os.path.join(root, f"{name}.out.npy"))
        scales = metas[name].get("int8_scales")
        sd = load_pth(ckpts[variant])
        cfg = ModelConfig(variant=variant)
        with torch.inference_mode():
            live = make_forward(cfg, sd, device="cuda", use_kernel=False,
                                int8_scales=scales)(x).cpu().numpy()
            with_k1 = make_forward(cfg, sd, device="cuda", int8_scales=scales)(x).cpu().numpy()
        err, err_k1 = float(np.abs(got - live).max()), float(np.abs(got - with_k1).max())
        fn, _ = load_exported(os.path.join(root, f"{name}.ctkt"))
        ms = time_ms(lambda: fn.forward(x), iters=10)
        out[name].update({"vs_live": err, "vs_k1": err_k1, "ms_per_64": ms})
        check(got.shape == (BATCH,) and np.isfinite(got).all() and err <= ARTIFACT_TOL
              and err_k1 <= ARTIFACT_K1_TOL,
              f"artifact {name} ({out[name]['mb']:.1f} MB, path {metas[name]['path']}, block 0: "
              f"{metas[name]['block0']}): vs the live forward without K1 max |diff| {err:.2e} "
              f"(tol {ARTIFACT_TOL}), vs the same tier with K1 {err_k1:.2e} (tol "
              f"{ARTIFACT_K1_TOL}); {ms:.3f} ms per batch of {BATCH} ({CARD})")
        del fn

    # predict --artifact and serve --artifact once each
    rc = predict_main(["-m", mixed_dir, "-s", source_dir, "--artifact",
                       os.path.join(root, "single_int8.ctkt"), "-b", str(BATCH),
                       "--output_base", os.path.join(root, "predict_artifact")])
    rows = read_csv(os.path.join(root, "predict_artifact", "predict_run_*", "predictions_*.csv"))
    check(rc == 0 and len(rows) == N_PAIRS
          and np.isfinite([float(r["Predicted_Alpha"]) for r in rows]).all(),
          f"predict --artifact (int8): exit code {rc}, {len(rows)} finite rows")
    server, info = build_server(build_parser().parse_args(
        ["--artifact", os.path.join(root, "single_fast.ctkt"), "--batch_size", str(BATCH),
         "--port", "0"]))
    try:
        server.start_background()
        got = CrosstalkClient("http://%s:%d" % server.address, timeout=300).predict(
            raw, dtype="float32")
    finally:
        server.shutdown()
    want = np.load(os.path.join(root, "single_fast.out.npy"))
    err = float(np.abs(got - want).max())
    check(info["path"] == "fast" and err <= ARTIFACT_TOL,
          f"serve --artifact (bf16): served vs the artifact loaded without the package: "
          f"max |diff| {err:.2e} (tol {ARTIFACT_TOL})")
    return out


GLOO_LR = 1e-5         # the lr at which the f32 step card vs CPU holds (phase 8)
GLOO_BATCH = 8         # global batch of the two-rank step, 4 rows per rank
RANK_TIMEOUT = 300     # seconds, each rank subprocess
GLOO_F32_FACTOR = 2.0  # f32: two ranks' worst gradient leaf vs one rank's, from float64
GLOO_F64_TOL = 1e-9    # float64: every gradient leaf, two ranks vs one, x its max |g|


def run_rank_tool(command: str, out: str, flags: list) -> list:
    """Two ranks of ``crosstalk_tpu_torch.tools.multirank`` on cuda:0 over
    Gloo (NCCL refuses two ranks on one card) -> what each rank saved."""
    from crosstalk_tpu_torch.parallel.distributed import free_port

    here = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "crosstalk_tpu_torch.tools.multirank", command,
         "--rank", str(r), "--world", "2", "--port", str(port), "--out", out,
         "--device", "cuda:0", "--backend", "gloo", *flags],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for r, (p, o) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"multirank {command} rank {r} exit code {p.returncode}"
              + ("" if p.returncode == 0 else ":\n" + o[-3000:]))
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]


def nccl_step_bitwise_and_timing(variant: str, raw: torch.Tensor, labels: torch.Tensor) -> dict:
    """A one-rank NCCL group: the DDP step's first loss and gradients
    against the plain step's, bitwise (deterministic cuDNN), then ms per
    bf16 step at -b 256 with and without DDP, and the all-reduce of a
    buffer the size of the parameters."""
    import torch.distributed as dist

    from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
    from crosstalk_tpu_torch.models.registry import build_model, count_params, init_model
    from crosstalk_tpu_torch.parallel.distributed import free_port, initialize
    from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step

    group = initialize(f"localhost:{free_port()}", 1, 0, device_type="cuda", timeout_s=120)

    def state():
        model = build_model(ModelConfig(variant=variant), image_size=SIZE)
        init_model(model, torch.Generator().manual_seed(SEED))
        return init_train_state(model.cuda(), OptimConfig())

    out = {}
    cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        first = {}
        for name, pg in (("plain", None), ("ddp", group)):
            st = state()
            step = make_train_step(st, compute_dtype="bf16", seed=SEED, process_group=pg)
            loss = step(raw[:TRAIN_BATCH], labels[:TRAIN_BATCH], 1e-4)
            first[name] = (loss.cpu(), {n: p.grad.cpu() for n, p in st.model.named_parameters()})
            n_params = count_params(st.model)
            del st, step
            torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
        (l0, g0), (l1, g1) = first["plain"], first["ddp"]
        same = torch.equal(l0, l1) and all(torch.equal(g0[k], g1[k]) for k in g0)
        check(same, f"NCCL one-rank DDP step {variant} (bf16, batch {TRAIN_BATCH}, deterministic "
                    f"cuDNN): loss {float(l1):.6f} vs plain {float(l0):.6f}, {len(g0)} gradient "
                    f"leaves: {'bitwise equal' if same else 'DIFFERENT'} (tol: bitwise; {CARD})")
        out["bitwise"] = same

        for name, pg in (("plain", None), ("ddp", group)):
            st = state()
            step = make_train_step(st, compute_dtype="bf16", seed=SEED, process_group=pg)
            for _ in range(2):
                step(raw, labels, 1e-4)
            out[f"{name}_ms"] = time_ms(lambda: step(raw, labels, 1e-4), iters=TIMED_STEPS,
                                        warmup=0)
            del st, step
            torch.cuda.empty_cache()
        flat = torch.zeros(n_params, device="cuda")
        out["allreduce_ms"] = time_ms(lambda: dist.all_reduce(flat, group=group), iters=20)
        del flat
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
        dist.destroy_process_group()
    print(f"train step {variant} bf16 -b {raw.shape[0]} ({CARD}): plain {out['plain_ms']:.2f} "
          f"ms, DDP over one NCCL rank {out['ddp_ms']:.2f} ms; all-reduce of {n_params:,} f32 "
          f"({n_params * 4 / 1e6:.1f} MB) at world size 1: {out['allreduce_ms']:.4f} ms",
          flush=True)
    return out


def gloo_step_check(root: str, mixed_dir: str, source_dir: str) -> dict:
    """Two Gloo ranks on cuda:0 against one rank: one full-width
    single-branch step at global batch GLOO_BATCH, flips on, dropout 0, in
    f32 (the loss, BN statistics, parameters, and the worst gradient leaf's
    distance from float64) and in float64 (every gradient leaf)."""
    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.tools.multirank import run_steps

    tiles = load_raw(mixed_dir, source_dir, GLOO_BATCH)
    alphas = np.array([[s.scalar_label] for s in PairIndex(mixed_dir, source_dir)
                       .samples[:GLOO_BATCH]], np.float32)
    two = {}
    for name, dtype in (("f32", np.float32), ("f64", np.float64)):
        data = os.path.join(root, f"gloo_batch_{name}.npz")
        np.savez(data, inputs=tiles.astype(dtype), labels=alphas.astype(dtype))
        two[name] = run_rank_tool("step", os.path.join(root, f"gloo_step_{name}"), [
            "--data", data, "--dropout", "0", "--lr", str(GLOO_LR), "--augment",
            "--seed", str(SEED)])
    cfg32 = ModelConfig(compute_dtype="f32", dropout_single=0.0)
    x_card, y_card = torch.from_numpy(tiles).cuda(), torch.from_numpy(alphas).cuda()
    half = GLOO_BATCH // 2

    def step(rows, dtype):
        return run_steps(cfg32, SIZE, x_card[rows].to(dtype), y_card[rows].to(dtype), GLOO_LR,
                         seed=SEED, augment=True, dtype=dtype)

    # one rank on the whole batch, and on rank 0's rows (flips of offset 0):
    # the latter runs the convolutions at a rank's shapes, and it is what a
    # rank that skips every all-reduce computes
    one, f64 = step(slice(None), torch.float32), step(slice(None), torch.float64)
    rows, rows64 = step(slice(0, half), torch.float32), step(slice(0, half), torch.float64)
    skip = {k for k in one["grads"] if k.endswith(".bias") and
            f"{k.rsplit('.', 2)[0]}.{int(k.split('.')[-2]) + 1}.running_mean" in one["state"]}
    two32 = two["f32"][0]
    loss_rel = abs(two32["losses"][0] - one["losses"][0]) / abs(one["losses"][0])

    # f32: below some layer every leaf sits ~3e-3 of its norm from float64
    # (a max-pool window's two largest values, or a LeakyReLU input near 0,
    # rounding the other way routes the gradient elsewhere), and that layer
    # differs between one rank at 8 rows, one rank at 4 and two ranks, while
    # float64 two ranks equal one. So the f32 gradients are held as a whole:
    # the two ranks' worst leaf (relative L2 from float64) within
    # GLOO_F32_FACTOR x the worst of one rank's at 8 or at 4 rows
    def rel(grads, ref, k):
        return float(torch.nan_to_num((grads[k].double() - ref[k]).norm() / ref[k].norm(),
                                      nan=math.inf))

    keys = [k for k in f64["grads"] if k not in skip]
    grad2 = max((rel(two32["grads"], f64["grads"], k), k) for k in keys)
    grad1 = max(max((rel(one["grads"], f64["grads"], k), k) for k in keys),
                max((rel(rows["grads"], rows64["grads"], k), k) for k in keys))
    # float64 rounds far below any pool window's gap: every leaf of the two
    # ranks is held to the one rank's, and the rank without the all-reduce
    # must miss that bound in every leaf
    def over(grads, k):
        g = f64["grads"][k]
        return float((grads[k] - g).abs().max()) / (GLOO_F64_TOL * float(g.abs().max()) + 1e-15)

    leaf64 = max((over(two["f64"][0]["grads"], k), k) for k in keys)
    fault64 = min((over(rows64["grads"], k), k) for k in keys)
    stats = max((float((two32["state"][k].double() - v.double()).abs().max())
                 / max(float(v.abs().max()), 1e-30), k)
                for k, v in one["state"].items() if "running" in k)
    # a sanity check that cannot fail after one Adam step, which moves a
    # parameter by at most lr: two runs differ by at most 2 x lr, plus the
    # float32 rounding of p - lr * u, 2 ulps of the leaf's largest value
    params = max((float((two32["state"][k].double() - v.double()).abs().max())
                  / (2 * GLOO_LR + 2.0 ** -22 * float(v.abs().max())), k)
                 for k, v in one["state"].items() if k.endswith(("weight", "bias")))
    out = {"loss_rel": loss_rel, "grad_rel_f64_two_ranks": grad2[0],
           "grad_rel_f64_one_rank": grad1[0], "f64_leaf_over_bound": leaf64[0],
           "f64_no_allreduce_least_over_bound": fault64[0], "stats_rel": stats[0],
           "param_diff_over_bound": params[0],
           # per leaf, relative L2 from float64: one rank at 8 rows, at 4, two ranks
           "f32_leaves": {k: [rel(one["grads"], f64["grads"], k),
                              rel(rows["grads"], rows64["grads"], k),
                              rel(two32["grads"], f64["grads"], k)] for k in keys}}
    check(all(t[0]["losses"] == t[1]["losses"] for t in two.values()) and loss_rel <= 1e-5
          and grad2[0] <= GLOO_F32_FACTOR * grad1[0] and leaf64[0] <= 1.0 and fault64[0] > 1.0
          and stats[0] <= 1e-5 and params[0] <= 1.0,
          f"two Gloo ranks on cuda:0 vs one rank, full-width single-branch step, global batch "
          f"{GLOO_BATCH}, flips on, dropout 0, lr {GLOO_LR:g} ({CARD}): f32 loss "
          f"{two32['losses'][0]:.7f} vs {one['losses'][0]:.7f}, rel diff {loss_rel:.2e} (tol "
          f"1e-5); f32 gradients, worst of {len(keys)} leaves |diff| / |float64| (L2; "
          f"{len(skip)} biases a BatchNorm follows left out): two ranks {grad2[0]:.2e} "
          f"({grad2[1]}), one rank at {GLOO_BATCH} or {half} rows {grad1[0]:.2e} ({grad1[1]}; "
          f"tol {GLOO_F32_FACTOR:g}x); float64 gradients, every leaf max |two ranks - one| / "
          f"({GLOO_F64_TOL:g} max|g| + 1e-15): worst {leaf64[0]:.3g} ({leaf64[1]}; tol 1), a "
          f"rank without the all-reduce reads at least {fault64[0]:.3g} ({fault64[1]}; must "
          f"exceed 1); f32 BN statistics worst |diff| / max|stat| {stats[0]:.2e} ({stats[1]}; "
          f"tol 1e-5); f32 parameters, worst leaf max |diff| / (2 x lr + 2 ulps of its largest "
          f"value) {params[0]:.4f} ({params[1]}; tol 1, a sanity check one Adam step cannot "
          f"fail)")
    return out


def phase_parallel(root: str, ckpts: dict, mixed_dir: str, source_dir: str,
                   by_path: dict) -> dict:
    """Phase 10: data parallel on the one card. The train CLI as a one-rank
    NCCL cluster (artifacts; DDP step bitwise the plain one; step times);
    two Gloo ranks on cuda:0 against one (train step, rank-sharded eval);
    the replica set [cuda:0, cuda:0] (predictor and eval engine); the
    eval, predict and serve CLIs refusing more devices than the host has."""
    import contextlib
    import io

    from crosstalk_tpu_torch.cli.evaluate import main as eval_main
    from crosstalk_tpu_torch.cli.predict import main as predict_main
    from crosstalk_tpu_torch.cli.serve import main as serve_main
    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import TileStore
    from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward
    from crosstalk_tpu_torch.io.torch_convert import load_pth
    from crosstalk_tpu_torch.ops.input_block import fused_input_block
    from crosstalk_tpu_torch.parallel.distributed import free_port
    from crosstalk_tpu_torch.parallel.mesh import replicated_forward
    from crosstalk_tpu_torch.serve.predictor import make_predictor
    from crosstalk_tpu_torch.tools.multirank import run_eval

    t_phase = time.perf_counter()
    out = {}
    # 10.1: the train CLI as one rank of a one-process NCCL cluster
    for variant in ("single", "double"):
        base = os.path.join(root, f"train_nccl_{variant}")
        wall = train_cli(["-m", mixed_dir, "-s", source_dir, "-b", str(TRAIN_BATCH), "-n", "1",
                          "-r", "onecycle", "-o", variant, "-j", "8", "--output_base", base,
                          "--multihost", "--coordinator_address", f"localhost:{free_port()}",
                          "--num_processes", "1", "--process_id", "0"],
                         f"{variant} --multihost --num_processes 1")
        (run_dir,) = glob.glob(os.path.join(base, "training_run_*"))
        check_run_dir(variant, run_dir, 1)
        out[f"train_cli_nccl_{variant}_s"] = wall
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    raw = torch.rand(STEP_BATCH, SIZE, SIZE, 2, device="cuda", generator=gen) * 1800 + 100
    labels = torch.rand(STEP_BATCH, 1, device="cuda", generator=gen) * 0.5
    for variant in ("single", "double"):
        out[f"step_{variant}"] = nccl_step_bitwise_and_timing(variant, raw, labels)
    del raw, labels
    torch.cuda.empty_cache()

    # 10.2: two Gloo ranks on cuda:0, one f32 step at global batch 8
    out["gloo_step"] = gloo_step_check(root, mixed_dir, source_dir)

    # 10.3: the rank-sharded eval engine, two Gloo ranks on cuda:0, --fast
    cache = os.path.join(root, "tile_cache")
    TileStore(PairIndex(mixed_dir, source_dir).samples, jobs=8, cache_dir=cache)
    ranks = run_rank_tool("eval", os.path.join(root, "gloo_eval"), [
        "--variants", "single", "double", "--checkpoint", ckpts["single"], ckpts["double"],
        "-m", mixed_dir, "-s", source_dir, "--fast", "--compute_dtype", "bf16",
        "--batch_size", str(BATCH), "--cache_dir", cache])
    per_rank = math.ceil(N_PAIRS / BATCH)
    single_rows = {}
    for variant in ("single", "double"):
        sd = {k: v.cuda() for k, v in load_pth(ckpts[variant]).items()}
        fwd = make_fast_forward(ModelConfig(variant=variant), sd)
        # one rank at the per-rank batch (the same shapes on the card) and
        # at the whole batch
        one, one_loss = run_eval(fwd, mixed_dir, source_dir, torch.device("cuda"), BATCH // 2,
                                 cache_dir=cache)
        whole, _ = run_eval(fwd, mixed_dir, source_dir, torch.device("cuda"), BATCH,
                            cache_dir=cache)
        single_rows[variant] = one
        got = ranks[0][variant]["rows"]
        launches = by_path[f"eval_ranks_{variant}"] = sum(r[variant]["launches"] for r in ranks)
        same_ids = got["Image_ID"].tolist() == one["Image_ID"].tolist()
        pred = float(np.abs(got["Predicted_Label"] - one["Predicted_Label"]).max())
        pred_whole = float(np.abs(got["Predicted_Label"] - whole["Predicted_Label"]).max())
        metrics = max(float(np.abs(got[k] - one[k]).max()) for k in list(one)[3:])
        out[f"eval_ranks_{variant}"] = {"pred": pred, "metrics": metrics, "launches": launches,
                                        "pred_vs_whole_batch": pred_whole}
        check(same_ids and len(got["Image_ID"]) == N_PAIRS and pred <= 1e-6 and metrics <= 1e-5
              and abs(ranks[0][variant]["loss"] - one_loss) <= 1e-6 * one_loss
              and launches == 2 * per_rank and ranks[0][variant]["rows"].keys() == one.keys(),
              f"rank-sharded eval {variant} --fast, two Gloo ranks on cuda:0, {N_PAIRS} tiles "
              f"at batch {BATCH} ({CARD}): gathered rows vs one rank at the per-rank batch "
              f"{BATCH // 2}: Predicted_Label max |diff| {pred:.2e} (tol 1e-6), metrics "
              f"{metrics:.2e} (tol 1e-5), loss rel diff "
              f"{abs(ranks[0][variant]['loss'] - one_loss) / one_loss:.2e} (tol 1e-6); vs one "
              f"rank at batch {BATCH}: {pred_whole:.2e} (not held: other shapes, other cuDNN "
              f"sums); K1 launched {launches} times (expected 2 ranks x {per_rank})")
    gather_ms = ranks[0]["gather_s"] * 1e3
    out["gather_ms_per_eval_batch"] = gather_ms
    print(f"rank-sharded eval: all-gather of one batch's rows ({BATCH // 2} per rank, Gloo, "
          f"host clock): {gather_ms:.3f} ms ({CARD})", flush=True)

    # 10.4: the replica set [cuda:0, cuda:0]
    sd_cpu = load_pth(ckpts["single"])
    cfg = ModelConfig()
    raw_tiles = load_raw(mixed_dir, source_dir, N_PAIRS)
    fused_input_block.launches = 0
    two_replicas = make_predictor(sd_cpu, cfg, [8, BATCH], image_size=SIZE,
                                  devices=["cuda:0", "cuda:0"])
    served = predict_in_buckets(two_replicas, [raw_tiles], BATCH)
    launches = by_path["serve_replicas_single"] = fused_input_block.launches
    half = make_predictor(sd_cpu, cfg, [4, BATCH // 2], image_size=SIZE, warmup=False)
    whole = make_predictor(sd_cpu, cfg, BATCH, image_size=SIZE, warmup=False)
    want = predict_in_buckets(half, [raw_tiles], BATCH // 2)
    err = float(np.abs(served - want).max())
    err_whole = float(np.abs(served - predict_in_buckets(whole, [raw_tiles], BATCH)).max())
    expect = 2 * 2 + 2 * per_rank  # warmup: 2 buckets x 2 replicas; 4 batches x 2
    check(err <= 1e-6 and err_whole <= 5e-4 and launches == expect,
          f"replica predictor [cuda:0, cuda:0], buckets [8, {BATCH}], {N_PAIRS} tiles ({CARD}): "
          f"vs one replica at the per-replica buckets max |diff| {err:.2e} (tol 1e-6), vs one "
          f"replica at batch {BATCH} {err_whole:.2e} (tol 5e-4, the --fast card envelope); K1 "
          f"launched {launches} times (expected {expect}: 2 buckets x 2 replicas warmup + "
          f"{per_rank} batches x 2 replicas)")
    sd = {k: v.cuda() for k, v in sd_cpu.items()}

    def replica(d):
        return make_fast_forward(cfg, {k: v.to(d) for k, v in sd.items()})

    fused_input_block.launches = 0
    store = TileStore(PairIndex(mixed_dir, source_dir).samples, cache_dir=cache)
    from crosstalk_tpu_torch.eval.engine import evaluate

    rows, _ = evaluate(replicated_forward(replica, ["cuda:0", "cuda:0"]), store,
                       torch.device("cuda:0"), BATCH, replicas=2)
    launches = by_path["eval_replicas_single"] = fused_input_block.launches
    pred = float(np.abs(np.array([r["Predicted_Label"] for r in rows])
                        - single_rows["single"]["Predicted_Label"]).max())
    check(len(rows) == N_PAIRS and pred <= 1e-6 and launches == 2 * per_rank,
          f"eval engine over the replica set [cuda:0, cuda:0], {N_PAIRS} tiles at batch {BATCH}: "
          f"Predicted_Label vs one device at batch {BATCH // 2} max |diff| {pred:.2e} (tol 1e-6); "
          f"K1 launched {launches} times (expected 2 replicas x {per_rank})")
    out["replicas"] = {"serve_vs_one": err, "serve_vs_whole_batch": err_whole,
                       "eval_vs_one": pred}

    # the eval, predict and serve CLIs refuse more devices than the host has
    tiny = os.path.join(root, "tiny")
    from crosstalk_tpu_torch.data.tiff import write_tile
    for sub in ("Mixed", "Source"):
        os.makedirs(os.path.join(tiny, sub))
        write_tile(os.path.join(tiny, sub, "a_mixed.tif" if sub == "Mixed" else "a_source.tif"),
                   np.random.default_rng(SEED).random((SIZE, SIZE)))
    n = torch.cuda.device_count() + 1
    want_msg = (f"Error: --num_devices {n} requested but only {n - 1} device(s) are visible.")
    for name, main_fn, argv in (
            ("evaluate", eval_main, ["-m", mixed_dir, "-s", source_dir, "-p", ckpts["single"],
                                     "--output_base", os.path.join(root, "refused")]),
            ("predict", predict_main, ["-m", os.path.join(tiny, "Mixed"), "-s",
                                       os.path.join(tiny, "Source"), "-p", ckpts["single"],
                                       "--output_base", os.path.join(root, "refused")]),
            ("serve", serve_main, ["-p", ckpts["single"], "--port", "0"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main_fn([*argv, "--num_devices", str(n)])
        check(rc == 1 and want_msg in buf.getvalue(),
              f"{name} CLI --num_devices {n} on a host with {n - 1} card(s): exit code {rc}, "
              f"says {want_msg!r}")
    check(not os.path.exists(os.path.join(root, "refused")), "the refused CLIs wrote nothing")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"phase 10 (data parallel) wall: {out['phase_wall_s']:.1f} s ({CARD})", flush=True)
    return out


SCALE_PAIRS = 1024     # phase 11's scale_bench dataset (256x256 tiles)
SCALE_BATCH = 128
SERVE_BENCH_S = 10     # seconds of the serve_bench window
DECODE_THREADS = 8


def run_tool(main_fn, argv: list, label: str) -> tuple:
    """Call a tool's ``main`` in process, echo what it printed; -> (its
    output lines, its last line as JSON or None)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    check(rc == 0, f"{label}: exit code {rc}")
    lines = out.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = None
    return lines, last


def decode_rates(mixed_dir: str, source_dir: str) -> dict:
    """11a: the 256 phase-4 pairs decoded natively and by the Python decoder
    with DECODE_THREADS threads, bitwise equal; pairs/s, best of 3."""
    from crosstalk_tpu_torch.data import native_loader
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import load_tiles

    status = native_loader.build_status()
    check(status["error"] is None, f"native decoder built with g++: {status['error']}")
    print(f"native decoder: {'built' if status['built'] else 'loaded'} "
          f"{os.path.basename(status['path'])} in {status['seconds']:.2f} s (first use, "
          f"phase 4; {os.cpu_count()} CPUs)", flush=True)
    samples = PairIndex(mixed_dir, source_dir).samples
    out = {"build_s": status["seconds"], "built": status["built"],
           "cpu_count": os.cpu_count(), "threads": DECODE_THREADS}
    arrays = {}
    for name, native in (("native", True), ("python", False)):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            arrays[name] = load_tiles(samples, jobs=DECODE_THREADS, use_native=native)
            best = min(best, time.perf_counter() - t0)
        out[f"{name}_pairs_per_s"] = len(samples) / best
    check(np.array_equal(arrays["native"], arrays["python"]),
          f"native and Python decoders bitwise equal on the {len(samples)} phase-4 pairs")
    print(f"decode ({CARD}; host clock, {os.cpu_count()} CPUs, {DECODE_THREADS} threads, "
          f"best of 3): native {out['native_pairs_per_s']:.1f} pairs/s, Python "
          f"{out['python_pairs_per_s']:.1f} pairs/s "
          f"({out['native_pairs_per_s'] / out['python_pairs_per_s']:.2f}x)", flush=True)
    return out


def check_analysis(base: str) -> dict:
    """11f: ``cli/analyse.py`` over one base of training_run_* dirs: one
    row per run dir, its min train/val losses the cells of the run's log
    at the minima, read as pandas reads them (``_pandas_float``: the JAX
    analyser's values, a few ulps from Python's ``float`` on some cells)."""
    from crosstalk_tpu_torch.cli.analyse import _pandas_float
    from crosstalk_tpu_torch.cli.analyse import main as analyse_main

    out_csv = os.path.join(base, "training_analysis_results.csv")
    run_tool(analyse_main, ["-d", base, "-o", out_csv], f"analyse {os.path.basename(base)}")
    with open(out_csv) as f:
        rows = {r["directory"]: r for r in csv.DictReader(f)}
    dirs = sorted(glob.glob(os.path.join(base, "training_run_*")))
    check(sorted(rows) == [os.path.basename(d) for d in dirs],
          f"analyse {os.path.basename(base)}: {len(rows)} rows for {len(dirs)} run dirs")
    for d in dirs:
        log = read_log(d)
        row = rows[os.path.basename(d)]
        got = (float(row["min_train_loss"]), float(row["min_val_loss"]))
        cells = [min((r[c] for r in log), key=float) for c in (1, 2)]
        want = tuple(_pandas_float(c) for c in cells)
        ulps = [abs(g - float(c)) / math.ulp(float(c)) for g, c in zip(got, cells)]
        check(got == want, f"analyse {os.path.basename(d)}: min train/val loss {got} = "
                           f"the log's cells {cells} as pandas reads them ({ulps[0]:.0f} "
                           f"and {ulps[1]:.0f} ulps from Python's float)")
    return {"rows": len(rows)}


def phase_host_tools(root: str, ckpts: dict, trained: str, mixed_dir: str,
                     source_dir: str, by_path: dict) -> dict:
    """Phase 11: the native decoder, scale_bench, the dispatcher, doctor,
    serve_bench, analyse, unmix_demo, sweep and distill, in process."""
    from crosstalk_tpu_torch.__main__ import main as dispatch
    from crosstalk_tpu_torch.data.pipeline import load_tiles
    from crosstalk_tpu_torch.ops.input_block import fused_input_block
    from crosstalk_tpu_torch.tools import (
        distill,
        scale_bench,
        serve_bench,
        sweep,
        unmix_demo,
    )

    t_phase = time.perf_counter()
    out = {"decode": decode_rates(mixed_dir, source_dir)}
    deliberate_python = 3 * N_PAIRS  # 11a's Python-decoder runs

    # 11b: the cold packed-cache build and one epoch of the train path at
    # full width, then the host feed alone over the same (now warm) cache
    data = os.path.join(root, "scale")
    flags = ["-n", str(SCALE_PAIRS), "-b", str(SCALE_BATCH), "--epochs", "1",
             "--size", str(SIZE), "--data_dir", data]
    _, cold = run_tool(scale_bench.main, flags, "scale_bench")
    _, feed = run_tool(scale_bench.main, flags + ["--feed_only"], "scale_bench --feed_only")
    check(cold["cache_build"]["cold"] and cold["cache_build"]["decoded"]["python"] == 0
          and all(math.isfinite(e["loss"]) for e in cold["epochs"]),
          f"scale_bench: cold cache of {SCALE_PAIRS} pairs decoded natively, finite loss")
    out["scale_bench"] = {
        "cold_cache_pairs_per_s": cold["cache_build"]["pairs_per_s"],
        "epoch_tiles_per_s": cold["epochs"][0]["tiles_per_s"],
        "h2d_mb_per_s": cold["h2d_mb_per_s"],
        "feed_tiles_per_s": feed["feed_epochs"][0]["tiles_per_s"],
    }
    print(f"scale_bench ({CARD}; {os.cpu_count()} CPUs, {DECODE_THREADS} decode threads): cold "
          f"cache {out['scale_bench']['cold_cache_pairs_per_s']:.1f} pairs/s, epoch "
          f"{out['scale_bench']['epoch_tiles_per_s']:.1f} tiles/s (-b {SCALE_BATCH}, bf16, "
          f"single-branch full width), feed {out['scale_bench']['feed_tiles_per_s']:.1f} "
          f"tiles/s", flush=True)
    shutil.rmtree(data)

    # 11c: the dispatcher's evaluate --fast against phase 4's --fast CSV
    base = os.path.join(root, "dispatch")
    fused_input_block.launches = 0
    rc = dispatch(["evaluate", "-m", mixed_dir, "-s", source_dir, "-p", ckpts["single"],
                   "-j", "8", "--batch_size", str(BATCH), "--device", "cuda", "-o", "single",
                   "--output_base", base, "--fast"])
    torch.cuda.synchronize()
    launches = by_path["dispatcher_eval_single"] = fused_input_block.launches
    check(rc == 0 and launches == math.ceil(N_PAIRS / BATCH),
          f"python -m crosstalk_tpu_torch evaluate --fast: exit code {rc}, K1 launched "
          f"{launches} times")
    got = read_csv(os.path.join(base, "eval_run_*", "test_predictions_*.csv"))
    want = read_csv(os.path.join(root, "single_fast", "eval_run_*", "test_predictions_*.csv"))
    check(got == want, f"dispatcher evaluate --fast: its {len(got)} CSV rows equal phase 4's")
    helped = subprocess.run([sys.executable, "-m", "crosstalk_tpu_torch", "--help"],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            capture_output=True, text=True, timeout=120)
    check(helped.returncode == 0 and "usage: python -m crosstalk_tpu_torch" in helped.stdout,
          f"python -m crosstalk_tpu_torch --help: exit code {helped.returncode}")

    # 11d: doctor with the single-branch checkpoint at the main path's size
    fused_input_block.launches = 0
    lines, _ = run_tool(dispatch, ["doctor", "-p", ckpts["single"], "--image_size", str(SIZE)],
                        "doctor")
    by_path["doctor_single"] = fused_input_block.launches
    decoder = [ln for ln in lines if "native TIFF decoder" in ln]
    check(len(decoder) == 1 and decoder[0].split()[0] == "ok"
          and by_path["doctor_single"] == 2,
          f"doctor: native decoder reported built, K1 launched "
          f"{by_path['doctor_single']} times (expected 2)")

    # 11e: serve_bench, 8 clients
    fused_input_block.launches = 0
    _, served = run_tool(serve_bench.main, ["-p", ckpts["single"], "--image_size", str(SIZE),
                                            "--clients", str(N_CLIENTS), "--seconds",
                                            str(SERVE_BENCH_S), "--device", "cuda"],
                         "serve_bench")
    launches = by_path["serve_bench_single"] = fused_input_block.launches
    check(launches == served["batches"] + 1,
          f"serve_bench: K1 launched {launches} times = {served['batches']} batches + 1 warmup")
    out["serve_bench"] = served
    print(f"serve_bench ({CARD}): {served['tiles_per_sec']} tiles/s, p50 "
          f"{served['latency_ms_p50']} ms, p99 {served['latency_ms_p99']} ms, "
          f"{served['requests']} requests of 32 tiles, {N_CLIENTS} clients, "
          f"device busy {served['device_busy_frac']}", flush=True)

    # 11f: analyse over the run dirs of phases 8 and 10
    out["analyse"] = {name: check_analysis(os.path.join(root, name))
                      for name in ("train_single", "train_double", "train_nccl_single",
                                   "train_nccl_double")}

    # 11g: unmix_demo on phase 9's trained single-branch weights
    fused_input_block.launches = 0
    _, demo = run_tool(unmix_demo.main, ["-p", trained, "-o", os.path.join(root, "demo.png"),
                                         "--pairs", "4", "--size", str(SIZE),
                                         "--device", "cuda"], "unmix_demo")
    by_path["unmix_demo_single"] = fused_input_block.launches
    check(demo["pairs"] == 4 and math.isfinite(demo["mean_bleed_removed_pct"])
          and by_path["unmix_demo_single"] > 0,
          f"unmix_demo: {demo['mean_bleed_removed_pct']}% of the bleed energy removed, "
          f"K1 launched {by_path['unmix_demo_single']} times")
    out["unmix_demo"] = demo

    # 11h: a 2x1 sweep and a distillation, one epoch each, full width
    t0 = time.perf_counter()
    base = os.path.join(root, "sweep")
    run_tool(sweep.main, ["-m", mixed_dir, "-s", source_dir, "--batch_sizes", "64", "128",
                          "--learning_rates", "1e-3", "-n", "1", "-j", "8",
                          "--output_base", base, "--analyse", "--device", "cuda"], "sweep")
    out["sweep"] = {"s": time.perf_counter() - t0, **check_analysis(base)}
    check(out["sweep"]["rows"] == 2, "sweep: 2 run dirs analysed")
    t0 = time.perf_counter()
    base = os.path.join(root, "distill")
    run_tool(distill.main, ["-m", mixed_dir, "-s", source_dir, "-p", trained, "-b", "64",
                            "-n", "1", "-j", "8", "--output_base", base, "--device", "cuda"],
             "distill")
    (run_dir,) = glob.glob(os.path.join(base, "training_run_*"))
    check(len(read_log(run_dir)) == 1
          and glob.glob(os.path.join(run_dir, "crosstalk_regression_model_trained_*.pth")),
          "distill: one log row and the student's final .pth")
    out["distill_s"] = time.perf_counter() - t0

    decoded = dict(load_tiles.decoded)
    python_pairs = decoded["python"] - deliberate_python
    check(decoded["native"] > 0 and python_pairs == 0,
          f"decoder counter over phases 4-11: {decoded['native']} pairs native, "
          f"{python_pairs} in Python outside 11a's deliberate runs (expected 0)")
    out["decoded"] = decoded
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"phase 11 (host and workflow tools) wall: {out['phase_wall_s']:.1f} s ({CARD})",
          flush=True)
    return out


BENCH_INFER_BATCHES = {"single": 512, "double": 256}   # the bench's defaults


def phase_bench(single_stages: dict, by_path: dict) -> dict:
    """Phase 12: ``tools/bench.py`` at its defaults on the card (both models
    at full width, int8 on, 256x256 tiles): every rate finite and positive,
    the batches that ran, K1's launches on each inference measure, the
    bench's ``infer_tps`` against phase 4's ``--fast`` + normalize rate at
    batch 64; ``--num_devices`` beyond the visible cards as a usage error;
    K1 at the bench's batches held against its plain version and timed
    beside its bound there."""
    import contextlib
    import io

    from crosstalk_tpu_torch.ops.input_block import fused_input_block
    from crosstalk_tpu_torch.tools import bench

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    steps = bench.INFER_SCAN_LEN
    originals = bench.bench_model, bench.bench_int8_single

    def counted(fn, path_of):
        def run(*args, **kwargs):
            fused_input_block.launches = 0
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            by_path[path_of(*args)] = fused_input_block.launches
            return out
        return run

    bench.bench_model = counted(bench.bench_model, lambda variant, *_: f"bench_{variant}")
    bench.bench_int8_single = counted(bench.bench_int8_single, lambda *_: "bench_int8_single")
    try:
        _, result = run_tool(bench.main, [], "python -m crosstalk_tpu_torch.tools.bench")
    finally:
        bench.bench_model, bench.bench_int8_single = originals
    rates = ("infer_tps", "train_tps", "two_branch_infer_tps", "two_branch_train_tps",
             "int8_infer_tps")
    check(result is not None and all(isinstance(result[k], float) and math.isfinite(result[k])
                                     and result[k] > 0 for k in rates),
          "bench: " + ", ".join(f"{k} {result and result.get(k)}" for k in rates))
    check(result["device"] == torch.cuda.get_device_name(0)
          and result["power_limit"] == CARD.rsplit(",", 1)[1].strip(),
          f"bench: device {result['device']!r}, power limit {result['power_limit']!r}")
    asked = {"infer_batch": 512, "two_branch_infer_batch": 256, "int8_infer_batch": 512,
             "train_batch": 128, "two_branch_train_batch": 128}
    for key, want in asked.items():
        if result[key] != want:
            print(f"bench: {key} halved from {want} to {result[key]} (out of memory)",
                  flush=True)
    for path, want in (("bench_single", 4 * steps), ("bench_double", 4 * steps),
                       ("bench_int8_single", 4 * steps + 1)):
        check(by_path[path] == want,
              f"bench: K1 launched {by_path[path]} times on {path} (expected {want}: "
              f"warm-up and 3 timed units of {steps} steps"
              + (", 1 calibration)" if path == "bench_int8_single" else ")"))
    per_64_ms = single_stages["normalize"] + single_stages["fast_forward"]
    stage_tps = BATCH / per_64_ms * 1e3
    ratio = result["infer_tps"] / stage_tps
    check(0.5 <= ratio <= 2.0,
          f"bench infer_tps {result['infer_tps']} / phase 4's normalize + --fast rate at batch "
          f"{BATCH} ({stage_tps:.1f} tiles/s) = {ratio:.3f} (within 0.5-2)")

    n = torch.cuda.device_count() + 1
    err = io.StringIO()
    code = 0
    with contextlib.redirect_stderr(err):
        try:
            bench.main(["--num_devices", str(n)])
        except SystemExit as e:
            code = e.code
    msg = err.getvalue().strip().splitlines()[-1] if err.getvalue().strip() else ""
    check(code == 2 and f"only {n - 1} cuda device(s) visible" in msg,
          f"bench --num_devices {n}: exit code {code}, {msg!r}")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    k1 = {variant: phase_k1(gen, variant == "double", batch)
          for variant, batch in BENCH_INFER_BATCHES.items()}
    wall = time.perf_counter() - t_phase
    print(f"phase 12 (benchmark entry point) wall: {wall:.1f} s ({CARD})", flush=True)
    return {"result": result, "card": CARD, "stage_tps_64": stage_tps,
            "infer_tps_ratio": ratio, "k1": k1, "phase_wall_s": wall}


PROBE_TILES = 100      # the int8 tier probe's real tiles (its deviation batch)
PROBE_K1_BATCHES = (("double", 512), ("single", PROBE_TILES), ("double", PROBE_TILES),
                    ("double", 8))  # K1's batches in phase 13 that phases 1 and 12 do not hold
GROUPED_REL_MAE = ULP_BF16  # the grouped trunk vs the per-branch one, mean |diff| / mean |y|


def counted_probe(module, argv: list, path: str, by_path: dict) -> dict:
    """A probe's ``run(argv)`` with K1's launch count zeroed before and read
    after into ``by_path[path]``; its printed lines echoed."""
    from crosstalk_tpu_torch.ops.input_block import fused_input_block

    fused_input_block.launches = 0
    result = module.run(argv)
    torch.cuda.synchronize()
    by_path[path] = fused_input_block.launches
    for line in module.report(result):
        print(line, flush=True)
    return result


def finite_positive(values) -> bool:
    return all(isinstance(v, float) and math.isfinite(v) and v > 0 for v in values)


def phase_probes(root: str, trained: str, int8_tps: float, by_path: dict) -> dict:
    """Phase 13: the six measuring probes of ``crosstalk_tpu_torch/tools/``
    at full width on the card, with K1's launches on each, what they print
    held to its bounds, and K1 held against its plain version at the
    batches they give it that phases 1 and 12 do not hold."""
    from crosstalk_tpu_torch.ops.input_block import fused_input_block
    from crosstalk_tpu_torch.tools import (
        bwd_audit,
        grouped_trunk_probe,
        int8_probe,
        int8_tier_probe,
        make_dataset,
        two_branch_input_probe,
        two_branch_sol_probe,
    )

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out, launches = {}, {}
    data = os.path.join(root, "microscopy")
    run_tool(make_dataset.main, [data, "-n", str(PROBE_TILES), "--size", str(SIZE),
                                 "--preset", "microscopy"], "make_dataset --preset microscopy")

    # 13a: the int8 tier probe, K1 counted per family (``probe_family`` is
    # looked up at call time, as phase 12 counts the bench's measures)
    family = int8_tier_probe.probe_family
    run_name = {}  # the -p run's family is counted as "trained"

    def per_family(cfg, *args):
        fused_input_block.launches = 0
        result = family(cfg, *args)
        torch.cuda.synchronize()
        by_path[f"probe_int8_tier_{run_name.get('name', cfg.variant)}"] = (
            fused_input_block.launches)
        return result

    int8_tier_probe.probe_family = per_family
    try:
        _, out["int8_tier_random"] = run_tool(int8_tier_probe.main, ["--data_dir", data],
                                              "int8_tier_probe")
        run_name["name"] = "trained"
        _, out["int8_tier_trained"] = run_tool(
            int8_tier_probe.main, ["--data_dir", data, "-p", trained, "-o", "single"],
            "int8_tier_probe -p (phase 8's single-branch checkpoint)")
    finally:
        int8_tier_probe.probe_family = family
    tiers = {**{v: r for v, r in out["int8_tier_random"]["families"].items()},
             "trained": out["int8_tier_trained"]["families"]["single"]}
    for name, r in tiers.items():
        check(finite_positive([r["bf16_tps"], r["int8_tps"], r["speedup"]])
              and math.isfinite(r["mae_vs_f32"]),
              f"int8_tier_probe {name}: bf16 {r['bf16_tps']:.1f}, int8 {r['int8_tps']:.1f} "
              f"tiles/s, MAE vs f32 {r['mae_vs_f32']:.3e}, spread {r['f32_spread']:.3e}")
        steps = int8_tier_probe.SCAN_LEN
        want = 1 + 2 * 4 * steps + 1  # calibration, 2 rates x 4 units, the deviation
        path = f"probe_int8_tier_{name}"
        if r["bf16_batch"] == r["int8_batch"] == 512:
            check(by_path[path] == want, f"{path}: K1 launched {by_path[path]} times "
                                         f"(expected {want})")
        else:
            print(f"{path}: batch halved to {r['bf16_batch']} / {r['int8_batch']} (out of "
                  f"memory); K1 launched {by_path[path]} times", flush=True)
    check(tiers["trained"]["mae_vs_f32"] <= INT8_ENVELOPE,
          f"int8_tier_probe on phase 8's trained checkpoint: MAE vs f32 "
          f"{tiers['trained']['mae_vs_f32']:.3e} (tol {INT8_ENVELOPE}), f32 spread "
          f"{tiers['trained']['f32_spread']:.3e}")
    ratio = tiers["single"]["int8_tps"] / int8_tps
    check(0.8 <= ratio <= 1.25,
          f"int8_tier_probe single int8 {tiers['single']['int8_tps']:.1f} tiles/s / phase 12's "
          f"int8_infer_tps {int8_tps} = {ratio:.3f} (within 0.8-1.25: both time one program)")
    out["int8_tps_ratio_to_bench"] = ratio

    # 13b-f: the other five, each counted
    for name, module, argv in (
            ("int8_probe", int8_probe, []),
            ("bwd_audit_single", bwd_audit, ["-o", "single"]),
            ("bwd_audit_double", bwd_audit, ["-o", "double"]),
            ("two_branch_sol", two_branch_sol_probe, []),
            ("two_branch_input", two_branch_input_probe, []),
            ("grouped_trunk", grouped_trunk_probe, [])):
        t0 = time.perf_counter()
        command = ["python -m", module.__name__] + argv
        print(f"{name}: {' '.join(command)} (its defaults otherwise)", flush=True)
        counts = by_path if name.startswith("two_branch") else launches
        out[name] = counted_probe(module, argv, f"probe_{name}", counts)
        out[name]["wall_s"] = time.perf_counter() - t0
    for name in ("int8_probe", "bwd_audit_single", "bwd_audit_double", "grouped_trunk"):
        check(launches[f"probe_{name}"] == 0,
              f"{name}: K1 launched {launches[f'probe_{name}']} times (expected 0)")
    scan = 32  # the two-branch probes' default --scan: 4 units (warm-up + best of 3) each
    for name, want in (("two_branch_sol", 2 * 4 * scan), ("two_branch_input", 2 + 2 * 4 * scan)):
        check(by_path[f"probe_{name}"] == want,
              f"{name}: K1 launched {by_path[f'probe_{name}']} times (expected {want})")

    blocks = out["int8_probe"]["blocks"]
    check(all(finite_positive([b["bf16_us_per_img"], b["int8_us_per_img"], b["bf16_tflops"],
                               b["int8_tops"]]) and b["int8_abs_sum"] > 0
              for b in blocks.values()),
          "int8_probe: every rate finite and positive, int32 accumulators not all zero: "
          + ", ".join(f"{k} speedup {b['speedup']:.3f}" for k, b in blocks.items()))
    for name in ("bwd_audit_single", "bwd_audit_double"):
        check(finite_positive(out[name]["us_per_img"].values()),
              f"{name}: " + json.dumps({m: round(v, 1)
                                        for m, v in out[name]["us_per_img"].items()}))
    sol = out["two_branch_sol"]
    check(finite_positive([sol["matmul_tflops"], sol["sum_of_stages_us"], sol["full_forward_us"]]
                          + [s["us_per_img"] for s in sol["stages"].values()]),
          f"two_branch_sol_probe: matmul {sol['matmul_tflops']:.1f} TFLOP/s, sum of stages "
          f"{sol['sum_of_stages_us']:.2f} us/img, full forward {sol['full_forward_us']:.2f}")
    inp = out["two_branch_input"]
    check(finite_positive(inp["us_per_img"].values())
          and inp["prediction_max_diff"] <= 2e-3
          and max(inp["equivalence_bleed_rel"], inp["equivalence_source_rel"]) <= ULP_BF16,
          f"two_branch_input_probe: prediction max|diff| {inp['prediction_max_diff']:.3e} (tol "
          f"2e-3); kernel vs cuDNN max|diff| / max|y| bleed {inp['equivalence_bleed_rel']:.3e}, "
          f"source {inp['equivalence_source_rel']:.3e} (tol {ULP_BF16:.3e})")
    grouped = out["grouped_trunk"]
    check(all(finite_positive(t.values()) for t in grouped["trunks"].values())
          and grouped["equivalence"]["rel_mae"] <= GROUPED_REL_MAE,
          f"grouped_trunk_probe: rel MAE {grouped['equivalence']['rel_mae']:.3e} (tol "
          f"{GROUPED_REL_MAE:.3e}), rel max {grouped['equivalence']['rel_max']:.3e}")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    out["k1"] = {f"{variant}_{batch}": phase_k1(gen, variant == "double", batch)
                 for variant, batch in PROBE_K1_BATCHES}
    out["launches_not_k1_paths"] = launches
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"phase 13 (measuring probes) wall: {out['phase_wall_s']:.1f} s ({CARD})", flush=True)
    return out


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_environment()
    resources = phase_build()
    from crosstalk_tpu_torch.device import set_parity_numerics

    set_parity_numerics()  # the plain version's f32 conv must not run in TF32
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    single = phase_k1(gen, two_branch=False)
    double = phase_k1(gen, two_branch=True)

    by_path: dict = {}  # K1's launches on each path, counted from 0
    with tempfile.TemporaryDirectory() as root:
        ckpts, mixed_dir, source_dir = phase_main_path(root, by_path)
        stages = {variant: time_stages(variant, ckpt) for variant, ckpt in ckpts.items()}
        phase_serve(root, ckpts, by_path)
        phase_serve_cli(root, ckpts["single"], mixed_dir, source_dir)
        phase_predict_whole_image(root, ckpts, by_path)
        training = phase_train(root, mixed_dir, source_dir, by_path)
        t9 = time.perf_counter()
        finals = training.pop("finals")
        trained = make_spread_checkpoint(root, finals["single"], mixed_dir, source_dir)
        int8 = phase_int8(root, ckpts, trained, mixed_dir, source_dir, by_path)
        int8["export"] = phase_export(root, ckpts, mixed_dir, source_dir)
        int8["phase_wall_s"] = time.perf_counter() - t9
        print(f"phase 9 (int8 tier and export) wall: {int8['phase_wall_s']:.1f} s ({CARD})",
              flush=True)
        parallel = phase_parallel(root, ckpts, mixed_dir, source_dir, by_path)
        host_tools = phase_host_tools(root, ckpts, trained, mixed_dir, source_dir, by_path)
        bench = phase_bench(stages["single"], by_path)
        probes = phase_probes(root, finals["single"], bench["result"]["int8_infer_tps"],
                              by_path)
    paths = ["eval_single", "eval_double", "serve_single_f32", "serve_single_f16",
             "serve_double", "predict_single", "predict_double",
             "eval_trained_single", "eval_trained_double",
             "eval_trained_single_negated_bn", "eval_trained_double_negated_bn",
             "calibrate_single", "predict_int8_single", "serve_int8_single",
             "eval_ranks_single", "eval_ranks_double", "serve_replicas_single",
             "eval_replicas_single", "dispatcher_eval_single", "doctor_single",
             "serve_bench_single", "unmix_demo_single", "bench_single", "bench_double",
             "bench_int8_single", "probe_int8_tier_single", "probe_int8_tier_double",
             "probe_int8_tier_trained", "probe_two_branch_sol", "probe_two_branch_input"]
    check(sorted(by_path) == sorted(paths) and all(by_path[p] > 0 for p in paths),
          f"K1 launched on every path: {by_path}")
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"int8_export": int8}), flush=True)
    print(json.dumps({"data_parallel": parallel}), flush=True)
    print(json.dumps({"host_tools": host_tools}), flush=True)
    print(json.dumps({"bench": bench}), flush=True)
    print(json.dumps({"probes": probes}), flush=True)
    print(f"chip_smoke.py wall: {time.perf_counter() - t_start:.1f} s ({smi})", flush=True)

    kernel = {
        "name": "fused_input_block",
        "route": "cuda",
        "source": "crosstalk_tpu_torch/csrc/input_block.cu",
        "replaces": "crosstalk_tpu/ops/pallas/input_block.py:168",
        "launches": sum(by_path.values()),
        **single,
        "max_abs_err": max(t["max_abs_err"] for t in (single, double, *bench["k1"].values(),
                                                      *probes["k1"].values())),
        "launches_by_path": by_path,
        "resources_c2": resources,
        "two_branch_block_diagonal": double,
        "at_bench_batches": bench["k1"],
        "at_probe_batches": probes["k1"],
    }
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
