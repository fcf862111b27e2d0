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
  4. the main path: 256 seeded synthetic 256x256 TIFF pairs scored by the
     eval CLI (``crosstalk_tpu_torch.cli.evaluate.main``) with random
     full-width single- and two-branch models, ``--fast`` and f32; checks
     rows, fast-vs-f32 agreement, f32 vs a float64 run of the same model on
     the card, and K1's launch count on each ``--fast`` run.

The last three lines are the kernels JSON, the nvidia-smi line and
``{"ok": true, "device": {...}}``. Imports nothing of the JAX package.
"""

from __future__ import annotations

import csv
import glob
import json
import math
import os
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


def k1_inputs(gen: torch.Generator, two_branch: bool):
    """Flagship block-0 inputs on the card; every fifth BN scale negative."""
    dev = "cuda"
    x = torch.rand(BATCH, SIZE, SIZE, 2, device=dev, generator=gen)
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


def phase_k1(gen: torch.Generator, two_branch: bool) -> dict:
    from crosstalk_tpu_torch.ops.input_block import (
        fused_input_block,
        fused_input_block_packed,
        fused_input_block_reference,
        pack_input_block,
    )

    label = "two-branch block-diagonal" if two_branch else "single-branch"
    x, kernel, scale, bias = k1_inputs(gen, two_branch)
    packed = pack_input_block(kernel, scale, bias)
    y = fused_input_block_packed(x, packed)
    public = fused_input_block(x, kernel, scale, bias)
    torch.cuda.synchronize()
    check(torch.equal(y.view(torch.int16), public.view(torch.int16)),
          f"K1 {label}: packed and public entries give identical bytes")
    ref = fused_input_block_reference(x, kernel, scale, bias)
    torch.cuda.synchronize()
    check(y.shape == ref.shape and y.dtype == torch.bfloat16,
          f"K1 {label}: shape {tuple(y.shape)} {y.dtype}")
    yf, rf = y.float(), ref.float()
    diff = (yf - rf).abs()
    big = rf.abs() > 1e-3
    max_rel = (diff[big] / rf.abs()[big]).max().item() if big.any() else 0.0
    max_abs_small = diff[~big].max().item() if (~big).any() else 0.0
    max_abs = diff.max().item()
    check(bool(torch.isfinite(yf).all()) and max_rel <= ULP_BF16 and max_abs_small <= 1e-5,
          f"K1 {label} vs plain: max rel {max_rel:.3e} (tol {ULP_BF16:.3e} "
          f"where |y| > 1e-3), max abs elsewhere {max_abs_small:.3e} (tol 1e-5)")

    # the cuDNN chain computing the same function: bf16 channels_last conv,
    # affine, LeakyReLU, 2x2 max pool (timed only; the port never calls it)
    x_nchw = x.permute(0, 3, 1, 2)
    w_cl = kernel.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    s_b = scale.to(torch.bfloat16).view(1, -1, 1, 1)
    b_b = bias.to(torch.bfloat16).view(1, -1, 1, 1)

    def library():
        z = F.conv2d(x_nchw.to(torch.bfloat16), w_cl, padding=1)
        return F.max_pool2d(F.leaky_relu(z * s_b + b_b, 0.01), 2)

    ms = time_ms(lambda: fused_input_block_packed(x, packed))
    plain_ms = time_ms(lambda: fused_input_block_reference(x, kernel, scale, bias))
    library_ms = time_ms(library)

    b, h, w, c = x.shape
    f = kernel.shape[-1]
    bytes_moved = (x.numel() * 4 + kernel.numel() * 4 + (scale.numel() + bias.numel()) * 4
                   + b * (h // 2) * (w // 2) * f * 2)
    flops = 2 * b * h * w * int(torch.count_nonzero(kernel))
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"K1 {label}: kernel {ms:.4f} ms ({ms * 1e3 / b:.3f} us/tile), "
          f"plain {plain_ms:.4f} ms, cuDNN chain {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_ms * 1e3 / b:.3f} us/tile; "
          f"{bytes_moved} B, {flops} FLOP), share of bound {bound_ms / ms:.3f}",
          flush=True)
    return {
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
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


def phase_main_path(root: str, counters: dict) -> dict:
    """-> {variant: checkpoint path}; ``counters`` gets K1's launches of
    each variant's --fast run."""
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
        before = fused_input_block.launches
        fast_rows, fast_s = run_cli(common + ["--output_base", os.path.join(root, f"{variant}_fast"), "--fast"])
        launches = fused_input_block.launches - before
        counters[variant] = launches
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
    return ckpts


def time_stages(variant: str, ckpt: str) -> None:
    """Device time of each stage of one eval batch (B=64, 256x256): the
    normalize, the --fast and f32 forwards, and the five metrics."""
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
    print(f"{variant} stages per batch of {BATCH} (ms, CUDA events): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; --fast forward {BATCH / times['fast_forward'] * 1e3:.0f} tiles/s",
          flush=True)


def main() -> int:
    smi = phase_environment()
    resources = phase_build()
    from crosstalk_tpu_torch.device import set_parity_numerics
    from crosstalk_tpu_torch.ops.input_block import fused_input_block

    set_parity_numerics()  # the plain version's f32 conv must not run in TF32
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    single = phase_k1(gen, two_branch=False)
    double = phase_k1(gen, two_branch=True)

    counters: dict = {}
    fused_input_block.launches = 0
    with tempfile.TemporaryDirectory() as root:
        ckpts = phase_main_path(root, counters)
        launches = fused_input_block.launches  # read before any timing
        check(launches > 0, f"main path launched K1 {launches} times")
        for variant, ckpt in ckpts.items():
            time_stages(variant, ckpt)

    kernel = {
        "name": "fused_input_block",
        "route": "cuda",
        "source": "crosstalk_tpu_torch/csrc/input_block.cu",
        "replaces": "crosstalk_tpu/ops/pallas/input_block.py:168",
        "launches": launches,
        **single,
        "max_abs_err": max(single["max_abs_err"], double["max_abs_err"]),
        "launches_by_model": counters,
        "resources_c2": resources,
        "two_branch_block_diagonal": double,
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
