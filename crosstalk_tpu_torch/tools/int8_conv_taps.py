"""Two ways to compute an int8 3x3 conv on the card, side by side.

    python -m crosstalk_tpu_torch.tools.int8_conv_taps [--batch 256]

Block 1 of the full-width single-branch model (128 -> 256 channels at
128x128; random weights from a seed, the input is block 0's output on
random tiles, its clip the MSE calibration's): the int8 tier's one GEMM
over the 9x im2col (``eval/int8_forward._conv3x3_int8``) against nine
shifted-tap GEMMs accumulated in int32 (K = C_in each, no im2col). Prints
that both give the same int32 accumulators, and each one's device time
(CUDA events) and the device memory it allocates beyond its input.

Needs a CUDA card; imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import subprocess

import torch
import torch.nn.functional as F


def nine_tap_products(xq: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """int8 NHWC ``xq`` (B, H, W, C), ``weight`` (N, 9 * C) int8 -> (B, H,
    W, N) int32 accumulators as nine tap GEMMs. Over the zero-padded input
    flattened to rows of C, output row r = b * P + y * (W + 2) + x sums tap
    (dh, dw) times input row r + dh * (W + 2) + dw: each tap is a GEMM over
    a contiguous row slice."""
    b, h, w, c = xq.shape
    row = w + 2
    flat = F.pad(xq, (0, 0, 1, 1, 1, 1)).reshape(-1, c)
    m = flat.shape[0] - 2 * row - 2
    taps = weight.view(weight.shape[0], 9, c)
    acc = None
    for t in range(9):
        off = (t // 3) * row + t % 3
        p = torch._int_mm(flat[off:off + m], taps[:, t].contiguous().t())
        acc = p if acc is None else acc.add_(p)
    n = acc.shape[1]
    return acc.as_strided((b, h, w, n), ((h + 2) * row * n, row * n, n, 1))


def _time_ms(fn, iters: int = 3, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(batch: int) -> dict:
    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.eval.fast_forward import _block_affine, make_first_block
    from crosstalk_tpu_torch.eval.int8_forward import (
        _conv3x3_int8,
        _mse_clip,
        _quantize,
        prepare_conv_int8,
    )
    from crosstalk_tpu_torch.models.registry import build_model, init_model

    cfg = ModelConfig()
    model = init_model(build_model(cfg), torch.Generator().manual_seed(0))
    sd = {k: v.cuda() for k, v in model.eval().state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    tiles = torch.rand(batch, 256, 256, 2, device="cuda", generator=gen)
    out = {}
    with torch.inference_mode():
        x = make_first_block(cfg, sd)(tiles)[0].permute(0, 2, 3, 1)
        del tiles
        blk = prepare_conv_int8(*_block_affine(sd, "conv_layers", 1, cfg.bn_eps),
                                float(_mse_clip(x)))
        xq = _quantize(x, blk.qs)
        del x
        accs = {}
        for name, fn in (("im2col", _conv3x3_int8), ("taps", nine_tap_products)):
            ms = _time_ms(lambda: fn(xq, blk.weight))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            accs[name] = fn(xq, blk.weight)
            torch.cuda.synchronize()
            out[name] = {"ms": ms,
                         "extra_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}
            accs[name] = accs[name].cpu()
        out["equal"] = torch.equal(accs["im2col"], accs["taps"])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=256)
    args = parser.parse_args(argv)

    from crosstalk_tpu_torch.device import resolve_device

    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}, torch {torch.__version__}")
    out = compare(args.batch)
    print(f"int8 block-1 conv, batch {args.batch} ({smi}): one im2col GEMM {out['im2col']['ms']:.3f} "
          f"ms, +{out['im2col']['extra_gib']:.2f} GiB; nine tap GEMMs {out['taps']['ms']:.3f} ms, "
          f"+{out['taps']['extra_gib']:.2f} GiB; int32 accumulators "
          f"{'equal' if out['equal'] else 'DIFFERENT'}", flush=True)
    return 0 if out["equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
