"""Per-stage speed-of-light accounting of the two-branch serving forward
(port of the root ``tools/two_branch_sol_probe.py``).

    python -m crosstalk_tpu_torch.tools.two_branch_sol_probe [-b 256] [--scan 32]
        [--device cuda|cpu]

Times each stage of the ``--fast`` forward of the full-width two-branch
model (seed-0 weights) at ``-b`` rows and sets it beside its own FLOP
floor at the card's bf16 matmul rate, measured in the same run (the best
of 3 of one ``MATMUL_N``^3 bf16 ``torch.matmul``):

  * the input block of both branches (``make_first_block``: one
    block-diagonal call of the fused input-block kernel on the card);
  * branch blocks 1-3 (``_fold_conv`` + ``_conv_block_eval`` on the bleed
    branch's weights, counted twice in the sum: both branches);
  * the head (``_dense_bn_eval`` twice, ``_matmul_f32``, sigmoid x 0.5).

The summary line sets the sum of the stages beside the whole ``--fast``
forward with its normalize, timed at the same batch in the same run. A
timed unit is ``--scan`` steps of ``stage(x + i * 1e-9)`` consumed by a
sum in f32, fenced by a synchronize on the host clock; one warm-up unit,
then the best of 3. The last line is a JSON object of the numbers.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from crosstalk_tpu_torch.config import ModelConfig
from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
from crosstalk_tpu_torch.eval.fast_forward import (
    _conv_block_eval,
    _dense_bn_eval,
    _fold_conv,
    _fold_dense,
    _matmul_f32,
    head_weights,
    make_fast_forward,
    make_first_block,
)
from crosstalk_tpu_torch.io.torch_convert import structure
from crosstalk_tpu_torch.tools.bench import card, init_weights, timed

SIZE = 256
MATMUL_N = 8192
# GFLOP (2 x MACs) per image of each stage of the full-width model at
# 256x256, the JAX probe's
INPUT_GFLOP = 2 * 0.075     # both branches' 1 -> 64 convs at 256^2
BLOCK_GFLOP = 2.42          # each of blocks 1-3, per branch
HEAD_GFLOP = 0.27           # 262144 -> 512 -> 128 -> 1


def matmul_tflops(device: torch.device, n: int = MATMUL_N) -> float:
    """The card's bf16 matmul rate: 2 n^3 over the best of 3 host-clock
    times of one ``a @ b`` (one warm-up), in TFLOP/s."""
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(n, n, generator=gen, device=device).to(torch.bfloat16)
    b = torch.randn(n, n, generator=gen, device=device).to(torch.bfloat16)
    with torch.inference_mode():
        dt = timed(lambda: a @ b, [device])
    return 2 * n ** 3 / dt / 1e12


def scan_unit(fn, tree, x: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` steps of ``fn(tree, x + i * 1e-9)`` (i and 1e-9 in x's
    dtype, as the JAX probe's), accumulated."""
    shifts = (torch.arange(steps, device=x.device).to(x.dtype)
              * torch.tensor(1e-9, dtype=x.dtype, device=x.device))
    acc = torch.zeros((), device=x.device)
    for i in range(steps):
        acc = acc + fn(tree, x + shifts[i])
    return acc


def input_stage(first, x: torch.Tensor) -> torch.Tensor:
    return sum(z.float().sum() for z in first(x))


def block_stage(blk, x: torch.Tensor, slope: float) -> torch.Tensor:
    return _conv_block_eval(x, blk, slope).float().sum()


def head_stage(head, h: torch.Tensor, slope: float) -> torch.Tensor:
    dense, w_out, b_out = head
    h = h.reshape(h.shape[0], -1)
    for d in dense:
        h = _dense_bn_eval(h, d, slope)
    return (torch.sigmoid(_matmul_f32(h, w_out) + b_out) * 0.5).sum()


def forward_stage(forward, x: torch.Tensor) -> torch.Tensor:
    return forward(normalize_batch_nhwc(x)).sum()


def run(argv=None) -> dict:
    """Parse ``argv``, time every stage; -> the numbers."""
    from crosstalk_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m crosstalk_tpu_torch.tools.two_branch_sol_probe",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-b", "--batch", type=int, default=256)
    ap.add_argument("--scan", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="measure on the CUDA card (default) or the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    b, steps = args.batch, args.scan
    cfg = ModelConfig(variant="double", compute_dtype="bf16")
    sd = {k: v.to(device) for k, v in init_weights(cfg, SIZE).state_dict().items()}
    eps, slope = cfg.bn_eps, cfg.leaky_slope
    peak = matmul_tflops(device)
    out = {"device": str(device), "card": card(device), "batch": b, "scan": steps,
           "matmul_n": MATMUL_N, "matmul_tflops": peak, "stages": {}}
    rng = np.random.default_rng(0)

    def stage(fn, tree, x, label, gflop_per_img):
        with torch.inference_mode():
            dt = timed(lambda: scan_unit(fn, tree, x, steps), [device])
        us = dt / (steps * b) * 1e6
        theory = gflop_per_img / peak * 1e3  # us at the measured rate
        out["stages"][label] = {"us_per_img": us, "theory_us": theory,
                                "peak_share": theory / us if us else 0.0}
        return us

    def tiles(*shape):
        return torch.from_numpy(rng.random(shape).astype(np.float32)).to(device)

    x0 = tiles(b, SIZE, SIZE, 2)
    us_in = stage(input_stage, make_first_block(cfg, sd), x0,
                  "fused input block (both branches)", INPUT_GFLOP)
    branches, head = structure("double")
    bleed = branches[0][0]
    us_blocks = []
    for i in (1, 2, 3):  # the shapes each block sees in the forward
        blk = _fold_conv(sd, bleed, i, eps)
        cout, cin, hw = blk.weight.shape[0], blk.weight.shape[1], SIZE >> i
        x = tiles(b, hw, hw, cin).to(torch.bfloat16).permute(0, 3, 1, 2)
        us_blocks.append(stage(lambda w, xi: block_stage(w, xi, slope), blk, x,
                               f"branch block {i} ({cin}->{cout} @{hw}^2), x2 branches",
                               BLOCK_GFLOP))
    w1, w5 = head_weights(cfg, sd)
    weights = ([_fold_dense(sd, head, 1, 2, eps, w1), _fold_dense(sd, head, 5, 6, eps, w5)],
               sd[f"{head}.9.weight"].to(torch.bfloat16).contiguous(),
               sd[f"{head}.9.bias"].float())
    side = SIZE >> 4
    hx = tiles(b, side, side, 2 * cout).to(torch.bfloat16)
    us_head = stage(lambda w, h: head_stage(w, h, slope), weights, hx,
                    f"head ({w1.shape[1]}->{w1.shape[0]}->{w5.shape[0]}->1)", HEAD_GFLOP)
    del x0, x, hx

    fast = make_fast_forward(cfg, sd)
    xf = tiles(b, SIZE, SIZE, 2)
    with torch.inference_mode():
        dt = timed(lambda: scan_unit(forward_stage, fast, xf, steps), [device])
    out["sum_of_stages_us"] = us_in + 2 * sum(us_blocks) + us_head
    out["full_forward_us"] = dt / (steps * b) * 1e6
    return out


def report(result: dict) -> list:
    where = result["card"] or result["device"]
    lines = [f"devices: {where}",
             f"bf16 matmul rate: {result['matmul_tflops']:.1f} TFLOP/s "
             f"({result['matmul_n']}^3, best of 3, measured in this run; {where})"]
    for label, s in result["stages"].items():
        lines.append(f"{label:42s} {s['us_per_img']:7.1f} us/img  theory "
                     f"{s['theory_us']:5.1f}  -> {s['peak_share'] * 100:4.0f}% of peak")
    lines.append(f"\nsum of stages: {result['sum_of_stages_us']:.1f} us/img (full --fast "
                 f"forward measures {result['full_forward_us']:.1f} at batch "
                 f"{result['batch']} in this run; the remainder is normalize, concat, "
                 f"and the stages' separate launches)")
    lines.append(json.dumps(result))
    return lines


def main(argv=None) -> int:
    for line in report(run(argv)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
