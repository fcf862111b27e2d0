"""Probe: does an int8 3x3 conv beat bf16 at the single-branch hot-block
shapes on the card? (port of the root ``tools/int8_probe.py``)

    python -m crosstalk_tpu_torch.tools.int8_probe [--device cuda|cpu]

The bf16 side is the conv the ``--fast`` forward runs
(``eval/fast_forward._conv_block_eval``: ``F.conv2d`` in bf16,
channels_last); the int8 side is the conv the int8 tier runs
(``eval/int8_forward._conv3x3_int8``: one ``torch._int_mm`` over the 9x
im2col, int32 accumulators). One line per block, as the JAX probe prints
it (us/img, TF/s, TOP/s, speedup), then each rate as a share of the H100
SXM data sheet's dense peaks (989 TFLOP/s bf16, 1,979 TOP/s int8) beside
the card's nvidia-smi name and power limit; the last line is a JSON object
of the numbers.

The timed unit is the JAX probe's: ``SCAN_LEN`` convs of ``x + i`` (int8
wraps), each consumed by ``sum(abs(conv))`` in float32 (a plain sum would
let a compiler factor the reduction through the conv), fenced by a
synchronize; one warm-up unit, then the best of 3.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from crosstalk_tpu_torch.eval.int8_forward import _conv3x3_int8
from crosstalk_tpu_torch.tools.bench import card, timed

BLOCKS = [
    # (name, B, H, C_in, C_out)  -- conv 3x3 s1 p1 at HxH
    ("block2", 64, 128, 128, 256),
    ("block3", 64, 64, 256, 512),
    ("block4", 64, 32, 512, 512),
]
SCAN_LEN = 16
BF16_PEAK_FLOP_PER_S = 989e12   # H100 SXM data sheet, dense
INT8_PEAK_OP_PER_S = 1979e12


def conv_bf16(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """bf16 conv3x3 (SAME) of NCHW channels_last ``x`` with OIHW ``weight``."""
    return F.conv2d(x, weight, padding=1)


def int8_weight(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO int8 (3, 3, C, N) -> the (N, 9 * C) GEMM weight of
    ``_conv3x3_int8`` (column (3 * dh + dw) * C + c)."""
    return kernel.reshape(-1, kernel.shape[3]).t().contiguous()


def conv_int8(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """int8 conv3x3 (SAME) of NHWC ``x`` -> (B, H, W, N) int32 accumulators."""
    return _conv3x3_int8(x, weight)


def unit(conv, x: torch.Tensor, weight: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` convs of ``x + i``, accumulated as sum(abs(conv)) in f32."""
    acc = torch.zeros((), device=x.device)
    for i in range(steps):
        acc = acc + conv(x + i, weight).abs().float().sum()
    return acc


def block_inputs(b: int, h: int, cin: int, cout: int, device: torch.device):
    """-> bf16 (x NCHW channels_last, OIHW weight) and int8 (x NHWC, GEMM
    weight) inputs, drawn from one generator seeded 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    cl = torch.channels_last
    xf = torch.randn(b, h, h, cin, generator=gen, device=device).to(torch.bfloat16)
    kf = torch.randn(3, 3, cin, cout, generator=gen, device=device).to(torch.bfloat16)
    xi = torch.randint(-127, 128, (b, h, h, cin), generator=gen, device=device,
                       dtype=torch.int8)
    ki = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen, device=device,
                       dtype=torch.int8)
    return ((xf.permute(0, 3, 1, 2), kf.permute(3, 2, 0, 1).contiguous(memory_format=cl)),
            (xi, int8_weight(ki)))


def run(argv=None) -> dict:
    """Parse ``argv``, time every block of ``BLOCKS``; -> the numbers."""
    from crosstalk_tpu_torch.device import resolve_device

    parser = argparse.ArgumentParser(
        prog="python -m crosstalk_tpu_torch.tools.int8_probe",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="measure on the CUDA card (default) or the CPU")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    out = {"device": str(device), "card": card(device), "scan_len": SCAN_LEN, "blocks": {}}
    for name, b, h, cin, cout in BLOCKS:
        flops = 2 * b * h * h * cin * cout * 9
        (xf, kf), (xi, ki) = block_inputs(b, h, cin, cout, device)
        with torch.inference_mode():
            tf = timed(lambda: unit(conv_bf16, xf, kf, SCAN_LEN), [device]) / SCAN_LEN
            ti = timed(lambda: unit(conv_int8, xi, ki, SCAN_LEN), [device]) / SCAN_LEN
            sums = [float(unit(c, x, k, 1)) for c, x, k in
                    ((conv_bf16, xf, kf), (conv_int8, xi, ki))]
        out["blocks"][name] = {
            "batch": b, "bf16_us_per_img": tf * 1e6 / b, "int8_us_per_img": ti * 1e6 / b,
            "bf16_tflops": flops / tf / 1e12, "int8_tops": flops / ti / 1e12,
            "speedup": tf / ti, "bf16_peak_share": flops / tf / BF16_PEAK_FLOP_PER_S,
            "int8_peak_share": flops / ti / INT8_PEAK_OP_PER_S,
            "bf16_abs_sum": sums[0], "int8_abs_sum": sums[1],
        }
    return out


def report(result: dict) -> list:
    """The printed lines of ``result``: the JAX probe's, then the shares."""
    where = result["card"] or result["device"]
    lines = [f"devices: {where}"]
    for name, r in result["blocks"].items():
        lines.append(
            f"{name}: bf16 {r['bf16_us_per_img']:7.2f} us/img ({r['bf16_tflops']:6.1f} TF/s)"
            f" | int8 {r['int8_us_per_img']:7.2f} us/img ({r['int8_tops']:6.1f} TOP/s)"
            f" | speedup {r['speedup']:.2f}x")
        lines.append(
            f"{name}: bf16 {r['bf16_peak_share']:.3f} of 989 TFLOP/s, int8 "
            f"{r['int8_peak_share']:.3f} of 1,979 TOP/s (H100 SXM dense peaks; {where})")
    lines.append(json.dumps(result))
    return lines


def main(argv=None) -> int:
    for line in report(run(argv)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
