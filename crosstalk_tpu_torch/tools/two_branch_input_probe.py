"""Probe: the two-branch model's two C=1 -> 64 input blocks as ONE
block-diagonal call of the fused input-block kernel, against two bf16
cuDNN input blocks (port of the root ``tools/two_branch_input_probe.py``).

    python -m crosstalk_tpu_torch.tools.two_branch_input_probe [-b 256]
        [--scan 32] [--size 256] [--device cuda|cpu]

In the port the block-diagonal route ships: ``make_fast_forward`` runs
block 0 of both branches as one kernel call with a (3, 3, 2, 2F) kernel,

    k[:, :, 0,  :F] = bleed kernel     k[:, :, 1, F:] = source kernel

(zeros elsewhere), and the branch outputs are channel slices of its
output; the exported programs (``use_kernel=False``) run the two per-branch
bf16 cuDNN blocks instead. Measures, at ``-b`` rows of ``--size`` px tiles
with seed-0 full-width weights:

  1. equivalence: the kernel's branch slices against the two cuDNN blocks
     (max |diff| per branch);
  2. the two cuDNN input blocks alone (the export route);
  3. the kernel and the branch slices alone (shipping);
  4. the whole ``--fast`` forward through the kernel (shipping);
  5. the whole forward with the two cuDNN input blocks
     (``make_fast_forward(use_kernel=False)``, the export route);
  6. the max |diff| of the two forwards' predictions on 8 tiles, and the
     summary line.

A timed unit is ``--scan`` steps of ``stage(x + i * 1e-9)`` consumed by a
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
    _block_affine,
    _conv_block_eval,
    _fold_conv,
    make_fast_forward,
)
from crosstalk_tpu_torch.io.torch_convert import StateDict, structure
from crosstalk_tpu_torch.ops.input_block import fused_input_block_packed, pack_input_block
from crosstalk_tpu_torch.tools.bench import card, init_weights, timed
from crosstalk_tpu_torch.tools.two_branch_sol_probe import forward_stage, scan_unit


def block_diagonal(sd: StateDict, eps: float):
    """-> (the (3, 3, 2, 2F) kernel, scale, bias) of both branches' block
    0, with F taken from the weights."""
    (bleed, _), (source, _) = structure("double")[0]
    kb, sb, bb = _block_affine(sd, bleed, 0, eps)
    ks, ss, bs = _block_affine(sd, source, 0, eps)
    f = kb.shape[-1]
    kfused = torch.zeros((3, 3, 2, 2 * f), dtype=kb.dtype, device=kb.device)
    kfused[:, :, 0:1, :f] = kb
    kfused[:, :, 1:2, f:] = ks
    return kfused, torch.cat([sb, ss]), torch.cat([bb, bs])


def kernel_branches(packed, x: torch.Tensor, slope: float):
    """The kernel on NHWC ``x`` -> (bleed, source) NHWC channel slices."""
    z = fused_input_block_packed(x, packed, slope=slope)
    f = z.shape[-1] // 2
    return z[..., :f], z[..., f:]


def cudnn_branches(blocks, x: torch.Tensor, slope: float):
    """The two per-branch bf16 cuDNN blocks on NHWC ``x`` -> (bleed,
    source) NHWC."""
    x_nchw = x.permute(0, 3, 1, 2)
    return tuple(
        _conv_block_eval(x_nchw[:, c:c + 1].contiguous(memory_format=torch.channels_last),
                         blk, slope).permute(0, 2, 3, 1)
        for c, blk in enumerate(blocks))


def _summed(pair) -> torch.Tensor:
    return pair[0].float().sum() + pair[1].float().sum()


def run(argv=None) -> dict:
    """Parse ``argv`` and probe; -> the numbers."""
    from crosstalk_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m crosstalk_tpu_torch.tools.two_branch_input_probe",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-b", "--batch", type=int, default=256)
    ap.add_argument("--scan", type=int, default=32)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="measure on the CUDA card (default) or the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    b, s, steps = args.batch, args.size, args.scan
    cfg = ModelConfig(variant="double", compute_dtype="bf16")
    sd = {k: v.to(device) for k, v in init_weights(cfg, s).state_dict().items()}
    eps, slope = cfg.bn_eps, cfg.leaky_slope
    out = {"device": str(device), "card": card(device), "batch": b, "size": s, "scan": steps,
           "us_per_img": {}, "tiles_per_s": {}}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((b, s, s, 2)).astype(np.float32)).to(device)

    def stage(fn, tree, label):
        with torch.inference_mode():
            dt = timed(lambda: scan_unit(fn, tree, x, steps), [device])
        out["us_per_img"][label] = dt / (steps * b) * 1e6
        out["tiles_per_s"][label] = steps * b / dt
        return out["us_per_img"][label]

    packed = pack_input_block(*block_diagonal(sd, eps))
    blocks = [_fold_conv(sd, prefix, 0, eps) for prefix, _ in structure("double")[0]]
    with torch.inference_mode():
        kb, ks = kernel_branches(packed, x, slope)
        cb, cs = cudnn_branches(blocks, x, slope)
        for name, k, c in (("bleed", kb, cb), ("source", ks, cs)):
            diff = (k.float() - c.float()).abs().max().item()
            out[f"equivalence_{name}"] = diff
            out[f"equivalence_{name}_rel"] = diff / c.float().abs().max().item()
        del kb, ks, cb, cs

    us_cudnn = stage(lambda w, xi: _summed(cudnn_branches(w, xi, slope)), blocks,
                     "2x cuDNN input blocks (export route)")
    us_kernel = stage(lambda p, xi: _summed(kernel_branches(p, xi, slope)), packed,
                      "block-diagonal kernel (+ slices) (shipping)")
    shipping = make_fast_forward(cfg, sd)
    export = make_fast_forward(cfg, sd, use_kernel=False)
    us_ship = stage(forward_stage, shipping, "full forward, block-diagonal kernel (shipping)")
    us_export = stage(forward_stage, export,
                      "full forward, 2x cuDNN input blocks (export route)")
    with torch.inference_mode():
        xn8 = normalize_batch_nhwc(x[:8])
        out["prediction_max_diff"] = (shipping(xn8) - export(xn8)).abs().max().item()
    out["summary"] = {"input_blocks_us": [us_cudnn, us_kernel],
                      "full_forward_us": [us_export, us_ship]}
    return out


def report(result: dict) -> list:
    lines = [f"devices: {result['card'] or result['device']}",
             f"equivalence: kernel-vs-cuDNN max|diff| bleed {result['equivalence_bleed']:.2e}, "
             f"source {result['equivalence_source']:.2e}"]
    for label, us in result["us_per_img"].items():
        lines.append(f"{label:55s} {us:8.1f} us/img  "
                     f"({result['tiles_per_s'][label]:,.0f} tiles/s)")
    lines.append(f"prediction max|diff| shipping-vs-export: "
                 f"{result['prediction_max_diff']:.2e}")
    (in_c, in_k), (full_e, full_s) = (result["summary"]["input_blocks_us"],
                                      result["summary"]["full_forward_us"])
    lines.append(f"\nsummary: input blocks {in_c:.1f} -> {in_k:.1f} us/img; "
                 f"full forward {full_e:.1f} -> {full_s:.1f} us/img "
                 f"(cuDNN export route -> shipping kernel route)")
    lines.append(json.dumps(result))
    return lines


def main(argv=None) -> int:
    for line in report(run(argv)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
