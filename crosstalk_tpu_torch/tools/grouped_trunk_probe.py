"""Probe: the two-branch trunk as grouped convs against per-branch convs
(port of the root ``tools/grouped_trunk_probe.py``).

    python -m crosstalk_tpu_torch.tools.grouped_trunk_probe [--device cuda|cpu]

The two-branch model runs two weight-independent 4-block encoders over the
bleed and source channels and concatenates their features. That equals
ONE stack of ``groups=2`` convs on the 2-channel input, each block's
kernels concatenated on the output channels. Measures the eval-mode trunk
forward and forward+backward of both forms (bf16, channels_last, F=64 per
branch, ``B`` rows of 256x256 tiles, weights drawn from a generator seeded
0 with the JAX probe's scales), checks that the two agree, and prints
us/img. A timed unit is ``SCAN`` steps of ``x + i * 1e-9``, fenced by a
synchronize on the host clock; one warm-up unit, then the best of 3. The
last line is a JSON object of the numbers.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from crosstalk_tpu_torch.eval.fast_forward import bf16_value
from crosstalk_tpu_torch.tools.bench import card, timed

B = 64
SCAN = 8
SIZE = 256
FEATS = [64, 128, 256, 512]  # per branch

_BF16 = torch.bfloat16


def block(x: torch.Tensor, k: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
          groups: int = 1) -> torch.Tensor:
    """bf16 conv3x3 (SAME) of NCHW ``x`` with OIHW ``k``, affine, LeakyReLU
    with the bf16 slope, 2x2 max pool."""
    y = F.conv2d(x.to(_BF16), k.to(_BF16), padding=1, groups=groups)
    y = y * scale.to(_BF16).view(1, -1, 1, 1) + bias.to(_BF16).view(1, -1, 1, 1)
    return F.max_pool2d(F.leaky_relu(y, bf16_value(0.01)), 2)


def make_params(device: torch.device):
    """-> (kernels, scales, biases): per block a (bleed, source) pair each;
    OIHW kernels N(0, 1) x 0.1, scales N(0, 1) x 0.1 + 1, biases +-0.01."""
    gen = torch.Generator(device=device).manual_seed(0)
    ks, ss, bs = [], [], []
    c = 1
    for f in FEATS:
        ks.append(tuple(torch.randn(f, c, 3, 3, generator=gen, device=device) * 0.1
                        for _ in range(2)))
        ss.append(tuple(torch.randn(f, generator=gen, device=device) * 0.1 + 1.0
                        for _ in range(2)))
        bs.append((torch.full((f,), 0.01, device=device), torch.full((f,), -0.01, device=device)))
        c = f
    return ks, ss, bs


def perbranch_trunk(params, x: torch.Tensor) -> torch.Tensor:
    """Each branch's blocks on its own channel of NCHW ``x``, concatenated."""
    ks, ss, bs = params
    hb, hs = x[:, 0:1], x[:, 1:2]
    for (kb, ksrc), (sb, ssrc), (bb, bsrc) in zip(ks, ss, bs):
        hb = block(hb, kb, sb, bb)
        hs = block(hs, ksrc, ssrc, bsrc)
    return torch.cat([hb, hs], dim=1)


def grouped_trunk(params, x: torch.Tensor) -> torch.Tensor:
    """One ``groups=2`` conv per block, the branches' kernels concatenated."""
    ks, ss, bs = params
    h = x
    for (kb, ksrc), (sb, ssrc), (bb, bsrc) in zip(ks, ss, bs):
        h = block(h, torch.cat([kb, ksrc]), torch.cat([sb, ssrc]), torch.cat([bb, bsrc]),
                  groups=2)
    return h


def _leaves(params):
    return [t for group in params for pair in group for t in pair]


def fwd_unit(trunk, params, x: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(SCAN, dtype=torch.float32, device=x.device) * 1e-9
    acc = torch.zeros((), device=x.device)
    for i in range(SCAN):
        acc = acc + trunk(params, x + shifts[i]).float().sum()
    return acc


def bwd_unit(trunk, params, x: torch.Tensor) -> torch.Tensor:
    """Per step the mean square of the trunk's output and its gradient with
    respect to every weight, all consumed."""
    shifts = torch.arange(SCAN, dtype=torch.float32, device=x.device) * 1e-9
    acc = torch.zeros((), device=x.device)
    leaves = _leaves(params)
    for i in range(SCAN):
        loss = trunk(params, x + shifts[i]).float().square().mean()
        grads = torch.autograd.grad(loss, leaves)
        acc = acc + loss.detach() + sum(g.float().sum() for g in grads)
    return acc


def run(argv=None) -> dict:
    """Parse ``argv``, check and time both trunks; -> the numbers."""
    from crosstalk_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m crosstalk_tpu_torch.tools.grouped_trunk_probe",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="measure on the CUDA card (default) or the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    params = make_params(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((B, SIZE, SIZE, 2)).astype(np.float32)).to(device)
    x = x.permute(0, 3, 1, 2)  # NCHW, channels_last in memory
    out = {"device": str(device), "card": card(device), "batch": B, "scan": SCAN, "trunks": {}}
    with torch.inference_mode():
        a = perbranch_trunk(params, x).float()
        b = grouped_trunk(params, x).float()
        diff = (a - b).abs()
        scale = a.abs().mean().item()
        out["equivalence"] = {"rel_mae": diff.mean().item() / scale,
                              "rel_max": diff.max().item() / scale, "mean_abs": scale}
        del a, b, diff
    for p in _leaves(params):
        p.requires_grad_()
    for name, trunk in (("per-branch", perbranch_trunk), ("grouped", grouped_trunk)):
        with torch.no_grad():
            fwd = timed(lambda: fwd_unit(trunk, params, x), [device])
        bwd = timed(lambda: bwd_unit(trunk, params, x), [device])
        out["trunks"][name] = {"fwd_us_per_img": fwd / (SCAN * B) * 1e6,
                               "fwd_bwd_us_per_img": bwd / (SCAN * B) * 1e6}
    return out


def report(result: dict) -> list:
    e = result["equivalence"]
    lines = [f"devices: {result['card'] or result['device']}",
             f"equivalence: rel MAE={e['rel_mae']:.3e} rel max={e['rel_max']:.3e} "
             f"(|a| mean {e['mean_abs']:.3f})"]
    for name, t in result["trunks"].items():
        lines.append(f"{name:11s}: fwd {t['fwd_us_per_img']:7.1f} us/img   "
                     f"fwd+bwd {t['fwd_bwd_us_per_img']:7.1f} us/img")
    lines.append(json.dumps(result))
    return lines


def main(argv=None) -> int:
    for line in report(run(argv)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
