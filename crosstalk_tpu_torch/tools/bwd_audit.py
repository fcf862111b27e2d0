"""Bounded audit of the training step's backward pass (port of the root
``tools/bwd_audit.py``).

    python -m crosstalk_tpu_torch.tools.bwd_audit [-o single|double] [--device cuda|cpu]

Times five variants of the bf16 train step on 256x256 tiles, ``B`` rows,
``SCAN`` steps per timed unit, and prints us/img per mode, then a JSON dict
of them under the JAX audit's keys:

  full        : the production step (``train/steps.make_train_step``:
                normalize, flips, bf16 autocast forward, backward, Adam with
                coupled L2 at lr 1e-4, ``OptimConfig()``)
  grads       : the same batch, forward and backward with no optimizer step;
                every gradient is consumed (the sum of each, in f32)
  data_grads  : grads with ``requires_grad`` off on every conv and dense
                weight and bias (BatchNorm's affine keeps its gradient), so
                the filter-gradient convolutions are not computed
  bf16_grads  : grads taken with respect to a bf16 copy of the parameters;
                the running statistics stay f32
  bf16_full   : bf16_grads upcast to f32 for Adam on the f32 parameters;
                the bf16 copy is refreshed from them every step

Gradients are taken with ``torch.autograd.grad``, so nothing accumulates in
``.grad`` between steps. torch's ``batch_norm`` refuses a bf16 weight and
bias beside f32 running statistics, so the bf16 modes hand BatchNorm its
bf16-rounded affine as f32 values (the cast is part of the graph, so its
gradient is bf16): the affine is rounded to bf16 and the statistics stay
f32, as in the JAX audit.

Each step perturbs its input (``x + i * 1e-9``). A timed unit is a Python
loop of ``SCAN`` steps fenced by a synchronize on the host clock; every
mode runs one warm-up unit, then the best of 3, each from a fresh state
(the seed-0 weights, a new optimizer, step 0).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
from crosstalk_tpu_torch.data.transforms import DROPOUT_STREAM, counter_key, prepare_train_batch
from crosstalk_tpu_torch.models.layers import SeededDropout
from crosstalk_tpu_torch.models.registry import build_model
from crosstalk_tpu_torch.tools.bench import TRAIN_LR, card, init_weights, sync
from crosstalk_tpu_torch.train.steps import TrainState, init_train_state, make_train_step

B = 128
SCAN = 16
SIZE = 256
SEED = 2
MODES = ("full", "grads", "data_grads", "bf16_grads", "bf16_full")


def frozen_names(model: nn.Module) -> set:
    """The parameters ``data_grads`` freezes: every conv and dense weight
    and bias (the JAX audit's ``_is_kernel_or_bias``)."""
    return {f"{name}.{p}" for name, m in model.named_modules()
            if isinstance(m, (nn.Conv2d, nn.Linear)) for p in ("weight", "bias")}


def set_trainable(model: nn.Module, mode: str) -> None:
    """``requires_grad`` on every parameter but, under ``data_grads``,
    ``frozen_names``."""
    frozen = frozen_names(model) if mode == "data_grads" else set()
    for n, p in model.named_parameters():
        p.requires_grad_(n not in frozen)


def _batch_norm_names(model: nn.Module) -> set:
    return {f"{name}.{p}" for name, m in model.named_modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm) for p in ("weight", "bias")}


def loss_and_grads(model: nn.Module, batch: torch.Tensor, labels: torch.Tensor, mode: str,
                   compute_dtype: str = "bf16") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The train-mode MSE on an already prepared (B, H, W, 2) ``batch`` and
    its gradients, by name, with respect to what ``mode`` differentiates:
    every parameter that requires a gradient (``grads``, ``data_grads``)
    or a bf16 copy of every parameter (``bf16_*``). The running
    statistics update as in any train-mode forward."""
    x = batch.permute(0, 3, 1, 2)
    with torch.autocast(batch.device.type, dtype=torch.bfloat16,
                        enabled=compute_dtype == "bf16"):
        if mode.startswith("bf16"):
            leaves = {n: p.detach().to(torch.bfloat16).requires_grad_()
                      for n, p in model.named_parameters()}
            affine = _batch_norm_names(model)
            values = {n: v.float() if n in affine else v for n, v in leaves.items()}
            preds = functional_call(model, values, (x,))
        else:
            leaves = {n: p for n, p in model.named_parameters() if p.requires_grad}
            preds = model(x)
    loss = F.mse_loss(preds.to(labels.dtype), labels)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def make_step(state: TrainState, mode: str, seed: int = SEED) -> Callable:
    """-> ``step(x, y) -> a 0-d loss`` (plus the gradients' sum where no
    optimizer consumes them) of ``mode`` on ``state``."""
    if mode == "full":
        train_step = make_train_step(state, compute_dtype="bf16", seed=seed, augment=True)
        return lambda x, y: train_step(x, y, TRAIN_LR)
    model, opt = state.model, state.optimizer
    gen = torch.Generator(device=next(model.parameters()).device)
    for m in model.modules():
        if isinstance(m, SeededDropout):
            m.generator = gen
    set_trainable(model, mode)

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        batch = prepare_train_batch(x, seed, state.step, augment=True)
        gen.manual_seed(counter_key(seed, state.step, DROPOUT_STREAM, 0))
        model.train()
        loss, grads = loss_and_grads(model, batch, y, mode)
        state.step += 1
        if mode == "bf16_full":
            for group in opt.param_groups:
                group["lr"] = TRAIN_LR
            for n, p in model.named_parameters():
                p.grad = grads[n].float()
            opt.step()
            opt.zero_grad(set_to_none=True)
            return loss
        return loss + sum(g.float().sum() for g in grads.values())

    return step


def fresh_state(cfg: ModelConfig, snapshot: dict, device: torch.device) -> TrainState:
    """The seed-0 weights in a new model on ``device``, a new optimizer."""
    model = build_model(cfg, image_size=SIZE, device=device)
    model.load_state_dict(snapshot)
    return init_train_state(model, OptimConfig())


def unit(step: Callable, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``SCAN`` steps of ``x + i * 1e-9`` (the shift in f32, as JAX)."""
    shifts = torch.arange(SCAN, dtype=torch.float32, device=x.device) * 1e-9
    loss = None
    for i in range(SCAN):
        loss = step(x + shifts[i], y)
    return loss


def mode_seconds(cfg: ModelConfig, snapshot: dict, mode: str, x, y, device) -> float:
    """One warm-up unit, then the best of 3, each on a fresh state."""
    best = float("inf")
    for rep in range(4):
        step = make_step(fresh_state(cfg, snapshot, device), mode)
        sync([device])
        t0 = time.perf_counter()
        unit(step, x, y)
        sync([device])
        if rep:
            best = min(best, time.perf_counter() - t0)
    return best


def run(argv=None) -> dict:
    """Parse ``argv``, time the five modes; -> us/img per mode and more."""
    from crosstalk_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m crosstalk_tpu_torch.tools.bwd_audit",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-o", "--model_options", default="single", choices=["single", "double"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="measure on the CUDA card (default) or the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = ModelConfig(variant=args.model_options, compute_dtype="bf16")
    snapshot = init_weights(cfg, SIZE).state_dict()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((B, SIZE, SIZE, 2)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.uniform(0, 0.5, (B, 1)).astype(np.float32)).to(device)
    out = {"device": str(device), "card": card(device), "variant": cfg.variant, "batch": B,
           "scan": SCAN, "us_per_img": {}, "tiles_per_s": {}}
    for mode in MODES:
        best = mode_seconds(cfg, snapshot, mode, x, y, device)
        out["us_per_img"][mode] = best / (SCAN * B) * 1e6
        out["tiles_per_s"][mode] = SCAN * B / best
    return out


def report(result: dict) -> list:
    lines = [f"devices: {result['card'] or result['device']}"]
    for mode in MODES:
        lines.append(f"{mode:12s}: {result['us_per_img'][mode]:8.1f} us/img   "
                     f"({result['tiles_per_s'][mode]:.0f} tiles/s)")
    lines.append(json.dumps({m: round(v, 1) for m, v in result["us_per_img"].items()}))
    return lines


def main(argv=None) -> int:
    for line in report(run(argv)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
