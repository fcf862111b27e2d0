"""Plain train steps of the published training loop
(djpbarry/Torch-Unet ``train_model.py``: min-max normalize, paired random
flips, MSE loss, ``torch.optim.Adam`` with ``weight_decay`` coupled into the
gradient), in float32 or a control precision (``model.forward``).

Adam with coupled L2, per parameter p with gradient g at step t:
    g' = g + wd * p
    m = b1 m + (1 - b1) g' ;  v = b2 v + (1 - b2) g'^2
    p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)

BatchNorm running statistics, per step, with the configuration's momentum
mu: r = (1 - mu) r + mu * s, where s is the batch mean or the unbiased batch
variance.

This file imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import model, rules


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


class ReferenceTraining:
    """Parameters, running statistics and Adam moments of one run, stepped
    by ``step``; from step ``t`` with moments ``m`` and ``v`` where given
    (zero otherwise)."""

    def __init__(self, config: dict, optim: dict, weights: model.Weights,
                 precision: str = "f32", mask_dtype=torch.float32, t: int = 0,
                 m: Optional[Dict[str, torch.Tensor]] = None,
                 v: Optional[Dict[str, torch.Tensor]] = None):
        self.config, self.optim = config, optim
        self.precision, self.mask_dtype = precision, mask_dtype
        self.keys = model.trainable(config)
        self.stat_keys = model.running_stats(config)
        self.w = {k: v.detach().clone() for k, v in weights.items()}
        self.m = {k: (m[k].detach().clone() if m else torch.zeros_like(self.w[k]))
                  for k in self.keys}
        self.v = {k: (v[k].detach().clone() if v else torch.zeros_like(self.w[k]))
                  for k in self.keys}
        self.t = t
        self.last_grad: Dict[str, torch.Tensor] = {}
        self.last_preds: Optional[torch.Tensor] = None

    def step(self, raw: torch.Tensor, labels: torch.Tensor, seed: int,
             lr: float) -> float:
        """One optimizer step on (B, H, W, 2) raw tiles and (B,) labels;
        the step's draws are those of step ``self.t`` -> the loss."""
        b = raw.shape[0]
        params = {k: self.w[k].requires_grad_(True) for k in self.keys}
        w = {**self.w, **params}
        masks = rules.dropout_masks(seed, self.t, b, self.config["dropout"],
                                    self.mask_dtype, raw.device)
        stats: model.BatchStats = {}
        preds = model.forward(self.config, w, raw, bn=model.BatchNormMode.TRAIN,
                              precision=self.precision, dropout_masks=masks,
                              flips=rules.flips(seed, self.t, b, raw.device),
                              recompute=True, bn_stats=stats)
        loss = F.mse_loss(preds, labels)
        grads = torch.autograd.grad(loss, [params[k] for k in self.keys])
        self.last_preds = preds.detach()
        mu = self.config["bn_momentum"]
        with torch.no_grad():
            for key, (mean, var) in stats.items():
                self.w[f"{key}.running_mean"].mul_(1 - mu).add_(mean, alpha=mu)
                self.w[f"{key}.running_var"].mul_(1 - mu).add_(var, alpha=mu)
        o = self.optim
        self.t += 1
        c1 = 1 - o["adam_b1"] ** self.t
        c2 = math.sqrt(1 - o["adam_b2"] ** self.t)
        self.last_grad = {}
        with torch.no_grad():
            for k, g in zip(self.keys, grads):
                p = self.w[k].requires_grad_(False)
                self.last_grad[k] = g
                g = g + o["weight_decay"] * p
                self.m[k].mul_(o["adam_b1"]).add_(g, alpha=1 - o["adam_b1"])
                self.v[k].mul_(o["adam_b2"]).addcmul_(g, g, value=1 - o["adam_b2"])
                p.sub_(lr / c1 * self.m[k] / (self.v[k].sqrt() / c2 + o["adam_eps"]))
        return float(loss.detach())

    def first_moment_as_gradient(self) -> Dict[str, torch.Tensor]:
        """After one step: the gradient the optimizer took (L2 included),
        read back from the first moment."""
        return {k: self.m[k] / (1 - self.optim["adam_b1"]) for k in self.keys}


def reference_run(config: dict, optim: dict, weights: model.Weights,
                  batches: List, seed: int, lr: float, precision: str = "f32",
                  mask_dtype=torch.float32) -> dict:
    """Steps 0..len(batches)-1 from ``weights`` -> the readings that the
    train cells compare: ``losses``, ``first_preds`` (the first step's
    predictions), ``first_gradient`` (the first step's gradient as the
    optimizer took it) and ``grad`` (its leaf norms), ``raw_grad`` (the
    same without L2), ``change`` (leaf norms of the parameters' change
    after the last step) and ``stats_change`` (the same of the running
    statistics)."""
    run = ReferenceTraining(config, optim, weights, precision, mask_dtype)
    out = {"losses": []}
    for i, (raw, labels) in enumerate(batches):
        out["losses"].append(run.step(raw, labels, seed, lr))
        if i == 0:
            out["first_preds"] = run.last_preds
            out["first_gradient"] = {k: v.clone() for k, v in
                                     run.first_moment_as_gradient().items()}
            out["grad"] = leaf_norms(out["first_gradient"])
            out["raw_grad"] = leaf_norms(run.last_grad)
    out["change"] = leaf_norms({k: run.w[k] - weights[k] for k in run.keys})
    out["stats_change"] = leaf_norms({k: run.w[k] - weights[k] for k in run.stat_keys})
    return out
