"""Building blocks of the two regressors (port of crosstalk_tpu/models/layers.py).

Each builder returns the reference's ``nn.Sequential`` items in order, so the
modules' state_dict keys are the reference's (conv_layers.{4k}, ...; see
tests/torch_ref.py) and a ``.pth`` loads natively. Layout is NCHW.

Reference semantics: Conv2d 3x3 stride 1 pad 1; BatchNorm eps=1e-5
momentum=0.1; LeakyReLU(0.01); MaxPool2d 2x2; weights and biases from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default, see registry.init_model).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn


class SeededDropout(nn.Dropout):
    """``nn.Dropout`` whose train-mode mask is drawn from ``generator`` when
    one is set, not from the device's default generator.

    The train step re-seeds that generator per (seed, global step,
    microbatch), so a dropout mask is a function of the step, like the JAX
    package's ``fold_in(root_key, global_step)``, and a resumed run draws the
    masks of the run it continues. Same ``state_dict`` (none) and ``repr``
    as ``nn.Dropout``."""

    generator: Optional[torch.Generator] = None

    def _get_name(self) -> str:
        return "Dropout"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0 or self.generator is None:
            return super().forward(x)
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=self.generator)
        return x * keep * (1.0 / (1.0 - self.p))


def conv_block(cin: int, cout: int, *, slope: float = 0.01, eps: float = 1e-5,
               momentum: float = 0.1, device=None) -> List[nn.Module]:
    """Conv3x3(SAME) -> BatchNorm2d -> LeakyReLU -> MaxPool 2x2
    (regression_model.py:14-27, two_branch_regression.py:8-32)."""
    return [
        nn.Conv2d(cin, cout, kernel_size=3, stride=1, padding=1, device=device),
        nn.BatchNorm2d(cout, eps=eps, momentum=momentum, device=device),
        nn.LeakyReLU(slope),
        nn.MaxPool2d(2, 2),
    ]


def dense_bn_block(fin: int, fout: int, dropout: float, *, slope: float = 0.01,
                   eps: float = 1e-5, momentum: float = 0.1,
                   device=None) -> List[nn.Module]:
    """Linear -> BatchNorm1d -> LeakyReLU -> Dropout, the regression-head
    unit (regression_model.py:36-44, two_branch_regression.py:42-50)."""
    return [
        nn.Linear(fin, fout, device=device),
        nn.BatchNorm1d(fout, eps=eps, momentum=momentum, device=device),
        nn.LeakyReLU(slope),
        SeededDropout(dropout),
    ]


def output_dense(fin: int, device=None) -> nn.Linear:
    """Final scalar-regression Linear layer."""
    return nn.Linear(fin, 1, device=device)


def head_layers(flat: int, dropout: float, *, slope: float = 0.01,
                eps: float = 1e-5, momentum: float = 0.1,
                device=None) -> List[nn.Module]:
    """Flatten -> DenseBN(512) -> DenseBN(128) -> Linear(1): the head items
    at Sequential indices 0-9 of both models."""
    kw = dict(slope=slope, eps=eps, momentum=momentum, device=device)
    return [
        nn.Flatten(),
        *dense_bn_block(flat, 512, dropout, **kw),
        *dense_bn_block(512, 128, dropout, **kw),
        output_dense(128, device=device),
    ]
