"""Building blocks of the two regressors (port of crosstalk_tpu/models/layers.py).

Each builder returns the reference's ``nn.Sequential`` items in order, so the
modules' state_dict keys are the reference's (conv_layers.{4k}, ...; see
tests/torch_ref.py) and a ``.pth`` loads natively. Layout is NCHW.

Reference semantics: Conv2d 3x3 stride 1 pad 1; BatchNorm eps=1e-5
momentum=0.1; LeakyReLU(0.01); MaxPool2d 2x2; weights and biases from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default, see registry.init_model).

With a ``process_group`` the BatchNorms are cross-replica
(``CrossReplicaBatchNorm2d``/``1d``), the JAX package's
``BatchNorm(axis_name='data')``; without one they are ``nn.BatchNorm2d`` and
``OneRowBatchNorm1d`` (``nn.BatchNorm1d`` that also trains on one row).
"""

from __future__ import annotations

import warnings
from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, with a backward that
    sums the gradient over them (newer torch warns that this function moves
    to ``_functional_collectives``; its replacement is private)."""
    from torch.distributed.nn.functional import all_reduce

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(t, group=group)


class _CrossReplicaBatchNorm:
    """Train-mode BatchNorm whose statistics span every rank of
    ``process_group`` (crosstalk_tpu/models/layers.py:92-114).

    Each rank takes the mean and biased variance of its own rows (in f32,
    or in f64 for f64 input); autograd all-reduces
    (``torch.distributed.nn.functional.all_reduce``, whose backward
    all-reduces the gradient) give the global mean, then the global sum of
    squared deviations from it; the biased variance normalizes and the
    unbiased one enters the running statistics, as torch's BatchNorm does.
    N ranks thus equal one rank on the concatenated batch. In eval mode, or
    without a group, it is the parent class. Same ``state_dict`` and
    ``repr`` as the parent, so model_architecture.txt does not change.
    ``nn.SyncBatchNorm`` is not used: it refuses CPU tensors, on which the
    tests hold this against the JAX package."""

    process_group: Optional[dist.ProcessGroup] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.process_group is None:
            return super().forward(x)
        return _train_forward(self, x, lambda t: _all_reduce(t, self.process_group))


def _train_forward(bn, x: torch.Tensor, reduce) -> torch.Tensor:
    """Train-mode BatchNorm of ``bn`` over the rows that ``reduce`` (a sum
    over ranks, or the identity) gathers; updates its running statistics."""
    bn._check_input_dim(x)
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    c = x.shape[1]
    # this rank's mean and biased variance (Welford), then the global
    # mean and the global sum of squared deviations, one all-reduce
    # each: a float32 sum of squares over hundreds of thousands of
    # values per channel loses the variance to cancellation
    var_r, mean_r = torch.var_mean(xf, dim=dims, unbiased=False)
    n_r = x.numel() // c
    count = torch.full((1,), n_r, dtype=xf.dtype, device=x.device)
    sums = reduce(torch.cat([mean_r * n_r, count]))
    n = sums[c]
    mean = sums[:c] / n
    m2 = reduce(n_r * (var_r + (mean_r - mean).square()))
    var = m2 / n
    with torch.no_grad():
        unbiased = var * (n / torch.clamp(n - 1, min=1.0))
        bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
        bn.running_var.mul_(1 - bn.momentum).add_(bn.momentum * unbiased)
        bn.num_batches_tracked.add_(1)
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean.view(shape)) * inv.view(shape) + bn.bias.view(shape)
    return y.to(x.dtype)


class CrossReplicaBatchNorm2d(_CrossReplicaBatchNorm, nn.BatchNorm2d):
    def __init__(self, *args, process_group=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.process_group = process_group

    def _get_name(self) -> str:
        return "BatchNorm2d"


class CrossReplicaBatchNorm1d(_CrossReplicaBatchNorm, nn.BatchNorm1d):
    def __init__(self, *args, process_group=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.process_group = process_group

    def _get_name(self) -> str:
        return "BatchNorm1d"


class OneRowBatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` that also trains on a batch of one row, as the JAX
    package's BatchNorm does (crosstalk_tpu/models/layers.py:104-114): the
    batch variance is 0, so every output is the layer's bias, and the
    running variance takes the unbiased variance with its divisor held at
    1. torch's layer refuses such a batch in train mode. Same
    ``state_dict`` and ``repr`` as ``nn.BatchNorm1d``."""

    def _get_name(self) -> str:
        return "BatchNorm1d"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and x.shape[0] == 1:
            return _train_forward(self, x, lambda t: t)
        return super().forward(x)


def _batch_norm(dims: int, features: int, process_group, **kw) -> nn.Module:
    if process_group is None:
        return (nn.BatchNorm2d if dims == 2 else OneRowBatchNorm1d)(features, **kw)
    cls = CrossReplicaBatchNorm2d if dims == 2 else CrossReplicaBatchNorm1d
    return cls(features, process_group=process_group, **kw)


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
               momentum: float = 0.1, device=None, process_group=None) -> List[nn.Module]:
    """Conv3x3(SAME) -> BatchNorm2d -> LeakyReLU -> MaxPool 2x2
    (regression_model.py:14-27, two_branch_regression.py:8-32)."""
    return [
        nn.Conv2d(cin, cout, kernel_size=3, stride=1, padding=1, device=device),
        _batch_norm(2, cout, process_group, eps=eps, momentum=momentum, device=device),
        nn.LeakyReLU(slope),
        nn.MaxPool2d(2, 2),
    ]


def dense_bn_block(fin: int, fout: int, dropout: float, *, slope: float = 0.01,
                   eps: float = 1e-5, momentum: float = 0.1,
                   device=None, process_group=None) -> List[nn.Module]:
    """Linear -> BatchNorm1d -> LeakyReLU -> Dropout, the regression-head
    unit (regression_model.py:36-44, two_branch_regression.py:42-50)."""
    return [
        nn.Linear(fin, fout, device=device),
        _batch_norm(1, fout, process_group, eps=eps, momentum=momentum, device=device),
        nn.LeakyReLU(slope),
        SeededDropout(dropout),
    ]


def output_dense(fin: int, device=None) -> nn.Linear:
    """Final scalar-regression Linear layer."""
    return nn.Linear(fin, 1, device=device)


def head_layers(flat: int, dropout: float, *, slope: float = 0.01,
                eps: float = 1e-5, momentum: float = 0.1,
                device=None, process_group=None) -> List[nn.Module]:
    """Flatten -> DenseBN(512) -> DenseBN(128) -> Linear(1): the head items
    at Sequential indices 0-9 of both models."""
    kw = dict(slope=slope, eps=eps, momentum=momentum, device=device,
              process_group=process_group)
    return [
        nn.Flatten(),
        *dense_bn_block(flat, 512, dropout, **kw),
        *dense_bn_block(512, 128, dropout, **kw),
        output_dense(128, device=device),
    ]
