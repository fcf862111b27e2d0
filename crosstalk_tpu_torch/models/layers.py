"""Building blocks of the two regressors (port of crosstalk_tpu/models/layers.py).

Each builder returns the reference's ``nn.Sequential`` items in order, so the
modules' state_dict keys are the reference's (conv_layers.{4k}, ...; see
tests/torch_ref.py) and a ``.pth`` loads natively. Layout is NCHW.

Reference semantics: Conv2d 3x3 stride 1 pad 1; BatchNorm eps=1e-5
momentum=0.1; LeakyReLU(0.01); MaxPool2d 2x2; weights and biases from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default, see registry.init_model).

With a ``process_group`` the BatchNorms are cross-replica
(``CrossReplicaBatchNorm2d``/``1d``), the JAX package's
``BatchNorm(axis_name='data')``; without one they are ``ChunkedBatchNorm2d``
(``nn.BatchNorm2d``, whose train-mode backward on the card reduces over batch
chunks where the input is too large for torch's 32-bit channels-last
kernels) and ``OneRowBatchNorm1d`` (``nn.BatchNorm1d`` that also trains on
one row).

The models hold their conv blocks in ``ConvBlocks`` (an ``nn.Sequential``
by ``repr`` and keys), which in the train step on the card runs each
block's LeakyReLU and 2x2 max pool as ``ops/leaky_pool.LeakyPoolFn``: the
hand-written kernels of ``csrc/leaky_pool.cu``, forward and backward, with
no index tensor and torch's results bit for bit.
"""

from __future__ import annotations

import threading
import warnings
from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.autograd.function import once_differentiable

from crosstalk_tpu_torch.ops import leaky_pool


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


# torch's channels-last BatchNorm kernels index with int32 (``const int
# reduction_size``, ATen/native/cuda/Normalization.cuh) and are dispatched
# only where ``canUse32BitIndexMath`` holds: on an input of this many
# elements or more the backward reduce falls back to the int64 NCHW
# template, whose neighbouring threads read channels-last memory C
# elements apart
_INT32_NUMEL = 2**31 - 1
_engaged_lock = threading.Lock()


def _row_chunks(t: torch.Tensor):
    """``t`` split along the batch into the fewest near-equal row chunks of
    fewer than ``_INT32_NUMEL`` elements each (views of a channels-last
    ``t``)."""
    rows = (_INT32_NUMEL - 1) // (t.numel() // t.shape[0])
    return torch.tensor_split(t, -(-t.shape[0] // rows))


class ChunkedBatchNormFn(torch.autograd.Function):
    """Train-mode BatchNorm2d whose backward reduces over batch chunks.

    The forward is ``torch.native_batch_norm``, as ``nn.BatchNorm2d``
    calls it, so the output and the running statistics are the module's.
    The backward is the one ``nn.SyncBatchNorm`` builds from two primitives,
    with row chunks in place of ranks: ``torch.batch_norm_backward_reduce``
    per chunk, the chunks' sums added, then ``torch.batch_norm_backward_elemt``
    per chunk with the whole batch's sums and count, each chunk's gradient
    copied into one channels-last ``grad_input``. Every chunk is small
    enough for torch's channels-last kernels. ``engaged`` counts the
    backward calls."""

    engaged = 0

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum: float,
                eps: float):
        out, mean, invstd = torch.native_batch_norm(
            x, weight, bias, running_mean, running_var, True, momentum, eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, weight, mean, invstd = ctx.saved_tensors
        dys = _row_chunks(grad_out.contiguous(memory_format=torch.channels_last))
        xs = _row_chunks(x)
        parts = [torch.batch_norm_backward_reduce(dy, xc, mean, invstd, weight, True, True, True)
                 for dy, xc in zip(dys, xs)]
        sum_dy, sum_dy_xmu, grad_weight, grad_bias = (sum(p[1:], p[0]) for p in zip(*parts))
        grad_input = None
        if ctx.needs_input_grad[0]:
            count = torch.full((1,), x.numel() // x.shape[1], dtype=torch.int32,
                               device=x.device)
            grad_input = torch.empty_like(x)
            for dy, xc, g in zip(dys, xs, _row_chunks(grad_input)):
                g.copy_(torch.batch_norm_backward_elemt(
                    dy, xc, mean, invstd, weight, sum_dy, sum_dy_xmu, count))
        with _engaged_lock:  # autograd runs backward on its own threads
            ChunkedBatchNormFn.engaged += 1
        return grad_input, grad_weight, grad_bias, None, None, None, None


class ChunkedBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode backward runs through
    ``ChunkedBatchNormFn`` where torch's own would leave its channels-last
    kernels: on a channels-last CUDA input of ``_INT32_NUMEL`` elements or
    more (the single-branch block 0 at batch 256 and up, the two-branch
    one at 512 and up). Anything else is ``nn.BatchNorm2d.forward``. Same
    ``repr`` and ``state_dict`` as ``nn.BatchNorm2d``."""

    def _get_name(self) -> str:
        return "BatchNorm2d"

    def _chunked(self, x: torch.Tensor) -> bool:
        """Whether ``x`` takes ``ChunkedBatchNormFn``: in training, a
        channels-last CUDA input past torch's int32 limit, of which one row
        and the count of one channel's values stay under it."""
        return (self.training and self.affine and self.track_running_stats
                and x.is_cuda and x.is_contiguous(memory_format=torch.channels_last)
                and x.numel() >= _INT32_NUMEL
                and max(x.numel() // x.shape[0], x.numel() // x.shape[1]) < _INT32_NUMEL)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self._chunked(x):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        momentum = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                    else self.momentum)
        return ChunkedBatchNormFn.apply(x, self.weight, self.bias, self.running_mean,
                                        self.running_var, momentum, self.eps)


def _batch_norm(dims: int, features: int, process_group, **kw) -> nn.Module:
    if process_group is None:
        return (ChunkedBatchNorm2d if dims == 2 else OneRowBatchNorm1d)(features, **kw)
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


class SeededDropPath(nn.Module):
    """The keep masks of stochastic depth for a stack of residual branches,
    one rate each: ``forward(rows)`` -> (branches, rows) float32, each row
    of a branch kept (1 / (1 - rate)) with probability ``1 - rate`` or
    dropped (0), in one draw: ``bernoulli_`` of a (branches, rows) tensor
    with the column of keep probabilities; None in eval mode or where every
    rate is 0. Drawn from ``generator`` when one is set (the train step's,
    as for ``SeededDropout``, so the masks are a function of the step),
    else from the device's default generator. Holds no state."""

    generator: Optional[torch.Generator] = None

    def __init__(self, rates, device=None):
        super().__init__()
        self.rates = [float(r) for r in rates]
        if device == "meta":
            device = None
        self.register_buffer("keep", torch.tensor([1.0 - r for r in self.rates],
                                                  device=device).view(-1, 1), persistent=False)

    def extra_repr(self) -> str:
        return f"branches={len(self.rates)}, max_rate={max(self.rates, default=0.0)}"

    def forward(self, rows: int) -> Optional[torch.Tensor]:
        if not self.training or not any(self.rates):
            return None
        masks = torch.empty((len(self.rates), rows), dtype=torch.float32,
                            device=self.keep.device)
        return masks.bernoulli_(self.keep, generator=self.generator).div_(self.keep)


class ConvBlocks(nn.Sequential):
    """The ``nn.Sequential`` of ``conv_block`` items, four a block, that
    runs each block's LeakyReLU and 2x2 max pool as ``LeakyPoolFn`` (one
    hand-written kernel each way, no index tensor; ``ops/leaky_pool.py``)
    where that applies: in training with grad enabled, on an input the
    kernels take (``leaky_pool.takes``: CUDA, bf16 or f32, channels-last,
    even H and W, whole 16-byte channel vectors). Anything else, eval mode
    (export, validation, prediction, serving) and the CPU included, runs
    the block's ``nn.LeakyReLU`` and ``nn.MaxPool2d``. Both give the same
    numbers bit for bit. Same items, ``state_dict`` and ``repr`` as
    ``nn.Sequential``."""

    def _get_name(self) -> str:
        return "Sequential"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        items = list(self._modules.values())
        fused = self.training and torch.is_grad_enabled()
        for conv, bn, act, pool in zip(*[iter(items)] * 4):
            x = bn(conv(x))
            if fused and leaky_pool.takes(x):
                x = leaky_pool.LeakyPoolFn.apply(x, act.negative_slope)
            else:
                x = pool(act(x))
        return x


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
