"""``models/layers.ChunkedBatchNorm2d`` on the CPU.

It is ``nn.BatchNorm2d`` here bit for bit: only a channels-last CUDA input
past torch's int32 limit takes ``ChunkedBatchNormFn``. That function's
backward is held in float64 against autograd of ``F.batch_norm``, with the
limit patched small and torch's two CUDA primitives
(``torch.batch_norm_backward_reduce``, ``torch.batch_norm_backward_elemt``)
replaced by the plain-PyTorch twins below. Which layers engage is read on
fake CUDA tensors of the real shapes, which hold no storage. The card tests
(tests/test_torch_port_cuda.py) run the primitives themselves.
"""

import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode

from crosstalk_tpu_torch.config import ModelConfig
from crosstalk_tpu_torch.models import layers
from crosstalk_tpu_torch.models.layers import ChunkedBatchNorm2d, ChunkedBatchNormFn
from crosstalk_tpu_torch.models.registry import build_model


def _per_channel(t):
    return t.view(1, -1, 1, 1)


def plain_backward_reduce(dy, x, mean, invstd, weight, input_g, weight_g, bias_g):
    """``torch.batch_norm_backward_reduce``: per channel, the sum of ``dy``
    and of ``dy * (x - mean)``, and the affine's gradients from them."""
    sum_dy = dy.sum((0, 2, 3))
    sum_dy_xmu = (dy * (x - _per_channel(mean))).sum((0, 2, 3))
    return sum_dy, sum_dy_xmu, sum_dy_xmu * invstd, sum_dy


def plain_backward_elemt(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count):
    """``torch.batch_norm_backward_elemt``: the input's gradient from the
    sums over the ``count.sum()`` values of each channel."""
    n = count.sum().to(dy.dtype)
    xmu = x - _per_channel(mean)
    return ((dy - _per_channel(sum_dy / n) - xmu * _per_channel(invstd.square() * sum_dy_xmu / n))
            * _per_channel(invstd * weight))


def _pair(c, gen, dtype=torch.float32):
    """A ``ChunkedBatchNorm2d`` and an ``nn.BatchNorm2d`` with the same
    affine and running statistics, off their init values."""
    plain = nn.BatchNorm2d(c, dtype=dtype)
    with torch.no_grad():
        plain.weight.copy_(torch.rand(c, generator=gen) + 0.5)
        plain.bias.copy_(torch.randn(c, generator=gen))
        plain.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
        plain.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    bn = ChunkedBatchNorm2d(c, dtype=dtype)
    bn.load_state_dict(plain.state_dict())
    return bn, plain


def test_it_has_the_repr_and_state_dict_of_nn_batchnorm2d_and_the_models_build_it():
    bn, plain = ChunkedBatchNorm2d(8, eps=1e-5, momentum=0.1), nn.BatchNorm2d(8, eps=1e-5, momentum=0.1)
    assert isinstance(bn, nn.BatchNorm2d)
    assert repr(bn) == repr(plain) and repr(bn).startswith("BatchNorm2d(8, eps=1e-05")
    assert list(bn.state_dict()) == list(plain.state_dict())
    for variant in ("single", "double"):
        model = build_model(ModelConfig(variant=variant), device="meta")
        bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
        assert bns and all(type(m) is ChunkedBatchNorm2d for m in bns)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("layout", [torch.channels_last, torch.contiguous_format],
                         ids=["channels_last", "nchw"])
@pytest.mark.parametrize("limit", [2**31 - 1, 64], ids=["below_limit", "past_patched_limit"])
def test_on_the_cpu_it_is_nn_batchnorm2d_bit_for_bit(monkeypatch, training, layout, limit):
    """Forward, running statistics and gradients equal ``nn.BatchNorm2d``'s
    bit for bit; the chunked path stays out even past a patched limit."""
    monkeypatch.setattr(layers, "_INT32_NUMEL", limit)
    gen = torch.Generator().manual_seed(0)
    bn, plain = _pair(6, gen)
    x = (torch.randn(5, 6, 4, 4, generator=gen) * 2 + 1).contiguous(memory_format=layout)
    dy = torch.randn(5, 6, 4, 4, generator=gen)
    before = ChunkedBatchNormFn.engaged
    got = {}
    for name, m in (("chunked", bn), ("plain", plain)):
        m.train(training)
        leaf = x.clone().requires_grad_()
        out = m(leaf)
        out.backward(dy)
        got[name] = [out, leaf.grad, m.weight.grad, m.bias.grad, *m.state_dict().values()]
    assert ChunkedBatchNormFn.engaged == before
    for a, b in zip(got["chunked"], got["plain"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows,max_rows,chunks", [
    (6, 3, [3, 3]),     # two even chunks
    (6, 2, [2, 2, 2]),  # three
    (7, 3, [3, 2, 2]),  # uneven
    (5, 4, [3, 2]),     # the fewest chunks, near-equal: not 4 + 1
])
def test_chunked_backward_with_plain_primitives_is_the_float64_gradient(
        monkeypatch, rows, max_rows, chunks):
    """The limit patched so that ``max_rows`` rows of 3 x 4 x 4 fit under it:
    output and running statistics equal ``F.batch_norm``'s bit for bit, the
    gradients of input, weight and bias equal autograd's to 1e-12 of each
    leaf's largest, ``grad_input`` is channels-last, and the backward counts
    once in ``ChunkedBatchNormFn.engaged``."""
    per_row = 3 * 4 * 4
    monkeypatch.setattr(layers, "_INT32_NUMEL", max_rows * per_row + 1)
    seen = []

    def reduce(dy, x, *args):
        assert dy.is_contiguous(memory_format=torch.channels_last)
        assert x.is_contiguous(memory_format=torch.channels_last)
        seen.append(x.shape[0])
        return plain_backward_reduce(dy, x, *args)

    monkeypatch.setattr(torch, "batch_norm_backward_reduce", reduce)
    monkeypatch.setattr(torch, "batch_norm_backward_elemt", plain_backward_elemt)
    gen = torch.Generator().manual_seed(rows + max_rows)
    f64 = torch.float64
    x = (torch.randn(rows, 4, 4, 3, dtype=f64, generator=gen) * 2 + 1).permute(0, 3, 1, 2)
    weight = torch.rand(3, dtype=f64, generator=gen) + 0.5
    bias = torch.randn(3, dtype=f64, generator=gen)
    dy = torch.randn(rows, 4, 4, 3, dtype=f64, generator=gen).permute(0, 3, 1, 2)
    running = torch.randn(3, dtype=f64, generator=gen) * 0.1, torch.rand(3, dtype=f64, generator=gen) + 0.5
    stats = {"chunked": running, "autograd": tuple(t.clone() for t in running)}

    leaves = [t.clone().requires_grad_() for t in (x, weight, bias)]
    before = ChunkedBatchNormFn.engaged
    out = ChunkedBatchNormFn.apply(*leaves, *stats["chunked"], 0.1, 1e-5)
    got = torch.autograd.grad(out, leaves, dy)
    assert ChunkedBatchNormFn.engaged == before + 1
    assert seen == chunks

    ref = [t.clone().requires_grad_() for t in (x, weight, bias)]
    want_out = F.batch_norm(ref[0], *stats["autograd"], ref[1], ref[2], training=True,
                            momentum=0.1, eps=1e-5)
    want = torch.autograd.grad(want_out, ref, dy)
    assert torch.equal(out, want_out)
    for a, b in zip(stats["chunked"], stats["autograd"]):
        assert torch.equal(a, b)
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12 * float(w.abs().max()))


def _engaged_layers(variant, batch, training=True, device="cuda", layout=torch.channels_last):
    """Names of the model's BatchNorm2d layers whose bf16 train-step input,
    at ``batch`` 256-px tiles, would take ``ChunkedBatchNormFn``. Block k of
    a branch sees (batch, C, 256 >> k, 256 >> k): each block pools 2 x 2."""
    model = build_model(ModelConfig(variant=variant), device="meta").train(training)
    hits = []
    with FakeTensorMode():
        for name, bn in model.named_modules():
            if isinstance(bn, nn.BatchNorm2d):
                side = 256 >> int(name.rsplit(".", 1)[1]) // 4  # 4 modules a block
                x = torch.empty(batch, bn.num_features, side, side, dtype=torch.bfloat16,
                                device=device, memory_format=layout)
                if bn._chunked(x):
                    hits.append(name)
    return hits


@pytest.mark.parametrize("variant,batch,engaged", [
    ("single", 256, ["conv_layers.1"]),  # 256 x 128 x 256 x 256 = 2**31
    ("double", 512, ["bleed_branch.conv_blocks.1", "source_branch.conv_blocks.1"]),
    ("single", 255, []),
    ("double", 256, []),                 # 256 x 64 x 256 x 256 = 2**30 a branch
])
def test_only_block_0_engages_and_only_past_int32(variant, batch, engaged):
    assert _engaged_layers(variant, batch) == engaged


@pytest.mark.parametrize("case", [dict(training=False), dict(device="cpu"),
                                  dict(layout=torch.contiguous_format)],
                         ids=["eval", "cpu", "nchw"])
def test_eval_mode_the_cpu_and_nchw_do_not_engage(case):
    assert _engaged_layers("single", 256, **case) == []
