"""``ops/leaky_pool.py`` and ``models/layers.ConvBlocks`` on the CPU.

The plain versions of the LeakyReLU + 2x2 max-pool kernels are held bit
for bit (NaN as NaN) against autograd of torch's ``F.leaky_relu`` ->
``F.max_pool2d`` chain on channels-last inputs, in bf16 and f32, for the
output and the gradient: on inputs drawn from a few values, so that ties
are common, with -0, +-inf, NaN and subnormals among them, and with
negative values whose LeakyReLU rounds to one bf16, so that LeakyReLU makes
ties the input did not have. ``ConvBlocks`` takes the kernels only in
training, with grad enabled, on inputs they take (CUDA); here, with that
test patched to accept CPU tensors, the models' train step through
``LeakyPoolFn`` equals the one through ``nn.LeakyReLU`` and ``nn.MaxPool2d``
bit for bit. The card tests (tests/test_torch_port_cuda.py) hold the
kernels against torch's CUDA chain.
"""

import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode

from crosstalk_tpu_torch.config import ModelConfig
from crosstalk_tpu_torch.models.layers import ConvBlocks
from crosstalk_tpu_torch.models.registry import build_model, init_model
from crosstalk_tpu_torch.ops import leaky_pool
from crosstalk_tpu_torch.ops.leaky_pool import (
    LeakyPoolFn,
    leaky_pool_backward_reference,
    leaky_pool_forward_reference,
)

SLOPE = 0.01
INF, NAN = float("inf"), float("nan")


def leaky_ties(slope=SLOPE):
    """Pairs of distinct negative bf16 values in [-2, -1] whose LeakyReLU
    rounds to one bf16 value."""
    x = torch.arange(-2.0, -1.0, 2.0 ** -7).to(torch.bfloat16)
    y = (x.float() * slope).to(torch.bfloat16).float()
    same = (y[1:] == y[:-1]).nonzero()[:, 0]
    return [(float(x[i]), float(x[i + 1])) for i in same]


def tie_heavy_values():
    """A few values: zeros of both signs, +-inf, NaN, subnormals (of f32 and
    bf16), repeats, and two LeakyReLU ties."""
    (a, b), (c, d) = leaky_ties()[:2]
    return torch.tensor([0.0, -0.0, 1.0, 2.0, 1.0, -1.0, -2.0, 0.5, -0.5, INF, -INF, NAN,
                         1e-40, -1e-40, a, b, c, d])


def draw(shape, dtype, gen, values=None):
    """(N, C, H, W) channels-last: from ``values`` where given, else randn."""
    n, c, h, w = shape
    if values is None:
        t = torch.randn(n, h, w, c, generator=gen)
    else:
        t = values[torch.randint(len(values), (n, h, w, c), generator=gen)]
    return t.to(dtype).permute(0, 3, 1, 2)


def torch_chain(x, g, slope=SLOPE):
    """-> (output, grad_x) of autograd of ``F.leaky_relu`` -> ``F.max_pool2d``."""
    leaf = x.detach().clone().requires_grad_()
    out = F.max_pool2d(F.leaky_relu(leaf, slope), 2, 2)
    out.backward(g)
    return out.detach(), leaf.grad


def assert_same_bits(got, want):
    """Same shape, dtype and NaN positions, and every other element equal
    bit for bit (so -0 differs from +0)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[want.dtype]
    assert torch.equal(got.contiguous().view(bits)[~nan.contiguous()],
                       want.contiguous().view(bits)[~nan.contiguous()])


def test_the_tie_values_tie_only_after_leaky_relu():
    pairs = leaky_ties()
    assert len(pairs) >= 2
    for a, b in pairs:
        assert a != b
        assert torch.tensor(a * SLOPE).bfloat16() == torch.tensor(b * SLOPE).bfloat16()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("inputs", ["ties", "randn"])
@pytest.mark.parametrize("shape", [(3, 16, 6, 8), (2, 8, 2, 2), (1, 40, 10, 4), (2, 3, 4, 6)])
def test_plain_versions_equal_torch_chain_bit_for_bit(dtype, inputs, shape):
    gen = torch.Generator().manual_seed(sum(shape))
    values = tie_heavy_values() if inputs == "ties" else None
    x = draw(shape, dtype, gen, values)
    n, c, h, w = shape
    g = draw((n, c, h // 2, w // 2), dtype, gen, torch.tensor([-0.0, 0.0, 1.5, -2.0, 3.0, 1e-3])
              if inputs == "ties" else None)
    want_out, want_grad = torch_chain(x, g)
    got_out = leaky_pool_forward_reference(x, SLOPE)
    got_grad = leaky_pool_backward_reference(x, g, SLOPE)
    assert_same_bits(got_out, want_out)
    assert_same_bits(got_grad, want_grad)
    assert got_out.is_contiguous(memory_format=torch.channels_last)
    assert got_grad.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_every_window_order_of_special_values(dtype):
    """Every window of four drawn from {-inf, -1, NaN, a LeakyReLU tie pair,
    -0, 0} in every order: the first maximum and the last NaN win, a
    window of -inf alone routes to its first element, as torch's CPU chain
    does; -0 gradients arrive as +0."""
    (a, b), _ = leaky_ties()[:2]
    vals = torch.tensor([-INF, -1.0, NAN, a, b, -0.0, 0.0])
    grid = torch.cartesian_prod(*[torch.arange(len(vals))] * 4)  # (7**4, 4)
    x = vals[grid].view(-1, 1, 2, 2).to(dtype)  # one window per image
    x = x.expand(-1, 8, 2, 2).contiguous(memory_format=torch.channels_last)
    g = torch.tensor([1.0, -0.0, -3.0, 2.0]).repeat(len(grid) // 4 + 1)[:len(grid)]
    g = g.view(-1, 1, 1, 1).expand(-1, 8, 1, 1).to(dtype).contiguous(memory_format=torch.channels_last)
    want_out, want_grad = torch_chain(x, g)
    assert_same_bits(leaky_pool_forward_reference(x, SLOPE), want_out)
    assert_same_bits(leaky_pool_backward_reference(x, g, SLOPE), want_grad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_fn_on_the_cpu_runs_the_plain_versions_and_launches_nothing(dtype):
    gen = torch.Generator().manual_seed(5)
    x = draw((2, 16, 8, 8), dtype, gen, tie_heavy_values())
    g = draw((2, 16, 4, 4), dtype, gen)
    want_out, want_grad = torch_chain(x, g)
    before = leaky_pool.leaky_pool_forward.launches, leaky_pool.leaky_pool_backward.launches
    leaf = x.clone().requires_grad_()
    out = LeakyPoolFn.apply(leaf, SLOPE)
    out.backward(g)
    assert (leaky_pool.leaky_pool_forward.launches, leaky_pool.leaky_pool_backward.launches) == before
    assert_same_bits(out.detach(), want_out)
    assert_same_bits(leaf.grad, want_grad)


def test_only_the_input_is_saved_for_backward():
    x = torch.randn(2, 8, 4, 4).contiguous(memory_format=torch.channels_last).requires_grad_()
    out = LeakyPoolFn.apply(x, SLOPE)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].data_ptr() == x.data_ptr()


def _model_blocks(variant):
    model = build_model(ModelConfig(variant=variant), device="meta")
    return ([model.conv_layers] if variant == "single"
            else [model.bleed_branch.conv_blocks, model.source_branch.conv_blocks])


@pytest.mark.parametrize("variant", ["single", "double"])
def test_conv_blocks_keep_the_sequential_items_keys_and_repr(variant):
    model = build_model(ModelConfig(variant=variant), device="meta")
    for blocks in _model_blocks(variant):
        assert type(blocks) is ConvBlocks
        plain = nn.Sequential(*blocks)
        assert repr(blocks) == repr(plain) and repr(blocks).startswith("Sequential(")
        assert list(blocks.state_dict()) == list(plain.state_dict())
        assert [type(m) for m in blocks][:4] == [nn.Conv2d, type(blocks[1]), nn.LeakyReLU,
                                                 nn.MaxPool2d]
    keys = list(model.state_dict())
    prefix = "conv_layers" if variant == "single" else "bleed_branch.conv_blocks"
    assert f"{prefix}.0.weight" in keys and f"{prefix}.1.running_var" in keys
    assert f"{prefix}.4.weight" in keys
    assert "Sequential(" in str(model) and "ConvBlocks" not in str(model)


def _block_inputs(variant, batch, dtype, layout):
    """Fake CUDA tensors of each block's BatchNorm output at ``batch``
    256-px tiles (no storage)."""
    shapes = []
    for blocks in _model_blocks(variant):
        side = 256
        for bn in list(blocks)[1::4]:
            shapes.append((batch, bn.num_features, side, side))
            side //= 2
    with FakeTensorMode():
        return [torch.empty(s, dtype=dtype, device="cuda", memory_format=layout)
                for s in shapes]


@pytest.mark.parametrize("variant,blocks", [("single", 6), ("double", 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_kernels_take_every_block_of_the_train_step_at_batch_256(variant, blocks, dtype):
    xs = _block_inputs(variant, 256, dtype, torch.channels_last)
    assert len(xs) == blocks and all(leaky_pool.takes(x) for x in xs)


@pytest.mark.parametrize("case", ["nchw", "f16", "odd", "narrow", "cpu", "offset"])
def test_the_kernels_do_not_take(case):
    layout, dtype = torch.channels_last, torch.bfloat16
    if case == "nchw":
        layout = torch.contiguous_format
    if case == "f16":
        dtype = torch.float16
    with FakeTensorMode():
        shape = {"odd": (2, 16, 6, 5), "narrow": (2, 4, 6, 6)}.get(case, (2, 16, 6, 6))
        x = torch.empty(shape, dtype=dtype, device="cuda", memory_format=layout)
        if case == "offset":  # the same layout from the storage's second element on
            x = torch.empty(2 * 16 * 36 + 1, dtype=dtype, device="cuda").as_strided(
                shape, x.stride(), 1)
    if case == "cpu":
        x = torch.empty(shape, dtype=dtype, memory_format=layout)
    assert not leaky_pool.takes(x)


def _small_state(variant):
    from crosstalk_tpu_torch.config import OptimConfig
    from crosstalk_tpu_torch.train.steps import init_train_state

    kw = (dict(initial_filters=8, num_conv_blocks=3, dropout_single=0.0)
          if variant == "single" else dict(initial_filters_per_branch=8, dropout_double=0.0))
    model = build_model(ModelConfig(variant=variant, **kw), image_size=32)
    init_model(model, torch.Generator().manual_seed(3))
    return init_train_state(model, OptimConfig())


def _two_steps(variant, compute_dtype):
    """Two train steps of a small model on the CPU: losses, gradients and
    state after them."""
    from crosstalk_tpu_torch.train.steps import make_train_step

    state = _small_state(variant)
    step = make_train_step(state, compute_dtype=compute_dtype, seed=5)
    gen = torch.Generator().manual_seed(11)
    losses = []
    for _ in range(2):
        raw = torch.rand(4, 32, 32, 2, generator=gen) * 1000 + 100
        labels = torch.rand(4, 1, generator=gen) * 0.5
        losses.append(step(raw, labels, 1e-3))
    grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
    return losses, grads, {k: v.clone() for k, v in state.model.state_dict().items()}


@pytest.mark.parametrize("variant,blocks", [("single", 3), ("double", 8)])
@pytest.mark.parametrize("compute_dtype", ["bf16", "f32"])
def test_train_step_through_the_fused_function_is_bitwise_the_module_path(
        monkeypatch, variant, blocks, compute_dtype):
    """With ``takes`` patched to accept CPU tensors, the train step runs
    every block through ``LeakyPoolFn`` (its plain versions here) and its
    losses, gradients and state equal the step through the modules."""
    want = _two_steps(variant, compute_dtype)
    calls = []
    apply = LeakyPoolFn.apply

    def counted(x, slope):
        calls.append(slope)
        return apply(x, slope)

    monkeypatch.setattr(leaky_pool, "takes", lambda x: x.dim() == 4)
    monkeypatch.setattr(LeakyPoolFn, "apply", counted)
    got = _two_steps(variant, compute_dtype)
    assert calls == [SLOPE] * (2 * blocks)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert list(g) == list(w) and all(torch.equal(g[k], w[k]) for k in w)


@pytest.mark.parametrize("variant", ["single", "double"])
def test_the_cpu_eval_mode_and_no_grad_never_take_the_fused_path(monkeypatch, variant):
    """Unpatched on the CPU (train and eval), and patched to accept CPU
    tensors but in eval mode or under no_grad: no block calls LeakyPoolFn."""
    def refuse(*args):
        raise AssertionError("LeakyPoolFn taken")

    monkeypatch.setattr(LeakyPoolFn, "apply", refuse)
    _two_steps(variant, "bf16")
    model = _small_state(variant).model
    x = torch.rand(2, 2, 32, 32)
    model.eval()(x)
    monkeypatch.setattr(leaky_pool, "takes", lambda x: True)
    model.eval()(x)
    with torch.no_grad():
        model.train()(x)
