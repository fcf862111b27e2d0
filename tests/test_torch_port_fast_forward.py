"""The port's folded-BN bf16 forward against the JAX fast forward and the
torch golden model.

On the CPU block 0 goes through the plain version of the fused input block
(the wrapper's CPU path). Against the JAX fast forward the port is held to
5e-4 absolute (it was 5e-3 while the port's head rounded its products to
bf16): both heads now keep each bf16 x bf16 product in f32, so what is left
is the trunk's bf16 rounding in two conv libraries. Measured: 8.4e-5
single-branch and 5.7e-6 two-branch on the configs below, up to 2.7e-4
through the predictors on raw-intensity tiles
(tests/test_torch_port_serving.py). Against the torch golden the tolerances
are those of tests/test_fast_forward.py: 5e-3 absolute, MAE < 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crosstalk_tpu.config as jcfg
import crosstalk_tpu_torch.eval.fast_forward as ff
from crosstalk_tpu.eval.fast_forward import make_fast_forward as jax_fast_forward
from crosstalk_tpu.models import registry as jreg
from crosstalk_tpu_torch.config import ModelConfig
from crosstalk_tpu_torch.io.torch_convert import from_jax_variables
from crosstalk_tpu_torch.models.registry import build_model
from crosstalk_tpu_torch.ops.input_block import fused_input_block_packed
from tests.torch_ref import TorchDouble, TorchSingle, burn_in_batch_stats


@pytest.fixture
def count_k1_calls(monkeypatch):
    calls = {"n": 0}

    def counting(*a, **k):
        calls["n"] += 1
        return fused_input_block_packed(*a, **k)

    monkeypatch.setattr(ff, "fused_input_block_packed", counting)
    return calls


@pytest.mark.parametrize("variant", ["single", "double"])
def test_fast_forward_matches_jax_fast_forward(variant, count_k1_calls):
    """The configs of tests/test_fast_forward.py::test_fast_forward_matches_flax.
    At these widths the JAX gate sends block 0 to XLA (F % 128 != 0); the
    port's gate has no lane rule and runs the fused block."""
    kw = dict(variant=variant, initial_filters=8, num_conv_blocks=3,
              initial_filters_per_branch=4)
    size = 64
    model = jreg.build_model(jcfg.ModelConfig(compute_dtype="bf16", **kw))
    variables = jreg.init_model(model, jax.random.key(0), image_size=size)
    rng = np.random.default_rng(2)
    variables = {
        "params": variables["params"],
        "batch_stats": jax.tree.map(
            lambda a: a + jnp.asarray(rng.normal(0, 0.01, a.shape), a.dtype) ** 2,
            variables["batch_stats"],
        ),
    }
    x = rng.random((4, size, size, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jax_fast_forward(
        jcfg.ModelConfig(**kw), use_pallas=True, interpret=True))(variables, jnp.asarray(x)))

    sd = from_jax_variables(jax.tree.map(np.asarray, variables), variant)
    got = ff.make_fast_forward(ModelConfig(**kw), sd)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4, 1)
    assert count_k1_calls["n"] == 1
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)


@pytest.mark.parametrize("n_in,n_out", [(512, 128), (8192, 512)])
def test_dense_step_keeps_the_product_in_f32_as_jax_does(n_in, n_out):
    """The port's head step (bf16 x bf16 product, folded BN affine in f32,
    LeakyReLU) against JAX's ``_dense_bn_eval`` on the same bf16 inputs. A
    product rounded to bf16 before the affine (the port's head before this
    was repaired) misses by far more than the tolerance."""
    from crosstalk_tpu.eval.fast_forward import _dense_bn_eval as jax_dense
    from crosstalk_tpu_torch.ops.input_block import fold_bn_affine

    rng = np.random.default_rng(n_in)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x = jnp.asarray(f32(4, n_in), jnp.bfloat16).astype(jnp.float32)
    kernel = f32(n_in, n_out) / np.sqrt(n_in)
    bias, gamma, beta, mean = f32(n_out), f32(n_out), f32(n_out), f32(n_out)
    var = np.abs(f32(n_out)) + 0.5
    want = np.asarray(jax_dense(
        x, {"Dense_0": {"kernel": kernel, "bias": bias},
            "BatchNorm_0": {"scale": gamma, "bias": beta}},
        {"BatchNorm_0": {"mean": mean, "var": var}}, 1e-5, 0.01))

    t = torch.from_numpy
    scale, shift = fold_bn_affine(t(bias), t(gamma), t(beta), t(mean), t(var), 1e-5)
    dense = ff._Dense(t(kernel.T.copy()).to(torch.bfloat16), scale, shift)
    xt = t(np.array(x))
    got = ff._dense_bn_eval(xt, dense, 0.01).numpy()
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)

    rounded = torch.nn.functional.linear(xt.bfloat16(), dense.weight).float()
    old = torch.nn.functional.leaky_relu(rounded * scale + shift, 0.01).numpy()
    assert np.abs(old - want).max() > 10 * tol


def test_conv_block_matches_jax_bitwise_with_the_bf16_slope():
    """The bf16 conv block against JAX's ``_conv_block_eval``, bit for bit.
    Small-integer inputs and weights make the conv's sums exact in any
    order, so the epilogue decides: JAX's LeakyReLU multiplies by the slope
    rounded to bf16 (0.010009765625). The port's block multiplied by 0.01
    before this was repaired, which moved 7% of the bf16 outputs."""
    from crosstalk_tpu.eval.fast_forward import _conv_block_eval as jax_block

    rng = np.random.default_rng(7)
    x = rng.integers(-2, 3, (2, 12, 12, 8)).astype(np.float32)
    kernel = rng.integers(-2, 3, (3, 3, 8, 16)).astype(np.float32)
    scale = rng.normal(1, 0.3, 16).astype(np.float32)
    bias = rng.normal(0, 0.2, 16).astype(np.float32)
    want = np.asarray(jax_block(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(scale),
                                jnp.asarray(bias), 0.01).astype(jnp.float32))
    t = torch.from_numpy
    blk = ff._Conv(t(kernel).permute(3, 2, 0, 1).to(torch.bfloat16),
                   t(scale).to(torch.bfloat16).view(1, -1, 1, 1),
                   t(bias).to(torch.bfloat16).view(1, -1, 1, 1))
    got = ff._conv_block_eval(t(x).permute(0, 3, 1, 2), blk, 0.01)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(), want)
    assert ff.bf16_value(0.01) == 0.010009765625


def test_fast_forward_full_single_width_vs_torch_golden():
    """tests/test_fast_forward.py::test_fast_forward_full_config_torch_parity
    for the port: full single-branch width at 64 px."""
    torch.manual_seed(11)
    tmodel = burn_in_batch_stats(TorchSingle(image_size=64), 64)
    x = np.random.default_rng(3).random((4, 64, 64, 2)).astype(np.float32)
    with torch.no_grad():
        golden = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    fast = ff.make_fast_forward(ModelConfig(variant="single"), tmodel.state_dict())
    out = fast(torch.from_numpy(x)).numpy()
    assert np.abs(out - golden).mean() < 2e-3


def test_two_branch_block0_is_one_block_diagonal_call(count_k1_calls):
    """At the real two-branch width (64 filters per branch) both branches'
    block 0 is ONE fused call, and the forward matches the torch golden."""
    torch.manual_seed(7)
    tmodel = burn_in_batch_stats(TorchDouble(filters_per_branch=64, image_size=64), 64)
    x = np.random.default_rng(7).random((2, 64, 64, 2)).astype(np.float32)
    with torch.no_grad():
        golden = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    fast = ff.make_fast_forward(ModelConfig(variant="double"), tmodel.state_dict())
    out = fast(torch.from_numpy(x)).numpy()
    assert count_k1_calls["n"] == 1
    np.testing.assert_allclose(out, golden, atol=5e-3, rtol=0)


@pytest.mark.parametrize("variant", ["single", "double"])
@pytest.mark.parametrize("size,k1_calls", [(90, 1), (45, 0)])
def test_gate_keeps_only_the_semantic_conditions(variant, size, k1_calls,
                                                 count_k1_calls):
    """90 px tiles (m = 45*45 pooled pixels, which the JAX gate sends to XLA
    for want of a 16-aligned chunk) take the fused block here; odd 45 px
    tiles fail the gate and run block 0 as a bf16 conv block. Both match
    the f32 model (pooling floors odd sides)."""
    if variant == "single":
        cfg = ModelConfig(initial_filters=8, num_conv_blocks=2, compute_dtype="f32")
    else:
        cfg = ModelConfig(variant="double", initial_filters_per_branch=4,
                          compute_dtype="f32")
    model = build_model(cfg, image_size=size)
    torch.manual_seed(1)
    burn_in_batch_stats(model, size, steps=2)
    x = np.random.default_rng(4).random((2, size, size, 2)).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    got = ff.make_fast_forward(cfg, model.state_dict())(torch.from_numpy(x)).numpy()
    assert count_k1_calls["n"] == k1_calls
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
