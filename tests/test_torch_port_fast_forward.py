"""The port's folded-BN bf16 forward against the JAX fast forward and the
torch golden model.

On the CPU block 0 goes through the plain version of the fused input block
(the wrapper's CPU path). Tolerances are those of tests/test_fast_forward.py:
5e-3 absolute between two bf16 paths, MAE < 2e-3 against the f32 golden.
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
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=0)


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
