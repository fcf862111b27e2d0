"""The port's train and validation steps against the JAX package's.

Small models (32 px tiles: single-branch width 8 with 3 blocks, two-branch
width 4 per branch), batch 8, the same initial weights (JAX ``init_model``
carried over by ``from_jax_variables``) and the same numpy batches. Flips
and dropout are off (``augment=False``, dropout 0), so both steps are pure
functions of (state, batch).

Bounds, those of tests/test_torch_parity.py's 6-step trajectory against a
torch.optim.Adam loop (the same rationale): per-step loss rtol 2e-3;
parameters within 2*sum(lr), the most a flip of an Adam direction moves an
element, excluding the biases a BatchNorm directly follows (their gradient
is analytically zero, so their Adam direction is f32 noise); running
statistics within 3e-3; eval predictions within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crosstalk_tpu.config as jcfg
from crosstalk_tpu.data.transforms import normalize_batch_nhwc as jnormalize
from crosstalk_tpu.io.torch_convert import flax_to_torch
from crosstalk_tpu.models import registry as jreg
from crosstalk_tpu.train import steps as jsteps
from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
from crosstalk_tpu_torch.data import transforms
from crosstalk_tpu_torch.data.pipeline import DeviceDataset, TileStore, iterate_batches
from crosstalk_tpu_torch.io.torch_convert import from_jax_variables
from crosstalk_tpu_torch.models.registry import build_model
from crosstalk_tpu_torch.train.steps import (
    init_train_state,
    make_train_step,
    make_val_step,
)

SIZE = 32
BATCH = 8
LRS = [1e-3, 1e-3, 3e-4, 3e-4, 9e-5, 9e-5]
SMALL = {
    "single": dict(variant="single", initial_filters=8, num_conv_blocks=3),
    "double": dict(variant="double", initial_filters_per_branch=4),
}


def shadowed_biases(variant):
    if variant == "single":
        return ({f"conv_layers.{4 * k}.bias" for k in range(3)}
                | {"fc_layers.1.bias", "fc_layers.5.bias"})
    return ({f"{br}_branch.conv_blocks.{4 * k}.bias"
             for br in ("bleed", "source") for k in range(4)}
            | {"regression_head.fc_layers.1.bias", "regression_head.fc_layers.5.bias"})


def twin_models(variant, seed=0, compute_dtype="f32", dropout=0.0):
    """(JAX model, JAX variables, port model) with the same weights."""
    drop = {"dropout_single" if variant == "single" else "dropout_double": dropout}
    kw = dict(SMALL[variant], compute_dtype=compute_dtype, **drop)
    jmodel = jreg.build_model(jcfg.ModelConfig(**kw))
    variables = jreg.init_model(jmodel, jax.random.key(seed), image_size=SIZE)
    variables = jax.tree.map(np.asarray, variables)
    model = build_model(ModelConfig(**kw), image_size=SIZE)
    model.load_state_dict(from_jax_variables(variables, variant))
    return jmodel, variables, model


def raw_batch(rng, n=BATCH):
    raw = (rng.random((n, SIZE, SIZE, 2)) * 1800 + 100).astype(np.float32)
    y = rng.uniform(0, 0.5, (n, 1)).astype(np.float32)
    return raw, y


def jax_eval(jmodel, variables, x_nhwc):
    return np.asarray(jmodel.apply(variables, jnp.asarray(x_nhwc), train=False))


def port_eval(model, x_nhwc):
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(np.array(x_nhwc)).permute(0, 3, 1, 2)).numpy()


@pytest.mark.parametrize("variant,grad_accum", [
    ("single", 1), ("double", 1), ("single", 2), ("double", 2),
])
def test_six_step_trajectory_matches_jax(variant, grad_accum):
    jmodel, variables, model = twin_models(variant)
    tx = jsteps.make_optimizer(jcfg.OptimConfig())
    jstate = jsteps.init_train_state(jmodel, variables, tx)
    jstep = jsteps.make_train_step(jmodel, tx, augment=False, grad_accum=grad_accum)
    state = init_train_state(model, OptimConfig())
    step = make_train_step(state, compute_dtype="f32", augment=False,
                           grad_accum=grad_accum)

    rng = np.random.default_rng(40)
    key = jax.random.key(0)
    for i, lr in enumerate(LRS):
        raw, y = raw_batch(rng)
        jstate, jloss = jstep(jstate, jnp.asarray(raw), jnp.asarray(y),
                              np.float32(lr), key)
        loss = step(torch.from_numpy(raw), torch.from_numpy(y), lr)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-3,
                                   err_msg=f"loss diverged at step {i}")
    assert state.step == len(LRS)

    jdict = flax_to_torch(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, variant)
    skip = shadowed_biases(variant)
    compared = 0
    for name, value in model.state_dict().items():
        if "num_batches_tracked" in name or name in skip:
            continue
        tol = 3e-3 if "running" in name else 2 * sum(LRS)
        diff = float(np.abs(value.numpy() - jdict[name]).max())
        assert diff <= tol, f"{name}: max diff {diff:.3e} > {tol:.3e}"
        compared += 1
    assert compared > 25

    x_eval = np.asarray(jnormalize(jnp.asarray(raw_batch(rng, 4)[0])))
    want = jax_eval(jmodel, {"params": jstate.params,
                             "batch_stats": jstate.batch_stats}, x_eval)
    np.testing.assert_allclose(port_eval(model, x_eval), want, atol=1e-4)


def test_masked_val_step_matches_jax():
    jmodel, variables, model = twin_models("single", seed=3)
    rng = np.random.default_rng(5)
    raw, y = raw_batch(rng)
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 0], np.float32)
    want = jsteps._val_core(jmodel, None)(
        variables["params"], variables["batch_stats"],
        jnp.asarray(raw), jnp.asarray(y), jnp.asarray(mask))
    got = make_val_step(model, "f32")(
        torch.from_numpy(raw), torch.from_numpy(y), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4)
    assert float(got[1]) == float(want[1]) == 5.0


@pytest.mark.parametrize("variant", ["single", "double"])
def test_bf16_step_is_finite(variant):
    """bf16 autocast: the BN statistics after LeakyReLU (mostly positive
    activations) stay finite, and the running variance non-negative."""
    _, _, model = twin_models(variant, compute_dtype="bf16", dropout=0.1)
    state = init_train_state(model, OptimConfig())
    step = make_train_step(state, compute_dtype="bf16", seed=1)
    rng = np.random.default_rng(6)
    for _ in range(3):
        raw, y = raw_batch(rng)
        loss = step(torch.from_numpy(raw), torch.from_numpy(y), 1e-3)
        assert torch.isfinite(loss)
    for name, value in model.state_dict().items():
        assert torch.isfinite(value.float()).all(), name
        if "running_var" in name:
            assert (value >= 0).all(), name
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _flips_of(batch, seed, step, offset=0):
    return transforms.paired_random_flips(torch.from_numpy(batch), seed, step, offset)


def test_flips_keep_the_pair_aligned():
    rng = np.random.default_rng(7)
    x = rng.random((64, 8, 8, 1)).astype(np.float32)
    pair = np.concatenate([x, 2 * x], axis=3)
    out = _flips_of(pair, seed=1, step=3)
    torch.testing.assert_close(out[..., 1], 2 * out[..., 0], rtol=0, atol=0)
    # every sample is its own tile under one of the four flips
    for i in range(64):
        t = torch.from_numpy(x[i, :, :, 0])
        assert any(torch.equal(out[i, :, :, 0], c) for c in (
            t, t.flip(1), t.flip(0), t.flip(0).flip(1)))


def test_flips_are_layout_invariant_and_depend_on_seed_and_step():
    rng = np.random.default_rng(8)
    x = rng.random((16, 8, 8, 2)).astype(np.float32)
    whole = _flips_of(x, seed=4, step=9)
    halves = torch.cat([_flips_of(x[:8], 4, 9, 0), _flips_of(x[8:], 4, 9, 8)])
    assert torch.equal(whole, halves)
    # a nonzero offset draws what those positions of a larger batch drew
    assert torch.equal(_flips_of(x[5:11], 4, 9, 5), whole[5:11])
    bits = transforms.flip_bits(4, 9, torch.arange(4096))
    assert 0.45 < bits.float().mean().item() < 0.55
    assert not torch.equal(bits, transforms.flip_bits(4, 10, torch.arange(4096)))
    assert not torch.equal(bits, transforms.flip_bits(5, 9, torch.arange(4096)))


def test_grad_accum_flips_the_same_pixels():
    """The model sees the same augmented inputs with grad_accum 1 and 2."""
    seen = {}
    for accum in (1, 2):
        _, _, model = twin_models("single")
        inputs = []
        model.register_forward_pre_hook(lambda m, args: inputs.append(args[0].clone()))
        state = init_train_state(model, OptimConfig())
        step = make_train_step(state, compute_dtype="f32", seed=11, grad_accum=accum)
        rng = np.random.default_rng(9)
        for _ in range(2):
            raw, y = raw_batch(rng)
            step(torch.from_numpy(raw), torch.from_numpy(y), 1e-3)
        seen[accum] = torch.cat(inputs)
    assert torch.equal(seen[1], seen[2])


def test_dropout_masks_are_a_function_of_seed_and_step():
    """Two fresh states trained the same way draw the same dropout masks
    (a resumed run repeats them); another seed draws others."""
    losses = {}
    for seed in (3, 3, 4):
        _, _, model = twin_models("single", dropout=0.5)
        state = init_train_state(model, OptimConfig())
        step = make_train_step(state, compute_dtype="f32", seed=seed, augment=False)
        rng = np.random.default_rng(10)
        raw, y = raw_batch(rng)
        losses.setdefault(seed, []).append(
            float(step(torch.from_numpy(raw), torch.from_numpy(y), 1e-3)))
    assert losses[3][0] == losses[3][1]
    assert losses[4][0] != losses[3][0]


def test_device_dataset_order_equals_iterate_batches(synthetic_data_dirs):
    from crosstalk_tpu_torch.data.index import PairIndex

    store = TileStore(PairIndex(*synthetic_data_dirs).samples)
    resident = DeviceDataset(store, torch.device("cpu"))
    assert DeviceDataset.nbytes(store) == store.tiles.nbytes + store.labels.nbytes
    for kw in (dict(shuffle=True, drop_last=True, seed=3, epoch=2), {}):
        host = list(iterate_batches(store, 5, **kw))
        dev = list(resident.batches(5, **kw))
        assert len(host) == len(dev) > 1
        for h, d in zip(host, dev):
            assert torch.equal(d.inputs, torch.from_numpy(h.inputs))
            assert torch.equal(d.labels, torch.from_numpy(h.labels))
            assert np.array_equal(d.ids, h.ids)
            assert torch.equal(d.mask, torch.from_numpy(h.mask))
