"""The port's measuring probes (``crosstalk_tpu_torch/tools/``:
``int8_probe``, ``int8_tier_probe``, ``bwd_audit``, ``two_branch_sol_probe``,
``two_branch_input_probe``, ``grouped_trunk_probe``) against the root
``tools/*.py`` JAX scripts, on the CPU at small sizes.

The JAX scripts are loaded by path; their module-level functions (and, for
what they compute inside ``main``, the same lines on JAX package functions)
are the reference. Inputs are drawn with numpy from a seed; JAX weights
cross over by ``io/torch_convert.from_jax_variables``. Tolerances:

* int8 accumulators: equal; the bf16 conv: one bf16 ulp of the output's
  largest value (2^-7 x max |y|), as the two libraries round each sum once;
* real tiles, burned statistics, the block-diagonal kernel: equal;
* int8-vs-f32 deviation: the f32 predictions 1e-4 (the parity budget),
  the int8 ones 1e-4 (tests/test_torch_port_int8.py), so MAE and spread
  within 2e-4;
* f32 gradients: loss rtol 1e-4, each leaf 1e-3 x its max |g| (the JAX
  BatchNorm's f32 statistics set these; ``test_bwd_audit_gradients_match_jax``);
* the two-branch stages and the trunks: one bf16 ulp relative where
  |y| > 1e-3 (K1's twin against the Pallas kernel, as
  tests/test_torch_port_input_block.py), 2^-7 x max |y| for the bf16 conv
  blocks, 5e-4 for the head's f32 output (the ``--fast`` forward's,
  tests/test_torch_port_fast_forward.py).

On the CPU K1's plain twin runs wherever the card launches K1; its calls
are counted as tests/test_torch_port_tools.py counts them.
"""

import ast
import contextlib
import functools
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crosstalk_tpu.config as jcfg
import crosstalk_tpu.eval.fast_forward as jff
import crosstalk_tpu.eval.int8_forward as jint8
import crosstalk_tpu_torch.eval.fast_forward as ff
from crosstalk_tpu.data.transforms import normalize_batch_nhwc as jax_normalize
from crosstalk_tpu.models import registry as jreg
from crosstalk_tpu_torch.config import ModelConfig
from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc, prepare_train_batch
from crosstalk_tpu_torch.eval.int8_forward import calibrate_int8, make_int8_forward
from crosstalk_tpu_torch.io.torch_convert import from_jax_variables, structure
from crosstalk_tpu_torch.models.registry import build_model
from crosstalk_tpu_torch.ops.input_block import fused_input_block_packed
from crosstalk_tpu_torch.tools import (
    bwd_audit,
    grouped_trunk_probe,
    int8_probe,
    int8_tier_probe,
    make_dataset,
    two_branch_input_probe,
    two_branch_sol_probe,
)
from tests.torch_ref import TorchSingle, burn_in_batch_stats

ROOT = Path(__file__).resolve().parents[1]
ULP = 2.0 ** -7
SMALL = dict(initial_filters=8, num_conv_blocks=3, initial_filters_per_branch=4)


def _jax_script(name):
    """The root ``tools/<name>.py`` as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_tools():
    return {name: _jax_script(name) for name in (
        "int8_probe", "int8_tier_probe", "bwd_audit", "two_branch_sol_probe",
        "grouped_trunk_probe")}


@pytest.fixture
def count_k1_calls(monkeypatch):
    calls = {"n": 0}

    def counting(*a, **k):
        calls["n"] += 1
        return fused_input_block_packed(*a, **k)

    monkeypatch.setattr(ff, "fused_input_block_packed", counting)
    monkeypatch.setattr(two_branch_input_probe, "fused_input_block_packed", counting)
    return calls


@pytest.fixture(scope="module")
def tiles_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("probe_tiles")
    with contextlib.redirect_stdout(io.StringIO()):
        assert make_dataset.main([str(root), "-n", "24", "--size", "32"]) == 0
    return str(root)


def _run(main, argv):
    """-> (exit code, stdout lines, stderr) of a ``main``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue().strip().splitlines(), err.getvalue()


def _narrow(monkeypatch, module):
    monkeypatch.setattr(module, "ModelConfig", functools.partial(ModelConfig, **SMALL))


def _jax_variables(variant, size, seed=0, **kw):
    cfg = jcfg.ModelConfig(variant=variant, **{**SMALL, **kw})
    v = jreg.init_model(jreg.build_model(cfg), jax.random.key(seed), image_size=size)
    return cfg, jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})


def _burn(variables, rng):
    """The JAX tier probe's burned statistics (tools/int8_tier_probe.py:153-160)."""
    return {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda a: np.asarray(a + jnp.asarray(rng.normal(0, 0.01, a.shape), a.dtype) ** 2),
        variables["batch_stats"])}


def _within_bf16(got, want):
    """|got - want| <= one bf16 ulp of the largest |want| (2^-7 x max)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ULP * np.abs(want).max()


# ---- int8_probe -------------------------------------------------------------

def test_int8_probe_accumulators_equal_jax_conv(jax_tools):
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, (2, 9, 9, 12), dtype=np.int8)
    k = rng.integers(-127, 128, (3, 3, 12, 10), dtype=np.int8)
    want = np.asarray(jax_tools["int8_probe"].conv(jnp.asarray(x), jnp.asarray(k)))
    got = int8_probe.conv_int8(torch.from_numpy(x), int8_probe.int8_weight(torch.from_numpy(k)))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the probe's input shift wraps in int8, as the JAX one does
    np.testing.assert_array_equal((torch.from_numpy(x) + 5).numpy(),
                                  np.asarray(jnp.asarray(x) + jnp.int8(5)))


def test_int8_probe_bf16_conv_matches_jax_conv(jax_tools):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 8, 8, 16)), jnp.bfloat16)
    k = jnp.asarray(rng.normal(size=(3, 3, 16, 24)), jnp.bfloat16)
    want = np.asarray(jax_tools["int8_probe"].conv(x, k).astype(jnp.float32))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    kt = torch.from_numpy(np.array(k.astype(jnp.float32))).to(torch.bfloat16)
    got = int8_probe.conv_bf16(xt.permute(0, 3, 1, 2), kt.permute(3, 2, 0, 1))
    _within_bf16(got.float().permute(0, 2, 3, 1).numpy(), want)


def test_int8_probe_main_prints_a_line_per_block(monkeypatch):
    blocks = [("blockA", 2, 8, 8, 16), ("blockB", 1, 4, 16, 8)]
    monkeypatch.setattr(int8_probe, "BLOCKS", blocks)
    monkeypatch.setattr(int8_probe, "SCAN_LEN", 2)
    rc, lines, _ = _run(int8_probe.main, ["--device", "cpu"])
    assert rc == 0 and lines[0] == "devices: cpu"
    for name, *_ in blocks:
        jax_line = [ln for ln in lines if ln.startswith(f"{name}: bf16 ") and "speedup" in ln]
        assert len(jax_line) == 1 and "us/img" in jax_line[0] and "TOP/s" in jax_line[0]
    result = json.loads(lines[-1])
    assert list(result["blocks"]) == ["blockA", "blockB"]
    for r in result["blocks"].values():
        assert r["int8_abs_sum"] > 0 and r["bf16_abs_sum"] > 0 and r["speedup"] > 0


# ---- int8_tier_probe --------------------------------------------------------

def test_int8_tier_probe_real_tiles_equal_jax(jax_tools, tiles_dir, monkeypatch):
    monkeypatch.setattr(jax_tools["int8_tier_probe"], "REF_DATA", tiles_dir)
    want = jax_tools["int8_tier_probe"]._real_tiles()
    got = int8_tier_probe.real_tiles(tiles_dir)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (24, 32, 32, 2)
    assert got.tobytes() == want.tobytes()
    assert int8_tier_probe.real_tiles(tiles_dir, n=5).tobytes() == want[:5].tobytes()


@pytest.mark.parametrize("variant", ["single", "double"])
def test_int8_tier_probe_burned_statistics_equal_jax(variant):
    _, v = _jax_variables(variant, 32)
    want = from_jax_variables(_burn(v, np.random.default_rng(7)), variant)
    got = int8_tier_probe.burn_batch_stats(from_jax_variables(v, variant), variant,
                                           np.random.default_rng(7))
    assert sorted(got) == sorted(want)
    moved = 0
    for k in want:
        assert torch.equal(got[k], want[k]), k
        moved += k.endswith("running_var") and not torch.equal(got[k], torch.ones_like(got[k]))
    assert moved > 0


@pytest.mark.parametrize("variant", ["single", "double"])
def test_int8_tier_probe_deviation_matches_jax(variant, tiles_dir):
    """int8 vs f32 MAE and f32 spread on the same weights and normalized
    tiles, computed as tools/int8_tier_probe.py:163-186 computes them."""
    jc, v = _jax_variables(variant, 32, seed=3)
    v = _burn(v, np.random.default_rng(7))
    raw = int8_tier_probe.real_tiles(tiles_dir)
    real = jax_normalize(jnp.asarray(raw))
    scales = jint8.calibrate_int8(jc, v, real[:64], use_pallas=False)
    quant = jint8.make_int8_forward(jc, scales, use_pallas=False)
    f32_model = jreg.build_model(jcfg.ModelConfig(variant=variant, compute_dtype="f32", **SMALL))
    p_f32 = np.asarray(f32_model.apply(v, real, train=False))
    p_int8 = np.asarray(quant(v, real))
    want_mae, want_spread = float(np.abs(p_int8 - p_f32).mean()), float(np.ptp(p_f32))

    cfg = ModelConfig(variant=variant, **SMALL)
    sd = from_jax_variables(v, variant)
    real_t = normalize_batch_nhwc(torch.from_numpy(raw))
    quant_t = make_int8_forward(cfg, sd, calibrate_int8(cfg, sd, real_t[:64]))
    mae, spread = int8_tier_probe.deviation(cfg, sd, quant_t, real_t)
    assert abs(spread - want_spread) <= 2e-4
    assert abs(mae - want_mae) <= 2e-4
    assert mae <= 2e-2  # the int8 envelope (PERF.md §2)


def test_int8_tier_probe_refuses_a_checkpoint_of_another_tile_size(jax_tools, tiles_dir,
                                                                   monkeypatch, tmp_path):
    torch.manual_seed(5)
    model = burn_in_batch_stats(TorchSingle(initial_filters=8, num_blocks=3, image_size=32), 32)
    path = str(tmp_path / "m32.pth")
    torch.save(model.state_dict(), path)
    monkeypatch.setattr(jax_tools["int8_tier_probe"], "REF_DATA", tiles_dir)
    jrc, _, jerr = _run(jax_tools["int8_tier_probe"].main, ["-p", path, "-o", "single"])
    rc, lines, err = _run(int8_tier_probe.main, ["-p", path, "-o", "single", "--data_dir",
                                                 tiles_dir, "--device", "cpu"])
    assert rc == jrc == 2
    assert err == jerr and "was trained at 32px tiles" in err
    assert lines == ["devices: cpu"]


def test_int8_tier_probe_runs_both_families_through_k1s_twin(tiles_dir, monkeypatch,
                                                             count_k1_calls):
    _narrow(monkeypatch, int8_tier_probe)
    monkeypatch.setattr(int8_tier_probe, "SIZE", 32)
    monkeypatch.setattr(int8_tier_probe, "SCAN_LEN", 2)
    rc, lines, _ = _run(int8_tier_probe.main, ["--batch", "4", "--data_dir", tiles_dir,
                                               "--device", "cpu"])
    assert rc == 0
    result = json.loads(lines[-1])
    assert list(result["families"]) == ["single", "double"] and result["real_tiles"] == 24
    for variant, r in result["families"].items():
        assert [ln for ln in lines if ln.startswith(f"{variant}: bf16 ")]
        assert r["bf16_batch"] == r["int8_batch"] == 4 and r["speedup"] > 0
        assert r["mae_vs_f32"] <= 2e-2
    # per family: 1 calibration, 4 units x 2 steps of --fast and of int8,
    # 1 deviation forward
    assert count_k1_calls["n"] == 2 * (1 + 2 * 4 * 2 + 1)


# ---- bwd_audit --------------------------------------------------------------

@pytest.mark.parametrize("variant", ["single", "double"])
def test_bwd_audit_freezes_what_the_jax_audit_stops(jax_tools, variant):
    """A JAX params tree with 1 on the leaves ``_is_kernel_or_bias`` selects
    and 0 elsewhere, carried across: the frozen tensors are the ones."""
    _, v = _jax_variables(variant, 32)
    select = jax_tools["bwd_audit"]._is_kernel_or_bias
    marked = jax.tree_util.tree_map_with_path(
        lambda p, a: np.full_like(a, 1.0 if select(p) else 0.0), v["params"])
    sd = from_jax_variables({"params": marked, "batch_stats": v["batch_stats"]}, variant)
    model = build_model(ModelConfig(variant=variant, **SMALL), image_size=32)
    names = dict(model.named_parameters())
    ones = {n for n in names if bool((sd[n] == 1).all())}
    zeros = {n for n in names if bool((sd[n] == 0).all())}
    assert ones | zeros == set(names) and ones
    assert bwd_audit.frozen_names(model) == ones
    bwd_audit.set_trainable(model, "data_grads")
    assert {n for n, p in model.named_parameters() if not p.requires_grad} == ones


def _jax_loss_and_grads(jax_tools, cfg, v, batch, labels, mode):
    """tools/bwd_audit.py:59-75's loss on an already prepared batch."""
    model = jreg.build_model(cfg)
    select = jax_tools["bwd_audit"]._is_kernel_or_bias

    def loss_fn(params):
        if mode == "data_grads":
            params = jax.tree_util.tree_map_with_path(
                lambda p, a: jax.lax.stop_gradient(a) if select(p) else a, params)
        preds, _ = model.apply({"params": params, "batch_stats": v["batch_stats"]}, batch,
                               train=True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.key(0)})
        return jnp.mean(jnp.square(preds - labels))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    return float(loss), grads


@pytest.mark.parametrize("variant", ["single", "double"])
@pytest.mark.parametrize("mode", ["grads", "data_grads"])
def test_bwd_audit_gradients_match_jax(jax_tools, variant, mode):
    """f32, dropout 0, one already flipped batch. The JAX BatchNorm takes
    its batch statistics in f32 as E[x^2] - E[x]^2
    (crosstalk_tpu/models/layers.py:93-104), which cancels: on this batch
    its loss lies 8e-6 (single) and 2.8e-5 (double) from the port's
    float64 step and its worst leaf 5.4e-4 x max |g|, against 1.7e-7 and
    1.9e-5 for the port's f32 step. So the bounds are loss rtol 1e-4 and
    each leaf 1e-3 x its max |g|. The biases a BatchNorm directly follows
    have a gradient that is 0 up to rounding (up to 2e-6 x the largest
    gradient here): both sides hold them under 1e-5 x the largest."""
    kw = dict(dropout_single=0.0, dropout_double=0.0)
    jc, v = _jax_variables(variant, 32, seed=1, compute_dtype="f32", **kw)
    rng = np.random.default_rng(4)
    raw = torch.from_numpy(rng.random((4, 32, 32, 2)).astype(np.float32))
    labels = rng.uniform(0, 0.5, (4, 1)).astype(np.float32)
    batch = prepare_train_batch(raw, 2, 0, augment=True)
    want_loss, want = _jax_loss_and_grads(jax_tools, jc, v, jnp.asarray(batch.numpy()),
                                          jnp.asarray(labels), mode)
    want = from_jax_variables({"params": want, "batch_stats": v["batch_stats"]}, variant)

    model = build_model(ModelConfig(variant=variant, **SMALL, **kw), image_size=32)
    model.load_state_dict(from_jax_variables(v, variant))
    model.train()
    bwd_audit.set_trainable(model, mode)
    loss, got = bwd_audit.loss_and_grads(model, batch, torch.from_numpy(labels), mode,
                                         compute_dtype="f32")
    assert loss.item() == pytest.approx(want_loss, rel=1e-4)
    names = {n for n, _ in model.named_parameters()}
    frozen = bwd_audit.frozen_names(model) if mode == "data_grads" else set()
    assert set(got) == names - frozen
    for n in frozen:
        assert not want[n].any(), n  # stop_gradient leaves: zero in JAX
    head_out = structure(variant)[1] + ".9.bias"
    shadowed = {n for n in bwd_audit.frozen_names(model) if n.endswith(".bias")} - {head_out}
    largest = max(float(g.abs().max()) for g in got.values())
    for n, g in got.items():
        if n in shadowed:
            assert max(float(g.abs().max()), float(want[n].abs().max())) <= 1e-5 * largest, n
            continue
        tol = 1e-3 * float(want[n].abs().max())
        assert float((g - want[n]).abs().max()) <= tol, n


def test_bwd_audit_bf16_grads_are_bf16_and_statistics_stay_f32():
    torch.manual_seed(0)
    model = build_model(ModelConfig(variant="single", **SMALL), image_size=32).train()
    before = {n: b.clone() for n, b in model.named_buffers()}
    batch = torch.rand(4, 32, 32, 2)
    loss, grads = bwd_audit.loss_and_grads(model, batch, torch.rand(4, 1), "bf16_grads")
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    assert set(grads) == {n for n, _ in model.named_parameters()}
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
               for g in grads.values())
    assert all(p.dtype == torch.float32 and p.grad is None for p in model.parameters())
    stats = {n: b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))}
    assert stats and all(b.dtype == torch.float32 for b in stats.values())
    assert any(not torch.equal(b, before[n]) for n, b in stats.items())  # they updated


def test_bwd_audit_main_prints_every_mode(monkeypatch):
    _narrow(monkeypatch, bwd_audit)
    for name, value in (("B", 2), ("SCAN", 2), ("SIZE", 32)):
        monkeypatch.setattr(bwd_audit, name, value)
    rc, lines, _ = _run(bwd_audit.main, ["--device", "cpu"])
    assert rc == 0
    result = json.loads(lines[-1])
    assert list(result) == ["full", "grads", "data_grads", "bf16_grads", "bf16_full"]
    assert all(us > 0 for us in result.values())
    for mode in result:
        assert [ln for ln in lines if ln.startswith(f"{mode:12s}: ") and "us/img" in ln]


# ---- two_branch_sol_probe / two_branch_input_probe --------------------------

@pytest.fixture(scope="module")
def two_branch():
    """JAX config and variables of the two-branch model at F=64 per branch
    (block 0 at its full width, the Pallas kernel's lane rule met) on 32 px
    tiles, burned statistics; the port's config and state_dict."""
    jc, v = _jax_variables("double", 32, seed=2, compute_dtype="bf16",
                           initial_filters_per_branch=64)
    v = _burn(v, np.random.default_rng(5))
    return jc, v, ModelConfig(variant="double"), from_jax_variables(v, "double")


def _assert_within_one_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    big = np.abs(want) > 1e-3
    assert (np.abs(got - want)[big] / np.abs(want)[big]).max(initial=0.0) <= ULP
    assert np.abs(got - want)[~big].max(initial=0.0) <= 1e-5


def test_two_branch_stages_match_jax(two_branch):
    jc, v, cfg, sd = two_branch
    p, st = v["params"], v["batch_stats"]
    eps, slope = cfg.bn_eps, cfg.leaky_slope
    rng = np.random.default_rng(0)
    x0 = rng.random((2, 32, 32, 2)).astype(np.float32)
    want = jff._double_fused_input(jnp.asarray(x0), p, st, eps, slope, True)
    got = ff.make_first_block(cfg, sd)(torch.from_numpy(x0))
    for g, w in zip(got, want):
        _assert_within_one_ulp(g.float().permute(0, 2, 3, 1).numpy(), w.astype(jnp.float32))
    assert two_branch_sol_probe.input_stage(ff.make_first_block(cfg, sd),
                                            torch.from_numpy(x0)).item() == pytest.approx(
        sum(float(jnp.sum(w.astype(jnp.float32))) for w in want), rel=1e-3)

    for i, cin, hw in ((1, 64, 16), (2, 128, 8), (3, 256, 4)):
        x = rng.random((2, hw, hw, cin)).astype(np.float32)
        k, s, b = jff._block_affine(p["bleed_branch"][f"ConvBlock_{i}"],
                                    st["bleed_branch"][f"ConvBlock_{i}"], eps)
        want = jff._conv_block_eval(jnp.asarray(x, jnp.bfloat16), k, s, b, slope)
        blk = ff._fold_conv(sd, "bleed_branch.conv_blocks", i, eps)
        xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
        got = ff._conv_block_eval(xt, blk, slope)
        _within_bf16(got.float().permute(0, 2, 3, 1).numpy(), want.astype(jnp.float32))

    hx = rng.random((2, 2, 2, 1024)).astype(np.float32)
    h = jnp.asarray(hx, jnp.bfloat16).reshape(2, -1)
    h = jff._dense_bn_eval(h, p["DenseBNBlock_0"], st["DenseBNBlock_0"], eps, slope)
    h = jff._dense_bn_eval(h, p["DenseBNBlock_1"], st["DenseBNBlock_1"], eps, slope)
    out = p["Dense_0"]
    h = jnp.dot(h.astype(jnp.bfloat16), jnp.asarray(out["kernel"], jnp.bfloat16),
                preferred_element_type=jnp.float32) + out["bias"]
    want = float(jnp.sum(jax.nn.sigmoid(h) * 0.5))
    head = "regression_head.fc_layers"
    w1, w5 = ff.head_weights(cfg, sd)
    weights = ([ff._fold_dense(sd, head, 1, 2, eps, w1), ff._fold_dense(sd, head, 5, 6, eps, w5)],
               sd[f"{head}.9.weight"].to(torch.bfloat16), sd[f"{head}.9.bias"].float())
    got = two_branch_sol_probe.head_stage(weights, torch.from_numpy(hx).to(torch.bfloat16), slope)
    assert abs(got.item() - want) <= 2 * 5e-4  # two predictions, 5e-4 each


def test_block_diagonal_kernel_equals_jax_construction(two_branch):
    """tools/two_branch_input_probe.py:101-109 on the JAX package's
    ``_block_affine``, against the port's ``block_diagonal``."""
    _, v, cfg, sd = two_branch
    p, st, eps = v["params"], v["batch_stats"], cfg.bn_eps
    kb, sb, bb = jff._block_affine(p["bleed_branch"]["ConvBlock_0"],
                                   st["bleed_branch"]["ConvBlock_0"], eps)
    ks, ss, bs_ = jff._block_affine(p["source_branch"]["ConvBlock_0"],
                                    st["source_branch"]["ConvBlock_0"], eps)
    kfused = jnp.zeros((3, 3, 2, 128), kb.dtype)
    kfused = kfused.at[:, :, 0:1, 0:64].set(kb)
    kfused = kfused.at[:, :, 1:2, 64:128].set(ks)
    kernel, scale, bias = two_branch_input_probe.block_diagonal(sd, eps)
    np.testing.assert_array_equal(kernel.numpy(), np.asarray(kfused))
    # the port folds BN with a float64 reciprocal square root (ROADMAP §3)
    np.testing.assert_allclose(scale.numpy(), np.asarray(jnp.concatenate([sb, ss])), rtol=2e-7)
    np.testing.assert_allclose(bias.numpy(), np.asarray(jnp.concatenate([bb, bs_])),
                               rtol=2e-7, atol=1e-7)


def test_sol_probe_gflop_constants_equal_jax():
    """The per-image GFLOP arguments of the JAX probe's ``stage`` and
    ``branch_stage`` calls, read from its source."""
    tree = ast.parse((ROOT / "tools" / "two_branch_sol_probe.py").read_text())
    calls = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("stage", "branch_stage") and node.args
                and not any(isinstance(n, ast.Name) for n in ast.walk(node.args[-1]))):
            calls.setdefault(node.func.id, []).append(
                eval(compile(ast.Expression(node.args[-1]), "gflop", "eval")))
    assert calls["stage"] == [two_branch_sol_probe.INPUT_GFLOP, two_branch_sol_probe.HEAD_GFLOP]
    assert calls["branch_stage"] == [two_branch_sol_probe.BLOCK_GFLOP] * 3


def test_sol_probe_runs_k1s_twin_on_its_input_stage_and_forward(monkeypatch, count_k1_calls):
    _narrow(monkeypatch, two_branch_sol_probe)
    monkeypatch.setattr(two_branch_sol_probe, "SIZE", 32)
    monkeypatch.setattr(two_branch_sol_probe, "MATMUL_N", 64)
    rc, lines, _ = _run(two_branch_sol_probe.main, ["-b", "2", "--scan", "2", "--device", "cpu"])
    assert rc == 0
    result = json.loads(lines[-1])
    assert len(result["stages"]) == 5 and result["matmul_tflops"] > 0
    assert result["sum_of_stages_us"] > 0 and result["full_forward_us"] > 0
    assert any(ln.startswith("sum of stages: ") for ln in lines)
    assert count_k1_calls["n"] == 2 * 4 * 2  # 4 units x 2 steps, input stage and forward


def test_input_probe_labels_and_k1s_twin(monkeypatch, count_k1_calls):
    _narrow(monkeypatch, two_branch_input_probe)
    rc, lines, _ = _run(two_branch_input_probe.main,
                        ["-b", "2", "--scan", "2", "--size", "32", "--device", "cpu"])
    assert rc == 0
    result = json.loads(lines[-1])
    assert list(result["us_per_img"]) == [
        "2x cuDNN input blocks (export route)", "block-diagonal kernel (+ slices) (shipping)",
        "full forward, block-diagonal kernel (shipping)",
        "full forward, 2x cuDNN input blocks (export route)"]
    assert result["prediction_max_diff"] <= 2e-3  # the --fast envelope
    for name in ("bleed", "source"):
        assert result[f"equivalence_{name}_rel"] <= ULP
    # 1 equivalence call, 4 x 2 kernel-stage steps, 4 x 2 shipping steps, 1 on 8 tiles
    assert count_k1_calls["n"] == 1 + 8 + 8 + 1


# ---- grouped_trunk_probe ----------------------------------------------------

def test_grouped_trunk_equals_per_branch_and_jax(jax_tools, monkeypatch):
    feats = [4, 8, 16, 32]
    monkeypatch.setattr(jax_tools["grouped_trunk_probe"], "FEATS", feats)
    jp = jax.tree.map(np.asarray, jax_tools["grouped_trunk_probe"].make_params(
        jax.random.key(0)))
    ks, ss, bs = jp
    params = ([tuple(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()) for k in pair)
               for pair in ks],
              [tuple(torch.from_numpy(s) for s in pair) for pair in ss],
              [tuple(torch.from_numpy(b) for b in pair) for pair in bs])
    x = np.random.default_rng(0).random((2, 32, 32, 2)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    grouped = grouped_trunk_probe.grouped_trunk(params, xt).float()
    per_branch = grouped_trunk_probe.perbranch_trunk(params, xt).float()
    _within_bf16(grouped.numpy(), per_branch.numpy())
    want = np.asarray(jax.jit(jax_tools["grouped_trunk_probe"].grouped_trunk)(
        jp, jnp.asarray(x)).astype(jnp.float32))
    _within_bf16(grouped.permute(0, 2, 3, 1).numpy(), want)


def test_grouped_trunk_probe_main(monkeypatch):
    for name, value in (("B", 2), ("SCAN", 2), ("SIZE", 32), ("FEATS", [4, 8, 16, 32])):
        monkeypatch.setattr(grouped_trunk_probe, name, value)
    rc, lines, _ = _run(grouped_trunk_probe.main, ["--device", "cpu"])
    assert rc == 0 and lines[1].startswith("equivalence: rel MAE=")
    result = json.loads(lines[-1])
    assert result["equivalence"]["rel_max"] <= ULP
    for name in ("per-branch", "grouped"):
        t = result["trunks"][name]
        assert t["fwd_us_per_img"] > 0 and t["fwd_bwd_us_per_img"] > 0
