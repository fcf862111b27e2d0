"""The port's int8 serving tier against the JAX package's, on the CPU.

The same seeded weights (a JAX init carried into the port by
``from_jax_variables``) and the same inputs go through both packages.
Where the arithmetic is the same integer and f32 sequence the port must
agree exactly: the quantizers (int8 values equal, scales within 1 f32 ulp)
and one int8 conv block (int32 accumulators and bf16 output bitwise).
Calibrations agree within rtol 1e-5 per key. The whole int8 forward, with
the JAX package's scales, is held to 1e-4 absolute and to 1e-2 of the
spread (max - min) of JAX's outputs, on inputs and weights chosen so that
the outputs spread over more than 1e-2 (tiles scaled by 0.05-4, the
two-branch model's last dense kernel by 16). Measured (bf16 head / int8
head): 3.7e-9 / 3.7e-9 single-branch over a spread of 4.0e-2, 4.8e-6 /
1.4e-6 two-branch over 1.2e-2: block 0 and the int8 blocks agree bit for
bit, and what is left is the head's f32 products, summed in another order,
rounding to bf16 on the other side of a tie before the last product. As in
the JAX package's tests, the int8 tier tracks the bf16 model within 0.15
of the spread of its outputs, and the full-width single-branch model at 64
px is 1.2e-4 MAE from the torch golden (envelope 2e-2). The JAX package
runs block 0 on XLA's conv (``use_pallas=False``), the port on its bf16
conv path (``use_kernel=False``), except where a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crosstalk_tpu.config as jcfg
import crosstalk_tpu.eval.int8_forward as J
import crosstalk_tpu_torch.eval.fast_forward as ff
import crosstalk_tpu_torch.eval.int8_forward as P
from crosstalk_tpu.models import registry as jreg
from crosstalk_tpu_torch.config import ModelConfig
from crosstalk_tpu_torch.io.torch_convert import from_jax_variables
from crosstalk_tpu_torch.ops.input_block import fused_input_block_packed
from tests.torch_ref import TorchSingle, burn_in_batch_stats

SMALL = dict(initial_filters=8, num_conv_blocks=3, initial_filters_per_branch=4)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    """Per variant: (JAX config, JAX variables, port config, port state_dict)
    of the small configs of tests/test_int8_forward.py, 32 px."""
    out = {}
    for variant in ("single", "double"):
        jc = jcfg.ModelConfig(variant=variant, compute_dtype="bf16", **SMALL)
        v = jreg.init_model(jreg.build_model(jc), jax.random.key(3), image_size=32)
        rng = np.random.default_rng(3)
        v = {"params": v["params"], "batch_stats": jax.tree.map(
            lambda a: a + jnp.asarray(rng.normal(0, 0.01, a.shape), a.dtype) ** 2,
            v["batch_stats"])}
        v = jax.tree.map(np.asarray, v)
        if variant == "double":  # so that its sigmoid outputs spread over > 1e-2
            v["params"]["Dense_0"]["kernel"] = v["params"]["Dense_0"]["kernel"] * 16
        out[variant] = (jc, v, ModelConfig(variant=variant, **SMALL),
                        from_jax_variables(v, variant))
    return out


def _batch(seed=1, n=4, size=32):
    return np.random.default_rng(seed).random((n, size, size, 2)).astype(np.float32)


def _spread_batch(seed=5):
    """Four tiles at four intensities, whose predictions spread apart."""
    gains = np.array([0.05, 0.25, 1.0, 4.0], np.float32)[:, None, None, None]
    return _batch(seed) * gains


# --- quantizers and one conv block -------------------------------------------

@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (512, 64), (3, 3, 1, 8)])
def test_quant_weight_matches_jax(shape):
    rng = np.random.default_rng(0)
    k = rng.normal(0, 1, shape).astype(np.float32)
    k[..., 0] *= 100.0  # one hot channel
    k[..., 1] = 0.0     # and one all-zero channel (the 1e-12 floor)
    jq, jsw = J._quant_weight(jnp.asarray(k))
    pq, psw = P._quant_weight(torch.from_numpy(k))
    assert pq.dtype == torch.int8 and psw.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(psw.numpy(), np.asarray(jsw), maxulp=1)


@pytest.mark.parametrize("sx", [1.0, 0.37, 2.5e-3, 0.0])
def test_quant_act_matches_jax(sx):
    rng = np.random.default_rng(1)
    x = (rng.normal(0, 1, (2, 9, 7, 16)) * 3).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(J._quant_act(xb, sx))
    got = P._quant_act(_t(xb.astype(jnp.float32)).to(torch.bfloat16), sx)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    if sx == 1.0:  # saturation, not wraparound
        assert got.min() == -127 and got.max() == 127


def test_quantization_constants_are_ieee_divisions_as_in_jax():
    """``127 / sx`` and ``x / 127`` are f32 divisions, as in the JAX
    package; torch's ``number / tensor`` (a rounded reciprocal times the
    number) misses a quarter of them by an ulp."""
    sx = np.random.default_rng(2).uniform(1e-3, 10, 2000).astype(np.float32)
    want = np.float32(127.0) / sx
    got = np.array([P._act_scale(float(v), "cpu").item() for v in sx], np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(P._div(torch.from_numpy(sx), 127.0, "cpu").numpy(),
                                  sx / np.float32(127.0))
    assert (127.0 / torch.from_numpy(sx)).numpy().tolist() != want.tolist()


@pytest.mark.parametrize("b,h,w,c,n", [(2, 16, 16, 8, 16), (3, 10, 14, 16, 8), (1, 6, 6, 32, 64),
                                       (2, 8, 8, 4, 12)])
def test_conv_block_int8_matches_jax_exactly(b, h, w, c, n):
    """From one bf16 input: the int32 accumulators and the bf16 block output
    are JAX's, bit for bit (negative BN scales included). C = 4, N = 12 runs
    the zero-padded GEMM (K = 36 and N to multiples of 8)."""
    rng = np.random.default_rng(b * 100 + c)
    xb = jnp.asarray(rng.normal(0, 1, (b, h, w, c)).astype(np.float32)).astype(jnp.bfloat16)
    kernel = rng.normal(0, 0.3, (3, 3, c, n)).astype(np.float32)
    scale = rng.normal(1, 0.3, n).astype(np.float32)
    scale[::3] *= -1
    bias = rng.normal(0, 0.2, n).astype(np.float32)
    sx = float(np.float32(2.5))

    kq, _ = J._quant_weight(jnp.asarray(kernel))
    want_acc = np.asarray(jax.lax.conv_general_dilated(
        J._quant_act(xb, sx), kq, (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    want = np.asarray(J._conv_block_int8(xb, sx, jnp.asarray(kernel), jnp.asarray(scale),
                                         jnp.asarray(bias), 0.01).astype(jnp.float32))

    x = _t(xb.astype(jnp.float32)).to(torch.bfloat16)
    blk = P.prepare_conv_int8(torch.from_numpy(kernel), torch.from_numpy(scale),
                              torch.from_numpy(bias), sx)
    acc = P._conv3x3_int8(P._quant_act(x, sx), blk.weight)
    assert acc.dtype == torch.int32 and acc.shape == (b, h, w, n)
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    got = P._conv_block_int8(x, sx, torch.from_numpy(kernel), torch.from_numpy(scale),
                             torch.from_numpy(bias), 0.01)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h // 2, w // 2, n)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_mse_clip_matches_jax_and_tightens_gaussian_tails():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, 200_000).astype(np.float32)
    want = float(J._mse_clip(jnp.asarray(x)))
    got = float(P._mse_clip(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got < 0.95 * float(np.abs(x).max())


# --- calibration and the forward against JAX ---------------------------------

@pytest.mark.parametrize("variant", ["single", "double"])
@pytest.mark.parametrize("int8_dense", [False, True], ids=["bf16_head", "int8_head"])
@pytest.mark.parametrize("method", ["mse", "absmax"])
def test_calibrate_matches_jax(models, variant, int8_dense, method):
    jc, v, pc, sd = models[variant]
    x = _batch()
    want = J.calibrate_int8(jc, v, x, use_pallas=False, method=method, int8_dense=int8_dense)
    got = P.calibrate_int8(pc, sd, x, use_kernel=False, method=method, int8_dense=int8_dense)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("variant", ["single", "double"])
@pytest.mark.parametrize("int8_dense", [False, True], ids=["bf16_head", "int8_head"])
def test_int8_forward_matches_jax(models, variant, int8_dense):
    jc, v, pc, sd = models[variant]
    x = _spread_batch()
    scales = J.calibrate_int8(jc, v, x, use_pallas=False, int8_dense=int8_dense)
    want = np.asarray(jax.jit(J.make_int8_forward(jc, scales, use_pallas=False))(v, x))
    got = P.make_int8_forward(pc, sd, scales, use_kernel=False)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4, 1)
    spread = float(np.ptp(want))
    assert spread > 1e-2  # a fault after the exact blocks moves outputs by about this
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=min(1e-4, 1e-2 * spread))


@pytest.mark.parametrize("variant", ["single", "double"])
def test_int8_forward_tracks_f32_predictions(variant):
    """tests/test_int8_forward.py's envelope: the int8 tier (the port's own
    calibration, block 0 on the fused input block's CPU path) within 0.15
    of the spread of the model's outputs, and deterministic."""
    jc = jcfg.ModelConfig(variant=variant, compute_dtype="bf16", **SMALL)
    model = jreg.build_model(jc)
    v = jreg.init_model(model, jax.random.key(2), image_size=64)
    rng = np.random.default_rng(2)
    v = {"params": v["params"], "batch_stats": jax.tree.map(
        lambda a: a + jnp.asarray(rng.normal(0, 0.01, a.shape), a.dtype) ** 2,
        v["batch_stats"])}
    x = np.random.default_rng(5).random((4, 64, 64, 2)).astype(np.float32)
    golden = np.asarray(jax.jit(lambda a, b: model.apply(a, b, train=False))(v, x))

    pc, sd = ModelConfig(variant=variant, **SMALL), from_jax_variables(v, variant)
    fast = P.make_int8_forward(pc, sd, P.calibrate_int8(pc, sd, x))
    out = fast(torch.from_numpy(x)).numpy()
    assert out.shape == golden.shape and out.dtype == np.float32
    spread = max(float(np.ptp(golden)), 1e-3)
    mae = float(np.abs(out - golden).mean())
    assert mae < 0.15 * spread, (mae, spread)
    np.testing.assert_array_equal(out, fast(torch.from_numpy(x)).numpy())


def test_int8_forward_full_config_torch_envelope():
    """The full-width single-branch model at 64 px against the torch golden:
    the JAX package's envelope (tests/test_int8_forward.py), MAE < 2e-2,
    with block 0 on the fused input block's CPU path."""
    torch.manual_seed(11)
    tmodel = burn_in_batch_stats(TorchSingle(image_size=64), 64)
    x = np.random.default_rng(3).random((4, 64, 64, 2)).astype(np.float32)
    with torch.no_grad():
        golden = tmodel(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    cfg, sd = ModelConfig(variant="single"), tmodel.state_dict()
    scales = P.calibrate_int8(cfg, sd, x)
    out = P.make_int8_forward(cfg, sd, scales)(torch.from_numpy(x)).numpy()
    assert np.abs(out - golden).mean() < 2e-2


@pytest.mark.parametrize("variant", ["single", "double"])
def test_calibration_and_forward_launch_block0_through_the_shared_helper(models, variant,
                                                                         monkeypatch):
    """Block 0 goes through ``make_first_block``'s fused input-block call in
    the calibration pass and in the int8 forward, once each."""
    calls = {"n": 0}

    def counting(*a, **k):
        calls["n"] += 1
        return fused_input_block_packed(*a, **k)

    monkeypatch.setattr(ff, "fused_input_block_packed", counting)
    _, _, pc, sd = models[variant]
    x = torch.from_numpy(_batch())
    scales = P.calibrate_int8(pc, sd, x)
    assert calls["n"] == 1
    out = P.make_int8_forward(pc, sd, scales)(x)
    assert calls["n"] == 2 and torch.isfinite(out).all()
    # the kernel route and the bf16 conv route of block 0 agree closely
    ref = P.make_int8_forward(pc, sd, scales, use_kernel=False)(x)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=2e-3)


def test_predictor_int8_matches_direct_forward(models):
    from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    _, _, pc, sd = models["single"]
    raw = np.random.default_rng(8).random((4, 32, 32, 2)).astype(np.float32) * 900
    norm = normalize_batch_nhwc(torch.from_numpy(raw))
    scales = P.calibrate_int8(pc, sd, norm)
    predict = make_predictor(sd, pc, batch_size=4, image_size=32, device="cpu",
                             int8_scales=scales)
    direct = P.make_int8_forward(pc, sd, scales)(norm)[:, 0].numpy()
    np.testing.assert_allclose(predict(raw), direct, rtol=0, atol=1e-6)


def test_make_forward_int8_requires_fast_path(models):
    from crosstalk_tpu_torch.io.export import make_forward

    _, _, pc, sd = models["single"]
    with pytest.raises(ValueError, match="fast serving path"):
        make_forward(pc, sd, fast=False, int8_scales={"conv_1": 1.0, "conv_2": 1.0})


def test_int8_errors_match_jax(models):
    _, _, pc, sd = models["single"]
    with pytest.raises(KeyError):
        P.make_int8_forward(pc, sd, {"conv_1": 1.0})
    with pytest.raises(ValueError, match="calibration method"):
        P.calibrate_int8(pc, sd, _batch(), method="minmax")


def test_load_calibration_tiles_matches_jax(tmp_path):
    from tests.conftest import make_synthetic_dataset

    mixed, source = make_synthetic_dataset(str(tmp_path), n=5, size=16)
    want = J.load_calibration_tiles(mixed, source, 16, max_tiles=3)
    got = P.load_calibration_tiles(mixed, source, 16, max_tiles=3)
    assert got.shape == (3, 16, 16, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    for load in (J.load_calibration_tiles, P.load_calibration_tiles):
        with pytest.raises(ValueError, match="serving tile size"):
            load(mixed, source, 32)
