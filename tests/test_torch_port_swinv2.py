"""SwinV2 (``crosstalk_tpu_torch/models/swinv2.py``) against the plain
float32 reference ``tests/swinv2_ref.py`` on seeded weights, on the CPU, at
image 64, window 4, embed 16, depths (2, 2, 2, 2), heads (1, 2, 2, 4): stage
1 (16 x 16 tokens) and 2 (8 x 8) shift, stage 3's map equals the window,
stage 4's (2 x 2) clamps it. Also: the tables at window 8 by hand, the
counters, the train step's spans, ``init_model``'s draws and the paths that
refuse the model."""

import math
import os
import sys

import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(__file__))
import swinv2_ref as ref  # noqa: E402

from crosstalk_tpu_torch.config import ModelConfig, OptimConfig  # noqa: E402
from crosstalk_tpu_torch.data.transforms import DROPOUT_STREAM, counter_key  # noqa: E402
from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc  # noqa: E402
from crosstalk_tpu_torch.models import swinv2  # noqa: E402
from crosstalk_tpu_torch.models.registry import build_model, init_model  # noqa: E402
from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step  # noqa: E402

SMALL = dict(image=64, embed=16, depths=(2, 2, 2, 2), heads=(1, 2, 2, 4), window=4)
CFG = ModelConfig(variant="swinv2-b", swin_embed_dim=16, swin_depths=(2, 2, 2, 2),
                  swin_heads=(1, 2, 2, 4), swin_window=4, compute_dtype="f32")


@pytest.fixture(autouse=True)
def _plain():
    ref.plain_numerics()


def _model(seed=0):
    m = build_model(CFG, image_size=64)
    init_model(m, torch.Generator().manual_seed(seed))
    return m


def _weights(m):
    return {k: v.detach().clone() for k, v in m.state_dict().items()}


def _masks(keep, rows, seed):
    gen = torch.Generator().manual_seed(seed)
    m = torch.empty((keep.shape[0], rows)).bernoulli_(keep, generator=gen)
    return [(m[2 * i], m[2 * i + 1]) for i in range(keep.shape[0] // 2)]


def test_forward_matches_the_reference():
    m = _model()
    x = torch.rand(3, 2, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = m(x)
    want = ref.forward(_weights(m), x, **SMALL)
    assert got.shape == (3, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_train_loss_and_gradients_match_the_reference_under_the_same_masks():
    m = _model(2).train()
    m.drop_path.generator = torch.Generator().manual_seed(7)
    x = torch.rand(4, 2, 64, 64, generator=torch.Generator().manual_seed(3))
    y = torch.rand(4, 1, generator=torch.Generator().manual_seed(4))
    loss = F.mse_loss(m(x), y)
    loss.backward()
    w = {k: v.requires_grad_(True) for k, v in _weights(m).items()}
    masks = _masks(m.drop_path.keep, 4, 7)
    assert any((a == 0).any() for a, _ in masks)  # the draw dropped something
    want = F.mse_loss(ref.forward(w, x, masks=masks, **SMALL), y)
    want.backward()
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-7)
    for name, p in m.named_parameters():
        torch.testing.assert_close(p.grad, w[name].grad, rtol=1e-4, atol=1e-6, msg=name)


def test_one_adam_l2_step_matches_the_reference():
    m = _model(5)
    w0 = _weights(m)
    state = init_train_state(m, OptimConfig())
    step = make_train_step(state, compute_dtype="f32", seed=11, augment=False)
    raw = torch.rand(4, 64, 64, 2, generator=torch.Generator().manual_seed(6)) * 3
    labels = torch.rand(4, 1, generator=torch.Generator().manual_seed(8))
    loss = step(raw, labels, 1e-3)
    assert state.step == 1 and m.drop_path.generator is not None

    w = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    masks = _masks(m.drop_path.keep, 4, counter_key(11, 0, DROPOUT_STREAM, 0))
    x = normalize_batch_nhwc(raw).permute(0, 3, 1, 2)
    want = F.mse_loss(ref.forward(w, x, masks=masks, **SMALL), labels)
    want.backward()
    torch.testing.assert_close(loss, want.detach(), rtol=1e-5, atol=1e-7)
    # Adam's first step moves every element by ~lr whatever its gradient's
    # size, so the moments are held to the reference's gradient (with the
    # L2 term) and the parameters to the update of the step's own moments
    o = OptimConfig()
    for name, p in m.named_parameters():
        g = w[name].grad + o.weight_decay * w0[name]
        moments = state.optimizer.state[p]
        mom, var = moments["exp_avg"], moments["exp_avg_sq"]
        # the gradient's bounds (above), times 1 - b1 and (1 - b2) 2 |g|
        torch.testing.assert_close(mom, (1 - o.adam_b1) * g, rtol=1e-4, atol=1e-7, msg=name)
        torch.testing.assert_close(var, (1 - o.adam_b2) * g * g, rtol=2e-4, atol=1e-10,
                                   msg=name)
        new = w0[name] - 1e-3 / (1 - o.adam_b1) * mom / (
            (var / (1 - o.adam_b2)).sqrt() + o.adam_eps)
        torch.testing.assert_close(p.detach(), new, rtol=1e-6, atol=1e-7, msg=name)


def test_the_coordinate_table_at_window_8_by_hand():
    t = swinv2.coords_table(8)
    assert t.shape == (225, 2)
    # rows run over dy then dx in -7..7; each offset d maps to
    # sign(d) log2(8 |d| / 7 + 1) / 3
    corner = math.log2(9.0) / 3
    torch.testing.assert_close(t[0], torch.tensor([-corner, -corner]))
    torch.testing.assert_close(t[112], torch.tensor([0.0, 0.0]))
    one = math.log2(8 / 7 + 1) / 3
    torch.testing.assert_close(t[112 + 1], torch.tensor([0.0, one]))
    torch.testing.assert_close(t[112 + 15], torch.tensor([one, 0.0]))
    torch.testing.assert_close(t[224], torch.tensor([corner, corner]))
    torch.testing.assert_close(t, ref.coords_table(8))
    idx = swinv2.relative_index(8)
    assert idx.shape == (64 * 64,) and int(idx[0]) == 112 and int(idx.max()) == 224
    # token 0 = (0, 0) against token 63 = (7, 7): offset (-7, -7), row 0
    assert int(idx[63]) == 0 and int(idx[63 * 64]) == 224
    assert torch.equal(idx, ref.relative_index(8))


@pytest.mark.parametrize("side,window,shift", [(16, 4, 2), (8, 4, 2), (64, 8, 4)])
def test_the_masks_follow_the_published_region_rule(side, window, shift):
    got = swinv2.region_mask(side, window, shift)
    assert torch.equal(got, ref.region_mask(side, window, shift))
    n = side // window
    # windows clear of the last window row and column see one region
    assert (got.view(n, n, -1)[:-1, :-1] == 0).all()
    # the corner window holds four regions of w/2 x w/2 tokens
    corner = got[-1]
    assert int((corner == 0).sum()) == 4 * (window * window // 4) ** 2
    assert set(got.unique().tolist()) == {-100.0, 0.0}


def test_the_window_layouts_are_roll_and_partition():
    x = torch.randn(2, 8, 8, 3)
    for shift in (0, 2):
        rolled = torch.roll(x, (-shift, -shift), (1, 2))
        want = rolled.view(2, 2, 4, 2, 4, 3).permute(0, 1, 3, 2, 4, 5).reshape(2, 64, 3)
        order = swinv2.window_order(8, 4, shift)
        assert torch.equal(x.reshape(2, 64, 3)[:, order], want)
    merge = swinv2.merge_order(4)
    y = torch.arange(16.0).view(1, 4, 4, 1)
    quads = y.reshape(1, 16, 1)[:, merge].view(1, 4, 4)
    assert quads[0, 0].tolist() == [0.0, 4.0, 1.0, 5.0]
    perm = torch.randperm(16)
    a = torch.randn(2, 16, 3, requires_grad=True)
    out = swinv2.TokenPermute.apply(a, perm, torch.argsort(perm))
    g = torch.randn(2, 16, 3)
    out.backward(g)
    torch.testing.assert_close(a.grad, torch.zeros_like(g).index_copy(1, perm, g))


def test_the_counters_and_the_tables_built_once():
    built = swinv2.tables_built.value
    m = _model()
    assert swinv2.tables_built.value == built + 4
    cpb, calls = swinv2.cpb_evaluations.value, swinv2.window_attention_calls.value
    state = init_train_state(m, OptimConfig())
    step = make_train_step(state, compute_dtype="f32", seed=1)
    step(torch.rand(2, 64, 64, 2), torch.rand(2, 1), 1e-4)
    with torch.no_grad():
        m.eval()(torch.rand(2, 2, 64, 64))
    assert swinv2.cpb_evaluations.value == cpb + 2 * 8
    assert swinv2.window_attention_calls.value == calls + 2 * 8
    assert swinv2.tables_built.value == built + 4
    names = {n for n, _ in m.named_buffers()}
    assert "layers.0.mask" in names and "layers.2.mask" not in names
    assert not any(n.endswith(("coords", "index", "mask", "keep")) for n in m.state_dict())


def test_the_train_step_spans_and_the_attention_range():
    from torch.profiler import ProfilerActivity, profile

    from crosstalk_tpu_torch.utils.profiling import span_self_seconds

    m = _model()
    state = init_train_state(m, OptimConfig())
    step = make_train_step(state, compute_dtype="f32", seed=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(torch.rand(2, 64, 64, 2), torch.rand(2, 1), 1e-4)
    spans = span_self_seconds()
    assert {"crosstalk.train.forward", "crosstalk.train.backward",
            "crosstalk.train.optimizer"} <= set(spans)
    ranges = [e for e in prof.events() if e.name == swinv2.WINDOW_ATTENTION_RANGE]
    assert len(ranges) == 8
    assert swinv2._attention_range() is swinv2._NO_RANGE  # no profiler: no range


def test_init_model_draws_the_cnns_as_before_and_swin_s_own():
    def before(model, gen):  # the draw before swinv2-b existed
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
                    bound = 1.0 / math.sqrt(mod.weight[0].numel())
                    mod.weight.uniform_(-bound, bound, generator=gen)
                    mod.bias.uniform_(-bound, bound, generator=gen)
        return model

    for cfg in (ModelConfig(variant="single", initial_filters=8, num_conv_blocks=3),
                ModelConfig(variant="double", initial_filters_per_branch=4)):
        a = init_model(build_model(cfg, image_size=32), torch.Generator().manual_seed(3))
        b = before(build_model(cfg, image_size=32), torch.Generator().manual_seed(3))
        for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(va, vb), k
    m = _model(9)
    for name, p in m.named_parameters():
        if name.endswith("logit_scale"):
            assert torch.all(p == math.log(10.0))
        elif name.endswith(("q_bias", "v_bias")):
            bound = 1 / math.sqrt(p.shape[0])
            assert p.abs().max() <= bound and p.abs().max() > bound / 2
        elif ".norm" in name or name.startswith("norm"):
            lo, hi = (0.8, 1.2) if name.endswith("weight") else (-0.1, 0.1)
            assert lo <= p.min() and p.max() <= hi, name
    assert not hasattr(m.layers[0].downsample.reduction, "bias") or \
        m.layers[0].downsample.reduction.bias is None


def test_the_cnn_only_paths_refuse_the_model_by_name(tmp_path):
    from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward
    from crosstalk_tpu_torch.eval.int8_forward import calibrate_int8, make_int8_forward
    from crosstalk_tpu_torch.io import checkpoint

    sd = _weights(_model())
    for call in (lambda: make_fast_forward(CFG, sd),
                 lambda: calibrate_int8(CFG, sd, torch.rand(2, 64, 64, 2)),
                 lambda: make_int8_forward(CFG, sd, {})):
        with pytest.raises(ValueError, match="'swinv2-b'"):
            call()
    ckpt = tmp_path / checkpoint.CKPT_DIR
    ckpt.mkdir()
    (ckpt / checkpoint.JAX_STATE_FILE).write_bytes(b"")
    (ckpt / checkpoint.JAX_META_FILE).write_text("{}")
    with pytest.raises(ValueError, match="'swinv2-b'"):
        checkpoint.load_checkpoint(str(tmp_path), variant="swinv2-b")
    with pytest.raises(ValueError, match="image size 48"):
        build_model(CFG, image_size=48)


@pytest.mark.parametrize("argv", [
    ["evaluate", "--fast"], ["predict", "--fast"], ["predict", "--int8"]])
def test_the_clis_refuse_the_fast_and_int8_tiers(argv, capsys):
    from crosstalk_tpu_torch.cli import evaluate, predict

    main = {"evaluate": evaluate.main, "predict": predict.main}[argv[0]]
    assert main(["-m", "x", "-s", "y", "-p", "m.pth", "-o", "swinv2-b", "--device", "cpu",
                 argv[1]]) == 1
    assert "swinv2-b" in capsys.readouterr().out


def test_the_final_shift_s_gradient_is_the_head_s_times_the_mean_residual():
    """The two leaves the cell's ``grad_gap`` leaves out: the final
    LayerNorm's shift reaches the output through the mean over tokens and
    the head alone, so its gradient is the head's weights times the output
    bias's gradient (twice the batch's mean residual)."""
    m = _model(4).train()
    x = torch.rand(3, 2, 64, 64, generator=torch.Generator().manual_seed(5))
    y = torch.rand(3, 1, generator=torch.Generator().manual_seed(6))
    F.mse_loss(m(x), y).backward()
    torch.testing.assert_close(m.norm.bias.grad, m.head.weight[0].detach() * m.head.bias.grad,
                               rtol=1e-4, atol=1e-8)
