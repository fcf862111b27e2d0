"""``ops/window_attention.py`` on the CPU.

The plain version of the window-attention kernels
(``window_attention_reference``: the kernels' algorithm with its own
backward, the bias-row rule and the chunked, fixed-order sums of the bias's
and scales' gradients) is held in float32 against the model's present path
(``F.rms_norm`` on q and k, the scale folded into q,
``F.scaled_dot_product_attention`` with the bias as its float mask, as
``models/swinv2.WindowAttention`` runs it off the card): the output and the
gradients of qkv, bias and scale, at the four SwinV2-B stages' (windows a
tile, heads, channels), plain and shifted, at batch 2. Both sides compute
in float32 with the same roundings (none), and differ only in the order of
their sums: bounds 1e-5 relative. In bf16 the plain version rounds where
the kernels round; it is held against the present path under the CPU's
bf16 autocast within that path's own bf16 rounding. The model keeps its
present path on the CPU, in float32 and in bf16, and launches nothing;
with ``takes`` patched to accept CPU tensors its attention runs through
``WindowAttentionFn`` and its gradients equal the present path's. The card
tests
(tests/test_torch_port_cuda.py) hold the kernels against the plain
version.
"""

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
from crosstalk_tpu_torch.models import swinv2
from crosstalk_tpu_torch.models.registry import build_model, init_model
from crosstalk_tpu_torch.ops import window_attention
from crosstalk_tpu_torch.ops.window_attention import (
    backward_reference,
    chunk_size,
    forward_reference,
    window_attention_reference,
)
from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step

# SwinV2-B at 256², window 8: (windows a tile, heads, channels) per stage;
# stages 0-2 shift in odd blocks, stage 3's map is the window
STAGES = [(64, 4, 128), (16, 8, 256), (4, 16, 512), (1, 32, 1024)]
CASES = [(s, shifted) for s in range(4) for shifted in (False, True) if s < 3 or not shifted]
IDS = [f"stage{s}-{'shifted' if sh else 'plain'}" for s, sh in CASES]


def present_path(qkv, bias, scale, heads):
    """``WindowAttention.forward`` between the qkv projection and the
    output projection, as the model runs it off the card."""
    bw, n, _ = qkv.shape
    q, k, v = qkv.view(bw, n, 3, heads, -1).permute(2, 0, 3, 1, 4).unbind(0)
    d = q.shape[-1]
    q = F.rms_norm(q, (d,), eps=swinv2.NORM_EPS) * scale
    k = F.rms_norm(k, (d,), eps=swinv2.NORM_EPS)
    if bias.shape[1] != heads:
        hw = bias.shape[1]
        q, k, v = (t.reshape(bw * heads // hw, hw, n, d) for t in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0 / d)
    return out.reshape(bw, heads, n, d).transpose(1, 2).reshape(bw, n, heads * d)


def attention_inputs(stage, shifted, batch, seed, dtype=torch.float32):
    """qkv (B nW, 64, 3c), the bias (16 sigmoid of a draw, plus the -100
    region mask of the stage's map where shifted) and logit scales near
    the published 10, as the model makes them."""
    nw, h, c = STAGES[stage]
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(batch * nw, 64, 3 * c, generator=gen)
    table = 16 * torch.sigmoid(torch.randn(1, h, 64, 64, generator=gen))
    if shifted:
        side = 8 * int(nw ** 0.5)
        mask = swinv2.region_mask(side, 8, 4)  # (nW, 64, 64)
        bias = (table + mask.unsqueeze(1)).reshape(1, nw * h, 64, 64)
    else:
        bias = table
    scale = torch.exp(torch.log(torch.tensor(10.0)) + 0.3 * torch.randn(h, 1, 1, generator=gen))
    return [t.to(dtype).requires_grad_() for t in (qkv, bias, scale)]


def _grads(fn, inputs, g):
    out = fn(*inputs)
    return [out.detach()] + list(torch.autograd.grad(out, inputs, g))


@pytest.mark.parametrize("stage,shifted", CASES, ids=IDS)
def test_the_reference_matches_the_present_path_in_f32(stage, shifted):
    qkv, bias, scale = attention_inputs(stage, shifted, 2, seed=stage)
    h = STAGES[stage][1]
    g = torch.randn(qkv.shape[0], 64, qkv.shape[2] // 3,
                    generator=torch.Generator().manual_seed(9))
    want = _grads(lambda *t: present_path(*t, h), (qkv, bias, scale), g)
    got = _grads(lambda *t: window_attention_reference(*t, h), (qkv, bias, scale), g)
    for name, a, b in zip(("out", "qkv", "bias", "scale"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()),
                                   msg=name)


def test_the_reference_in_bf16_stays_within_the_present_path_s_own_rounding():
    """Under the CPU's bf16 autocast the present path rounds q and k after
    the norm, P and the output; the plain version rounds s u, w, P and the
    output. Each is held to the float32 result, the plain version within
    twice the present path's distance from it."""
    stage, shifted, h = 1, True, STAGES[1][1]
    f32 = attention_inputs(stage, shifted, 2, seed=4)
    low = [t.detach().to(torch.bfloat16).requires_grad_() for t in f32]
    g = torch.randn(f32[0].shape[0], 64, f32[0].shape[2] // 3,
                    generator=torch.Generator().manual_seed(5))
    exact = _grads(lambda *t: present_path(*t, h),
                   [t.detach().float().requires_grad_() for t in low], g)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        chain = _grads(lambda *t: present_path(*t, h), low, g.bfloat16())
    plain = _grads(lambda *t: window_attention_reference(*t, h), low, g.bfloat16())
    for name, a, b, e in zip(("out", "qkv", "bias", "scale"), plain, chain, exact):
        assert a.dtype == torch.bfloat16, name
        far = float((b.float() - e).norm() / e.norm())
        assert float((a.float() - e).norm() / e.norm()) <= max(2 * far, 1e-2), name


def test_the_chunked_sums_run_in_window_order_then_chunk_order():
    t = torch.randn(10, 3, generator=torch.Generator().manual_seed(1)) * 1e3
    want = [t[0] + t[1] + t[2] + t[3], t[4] + t[5] + t[6] + t[7], t[8] + t[9]]
    assert torch.equal(window_attention._chunked_sum(t, 4), want[0] + want[1] + want[2])
    # the chunk changes only the order of the bias's and scales' sums
    qkv, bias, scale = (x.detach() for x in attention_inputs(0, False, 2, seed=2))
    out, stats = forward_reference(qkv.view(128, 64, 3, 4, 32), bias, scale)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    by = [backward_reference(qkv.view(128, 64, 3, 4, 32), bias, scale, stats, g, chunk)
          for chunk in (1, 7, 16, 128)]
    for other in by[1:]:
        assert torch.equal(other[0], by[0][0])
        torch.testing.assert_close(other[1], by[0][1], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(other[2], by[0][2], rtol=1e-5, atol=1e-5)


def test_the_chunks_at_batch_128():
    """(bias rows, windows a row) of each SwinV2-B block at batch 128 ->
    windows a block of the backward kernel sums, and blocks, on an H100
    (396 resident blocks): one full wave where the rows allow it."""
    plan = {}
    for nw, h, _ in STAGES:
        for rows in sorted({h, nw * h}):
            windows = 128 * nw * h // rows
            chunk = chunk_size(rows, windows)
            plan[(rows, windows)] = (chunk, rows * -(-windows // chunk))
    assert plan == {(4, 8192): (83, 396), (256, 128): (43, 768),
                    (8, 2048): (42, 392), (128, 128): (43, 384),
                    (16, 512): (22, 384), (64, 128): (22, 384),
                    (32, 128): (11, 384)}
    assert chunk_size(4, 8192, slots=4 * 132) == 63


def _fake_cuda(stage, shifted, batch=128, dtype=torch.bfloat16):
    nw, h, c = STAGES[stage]
    with FakeTensorMode():
        qkv = torch.empty(batch * nw, 64, 3, h, c // h, dtype=dtype, device="cuda")
        bias = torch.empty(1, nw * h if shifted else h, 64, 64, dtype=dtype, device="cuda")
        scale = torch.empty(h, 1, 1, dtype=dtype, device="cuda")
    return qkv, bias, scale


@pytest.mark.parametrize("stage,shifted", CASES, ids=IDS)
def test_the_kernels_take_every_block_of_swinv2_b_in_bf16_on_the_card(stage, shifted):
    assert window_attention.takes(*_fake_cuda(stage, shifted))


@pytest.mark.parametrize("case", ["cpu", "f32", "window_4", "head_16", "rows", "strided"])
def test_the_kernels_do_not_take(case):
    qkv, bias, scale = _fake_cuda(1, True, batch=2,
                                  dtype=torch.float32 if case == "f32" else torch.bfloat16)
    with FakeTensorMode():
        if case == "window_4":
            qkv = torch.empty(2 * 16, 16, 3, 8, 32, dtype=torch.bfloat16, device="cuda")
        if case == "head_16":
            qkv = torch.empty(2 * 16, 64, 3, 16, 16, dtype=torch.bfloat16, device="cuda")
        if case == "rows":  # 3 window positions do not divide 32 windows
            bias = torch.empty(1, 3 * 8, 64, 64, dtype=torch.bfloat16, device="cuda")
        if case == "strided":
            qkv = torch.empty(64, 2 * 16, 3, 8, 32, dtype=torch.bfloat16,
                              device="cuda").transpose(0, 1)
    if case == "cpu":
        qkv, bias, scale = (torch.empty(t.shape, dtype=t.dtype) for t in (qkv, bias, scale))
    assert not window_attention.takes(qkv, bias, scale)


SMALL = ModelConfig(variant="swinv2-b", swin_embed_dim=16, swin_depths=(2, 2, 2, 2),
                    swin_heads=(1, 2, 2, 4), swin_window=4, compute_dtype="f32")


def _step(compute_dtype, seed=3):
    model = build_model(SMALL, image_size=64)
    init_model(model, torch.Generator().manual_seed(seed))
    state = init_train_state(model, OptimConfig())
    step = make_train_step(state, compute_dtype=compute_dtype, seed=seed, augment=False)
    gen = torch.Generator().manual_seed(seed + 1)
    loss = step(torch.rand(2, 64, 64, 2, generator=gen), torch.rand(2, 1, generator=gen), 1e-3)
    return loss, {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
def test_the_model_keeps_its_present_path_on_the_cpu(compute_dtype, monkeypatch):
    before = (window_attention.window_attention_forward.launches,
              window_attention.window_attention_backward.launches)
    calls = []
    monkeypatch.setattr(window_attention, "WindowAttentionFn",
                        type("Spy", (), {"apply": staticmethod(lambda *a: calls.append(a))}))
    loss, _ = _step(compute_dtype)
    assert bool(torch.isfinite(loss)) and not calls
    assert (window_attention.window_attention_forward.launches,
            window_attention.window_attention_backward.launches) == before


def _loss_and_grads(seed=6):
    model = build_model(SMALL, image_size=64).eval()  # no drop path
    init_model(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    x, y = torch.rand(3, 2, 64, 64, generator=gen), torch.rand(3, 1, generator=gen)
    loss = F.mse_loss(model(x), y)
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in model.named_parameters()}


def test_the_model_through_the_function_equals_the_present_path(monkeypatch):
    """Window 4 and heads of 16 channels: with ``takes`` patched, every
    block's attention runs the plain version through ``WindowAttentionFn``
    (which takes any window and head size on the CPU); the loss and every
    parameter's gradient equal the present path's in float32."""
    loss, want = _loss_and_grads()
    used = []
    fn = window_attention.WindowAttentionFn

    class Counting(fn):
        @staticmethod
        def forward(ctx, *a):
            used.append(tuple(a[0].shape))
            return fn.forward(ctx, *a)

    monkeypatch.setattr(window_attention, "takes", lambda *a: True)
    monkeypatch.setattr(window_attention, "WindowAttentionFn", Counting)
    got_loss, got = _loss_and_grads()
    assert len(used) == 8 and used[0] == (3 * 16, 16, 3, 1, 16)
    torch.testing.assert_close(got_loss, loss, rtol=1e-5, atol=1e-8)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6, msg=k)
