"""Card-only tests of the port: the CUDA kernel against its plain PyTorch
version, and the serving path (predictor, batcher thread, f16 transport)
on the card. They skip on a host without an NVIDIA card (the kernel has no
CPU mode). This file imports neither JAX nor the test fixtures that do, so where
JAX is not installed it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -m cuda

Tolerance: one bf16 ulp (2**-7 relative) where |y| > 1e-3, 1e-5 absolute
elsewhere (both sides sum exact bf16 products in f32, in different orders:
the kernel's tensor cores and the plain version's f32 conv).
"""

import pytest
import torch

from crosstalk_tpu_torch.ops.input_block import (
    fused_input_block,
    fused_input_block_packed,
    fused_input_block_reference,
    pack_input_block,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False  # the plain version's f32 conv
    return torch.device("cuda")


def _inputs(device, batch, h, w, c_in, features, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(batch, h, w, c_in, device=device, generator=gen)
    kernel = torch.randn(3, 3, c_in, features, device=device, generator=gen) * 0.2
    scale = torch.randn(features, device=device, generator=gen) * 0.3 + 1.0
    scale[::5] = -scale[::5]
    bias = torch.randn(features, device=device, generator=gen) * 0.2
    return x, kernel, scale, bias


def _assert_within_one_ulp(got, want):
    got, want = got.float(), want.float()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    big = want.abs() > 1e-3
    assert ((got - want).abs()[big] / want.abs()[big]).max().item() <= 2.0 ** -7
    small = (got - want).abs()[~big]
    assert small.numel() == 0 or small.max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("batch,h,w,c_in,features", [
    (2, 32, 32, 2, 128), (3, 64, 64, 1, 64), (2, 30, 30, 1, 12), (2, 64, 64, 4, 200),
    (1, 20, 20, 3, 8),
    # pooled sizes that are not a multiple of the 8 x 64 pooled-pixel tile
    # or of a warp's 8-pixel group
    (1, 30, 30, 2, 128), (1, 258, 258, 2, 128), (1, 20, 34, 2, 128),
    (2, 20, 34, 1, 8),
    # F across the 8-channel n-tile, the 64-channel warp span and the
    # 128-channel slice
    (1, 32, 32, 2, 8), (1, 32, 32, 2, 12), (1, 34, 20, 2, 72),
    (1, 32, 32, 2, 200), (1, 30, 258, 2, 256),
    # C = 1-4 (K' = 16, 24, 32, 40)
    (1, 40, 24, 1, 128), (1, 24, 40, 3, 72), (1, 36, 36, 4, 256),
    # the main path's single-branch shape at B = 2
    (2, 256, 256, 2, 128),
])
def test_cuda_kernel_matches_plain_version(cuda_device, batch, h, w, c_in, features):
    x, kernel, scale, bias = _inputs(cuda_device, batch, h, w, c_in, features)
    before = fused_input_block.launches
    got = fused_input_block(x, kernel, scale, bias)
    torch.cuda.synchronize()
    assert fused_input_block.launches == before + 1
    _assert_within_one_ulp(got, fused_input_block_reference(x, kernel, scale, bias))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_block_diagonal(cuda_device):
    """The main path's two-branch shape at B = 2: both branches' C=1
    kernels as one C=2 -> 2x64 call with zeros off the diagonal."""
    x, _, scale, bias = _inputs(cuda_device, 2, 256, 256, 2, 128, seed=1)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    kernel = torch.zeros(3, 3, 2, 128, device=cuda_device)
    kernel[:, :, 0:1, :64] = torch.randn(3, 3, 1, 64, device=cuda_device, generator=gen) * 0.3
    kernel[:, :, 1:2, 64:] = torch.randn(3, 3, 1, 64, device=cuda_device, generator=gen) * 0.3
    got = fused_input_block(x, kernel, scale, bias)
    _assert_within_one_ulp(got, fused_input_block_reference(x, kernel, scale, bias))


@pytest.mark.cuda
def test_cuda_packed_and_public_entries_give_identical_bytes(cuda_device):
    x, kernel, scale, bias = _inputs(cuda_device, 2, 66, 62, 2, 200, seed=3)
    before = fused_input_block.launches
    public = fused_input_block(x, kernel, scale, bias)
    packed = fused_input_block_packed(x, pack_input_block(kernel, scale, bias))
    torch.cuda.synchronize()
    assert fused_input_block.launches == before + 2
    assert torch.equal(public.view(torch.int16), packed.view(torch.int16))


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.rand(1, 8, 8, 2, device=cuda_device)
    kernel = torch.rand(3, 3, 2, 8, device=cuda_device)
    scale, bias = torch.ones(8, device=cuda_device), torch.zeros(8, device=cuda_device)
    with pytest.raises(TypeError):
        fused_input_block(x.double(), kernel, scale, bias)
    with pytest.raises(ValueError):
        fused_input_block(x.transpose(1, 2), kernel, scale, bias)
    with pytest.raises(ValueError):
        fused_input_block(x, kernel, scale.cpu(), bias)


# --- the serving path on the card ------------------------------------------

def _small_checkpoint(variant, per_branch=4):
    """A small port model (8 filters, or ``per_branch`` per branch, 3 blocks
    at 32 px) with BN statistics moved off their init by three train-mode
    forwards on the CPU."""
    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.models.registry import build_model, init_model

    cfg = ModelConfig(variant=variant, initial_filters=8, num_conv_blocks=3,
                      initial_filters_per_branch=per_branch)
    model = init_model(build_model(cfg, image_size=32), torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    model.train()
    with torch.no_grad():
        for _ in range(3):
            model(torch.rand(4, 2, 32, 32, generator=gen))
    return cfg, model.eval().state_dict()


def _raw_tiles(n, seed=0):
    import numpy as np

    return (np.random.default_rng(seed).random((n, 32, 32, 2)) * 1800 + 100).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["single", "double"])
@pytest.mark.parametrize("mode", ["f32", "bf16", "fast"])
def test_cuda_predictor_matches_cpu_predictor(cuda_device, variant, mode):
    """The same weights through ``make_predictor`` on the card and on the
    CPU: 1e-5 for the f32 module (``compute_dtype='f32'``, TF32 off), 2e-3
    (a few bf16 steps) for the default bf16 module, 5e-4 for the bf16 fast
    path (K1 and cuDNN against the plain version and the CPU convs)."""
    import dataclasses

    import numpy as np

    from crosstalk_tpu_torch.serve.predictor import make_predictor

    cfg, sd = _small_checkpoint(variant)
    fast = mode == "fast"
    if mode == "f32":
        cfg = dataclasses.replace(cfg, compute_dtype="f32")
    before = fused_input_block.launches
    on_card = make_predictor(sd, cfg, (2, 4), image_size=32, fast=fast, device="cuda")
    assert fused_input_block.launches - before == (2 if fast else 0)  # warmup
    on_cpu = make_predictor(sd, cfg, (2, 4), image_size=32, fast=fast, device="cpu")
    raw = _raw_tiles(4)
    got, want = on_card(raw), on_cpu(raw)
    assert got.dtype == np.float32 and got.shape == (4,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol={"f32": 1e-5, "bf16": 2e-3, "fast": 5e-4}[mode])


@pytest.mark.cuda
def test_cuda_dispatch_from_the_batcher_thread_launches_k1(cuda_device):
    import numpy as np

    from crosstalk_tpu_torch.serve.batcher import DynamicBatcher
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    cfg, sd = _small_checkpoint("single")
    predict = make_predictor(sd, cfg, (2, 4), image_size=32, device="cuda")
    raw = _raw_tiles(7, seed=1)
    direct = np.concatenate([predict(raw[:4]), predict(raw[4:6]),
                             predict(np.concatenate([raw[6:], raw[:1]]))[:1]])
    batcher = DynamicBatcher(predict, batch_size=4, tile_shape=(32, 32, 2),
                             max_delay_ms=1.0, bucket_sizes=[2])
    try:
        before = fused_input_block.launches
        got = batcher.submit(raw).result(timeout=120)
        batches = batcher.stats()["batches"]
    finally:
        batcher.close()
    assert batches >= 2 and fused_input_block.launches - before == batches
    np.testing.assert_allclose(got, direct, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_server_with_f16_transport_returns_finite_alphas(cuda_device):
    import numpy as np

    from crosstalk_tpu_torch.serve.client import CrosstalkClient
    from crosstalk_tpu_torch.serve.predictor import make_predictor
    from crosstalk_tpu_torch.serve.server import CrosstalkServer

    cfg, sd = _small_checkpoint("double")
    predict = make_predictor(sd, cfg, 4, image_size=32, input_dtype=np.float16,
                             device="cuda")
    server = CrosstalkServer(predict, batch_size=4, image_size=32, port=0,
                             max_delay_ms=1.0, transport_dtype="float16")
    try:
        server.start_background()
        client = CrosstalkClient("http://%s:%d" % server.address, timeout=120)
        raw = _raw_tiles(5, seed=2).astype(np.float64) * 40  # beyond f16 range
        for wire in ("float16", "float32"):
            alphas = client.predict(raw, dtype=wire)
            assert alphas.shape == (5,) and np.isfinite(alphas).all()
        assert client.stats()["transport_dtype"] == "float16"
    finally:
        server.shutdown()


def _small_train_state(device, variant="single"):
    from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
    from crosstalk_tpu_torch.models.registry import build_model, init_model
    from crosstalk_tpu_torch.train.steps import init_train_state

    kw = (dict(initial_filters=8, num_conv_blocks=3, dropout_single=0.0)
          if variant == "single" else dict(initial_filters_per_branch=4, dropout_double=0.0))
    model = build_model(ModelConfig(variant=variant, compute_dtype="f32", **kw), image_size=32)
    init_model(model, torch.Generator().manual_seed(3))
    return init_train_state(model.to(device), OptimConfig())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["single", "double"])
def test_cuda_train_step_matches_cpu(cuda_device, variant):
    """Three f32 steps (TF32 off, flips on, dropout 0) from the same weights
    on the card and on the CPU: the flips are equal bit for bit; losses
    within rtol 2e-3 and eval predictions within 1e-4 (the bounds of the
    port-vs-JAX trajectory test)."""
    import numpy as np

    from crosstalk_tpu_torch.data.transforms import flip_bits
    from crosstalk_tpu_torch.train.steps import make_train_step

    index = torch.arange(1000)
    assert torch.equal(flip_bits(5, 7, index.to(cuda_device)).cpu(), flip_bits(5, 7, index))
    states = {d: _small_train_state(torch.device(d), variant) for d in ("cpu", "cuda")}
    steps = {d: make_train_step(s, compute_dtype="f32", seed=5) for d, s in states.items()}
    rng = np.random.default_rng(4)
    for i in range(3):
        raw = torch.from_numpy(_raw_tiles(8, seed=10 + i))
        y = torch.from_numpy(rng.uniform(0, 0.5, (8, 1)).astype(np.float32))
        want = float(steps["cpu"](raw, y, 1e-3))
        got = float(steps["cuda"](raw.to(cuda_device), y.to(cuda_device), 1e-3))
        np.testing.assert_allclose(got, want, rtol=2e-3, err_msg=f"step {i}")
    x = torch.from_numpy(_raw_tiles(4, seed=20)).permute(0, 3, 1, 2)
    x = (x - x.amin((2, 3), keepdim=True)) / (x.amax((2, 3), keepdim=True) - x.amin((2, 3), keepdim=True))
    with torch.no_grad():
        want = states["cpu"].model.eval()(x)
        got = states["cuda"].model.eval()(x.to(cuda_device)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_device_dataset_order_equals_iterate_batches(cuda_device, tmp_path):
    import numpy as np

    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import DeviceDataset, TileStore, iterate_batches
    from crosstalk_tpu_torch.data.synthetic import generate_dataset

    store = TileStore(PairIndex(*generate_dataset(
        str(tmp_path), num_pairs=13, size=16, seed=2, progress_every=0, block=4)).samples)
    resident = DeviceDataset(store, cuda_device)
    for kw in (dict(shuffle=True, drop_last=True, seed=3, epoch=2), {}):
        host = list(iterate_batches(store, 4, **kw))
        dev = list(resident.batches(4, **kw))
        assert len(host) == len(dev) > 1
        for h, d in zip(host, dev):
            assert d.inputs.is_cuda and d.labels.is_cuda and d.mask.is_cuda
            assert torch.equal(d.inputs.cpu(), torch.from_numpy(h.inputs))
            assert torch.equal(d.labels.cpu(), torch.from_numpy(h.labels))
            assert np.array_equal(d.ids, h.ids)
            assert torch.equal(d.mask.cpu(), torch.from_numpy(h.mask))


# --- the int8 tier and the AOT artifact on the card -------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,n", [(2, 32, 32, 128, 256), (1, 8, 8, 512, 512),
                                       (3, 10, 14, 64, 128), (2, 16, 16, 4, 12)])
def test_cuda_int8_block_matches_cpu_bitwise(cuda_device, b, h, w, c, n):
    """One int8 conv block from the same bf16 input, folded weights and
    clip: cuBLASLt's int32 accumulators and the bf16 block output equal the
    CPU's bit for bit. C_in = 4, N = 12 runs the GEMM with K = 36 and N
    zero-padded to multiples of 8."""
    from crosstalk_tpu_torch.eval.int8_forward import (
        _conv3x3_int8,
        _quant_act,
        conv_block_int8,
        prepare_conv_int8,
    )

    gen = torch.Generator().manual_seed(b * 7 + c)
    x = torch.randn(b, h, w, c, generator=gen).to(torch.bfloat16)
    kernel = torch.randn(3, 3, c, n, generator=gen) * 0.05
    scale = torch.randn(n, generator=gen) * 0.3 + 1.0
    scale[::3] *= -1
    bias = torch.randn(n, generator=gen) * 0.2
    out = {}
    for dev in ("cpu", "cuda"):
        blk = prepare_conv_int8(kernel.to(dev), scale.to(dev), bias.to(dev), 2.5)
        xd = x.to(dev)
        out[dev] = (_conv3x3_int8(_quant_act(xd, 2.5), blk.weight).cpu(),
                    conv_block_int8(xd, blk, 0.01).cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1].view(torch.int16), out["cpu"][1].view(torch.int16))


@pytest.mark.cuda
def test_cuda_int8_head_pads_short_batches(cuda_device):
    """``_int_mm`` on the card takes more than 16 rows, and K and N in
    multiples of 8: a batch of 2 is padded with zero rows, K = 60 and N = 12
    with zero columns, and each product equals the CPU's and the exact
    integer product."""
    from crosstalk_tpu_torch.eval.int8_forward import _int_mm

    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (2, 64), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (32, 64), generator=gen, dtype=torch.int8).t()
    for a_, b_ in ((a, b), (a[:, :60].contiguous(), b[:60]), (a, b[:, :12])):
        want = (a_.long() @ b_.long()).int()
        assert torch.equal(_int_mm(a_, b_), want)
        assert torch.equal(_int_mm(a_.cuda(), b_.cuda()).cpu(), want)


@pytest.mark.cuda
def test_cuda_int8_predictor_matches_cpu_and_launches_k1(cuda_device):
    """The int8 tier on the card against the CPU from one set of scales,
    within 2e-3: block 0 is K1 against its plain version (one bf16 ulp
    apart), which moves a few int8 activations by one step; blocks 1+ are
    exact. K1 is launched by the calibration and by every predict call."""
    import numpy as np

    from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
    from crosstalk_tpu_torch.eval.int8_forward import calibrate_int8
    from crosstalk_tpu_torch.serve.predictor import make_predictor

    cfg, sd = _small_checkpoint("single")
    raw = _raw_tiles(32, seed=4)
    before = fused_input_block.launches
    scales = calibrate_int8(cfg, {k: v.cuda() for k, v in sd.items()},
                            normalize_batch_nhwc(torch.from_numpy(raw).cuda()))
    assert fused_input_block.launches - before == 1
    on_card = make_predictor(sd, cfg, 32, image_size=32, device="cuda", int8_scales=scales)
    on_cpu = make_predictor(sd, cfg, 32, image_size=32, device="cpu", int8_scales=scales)
    before = fused_input_block.launches
    got = on_card(raw)
    assert fused_input_block.launches - before == 1
    np.testing.assert_allclose(got, on_cpu(raw), rtol=0, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["single", "double"])
@pytest.mark.parametrize("int8_dense", [False, True], ids=["bf16_head", "int8_head"])
def test_cuda_int8_after_block0_matches_cpu(cuda_device, variant, int8_dense):
    """Everything after block 0 on the card against the CPU, one set of
    scales: the trunk (the int8 blocks, the concat, the flatten) from one
    block-0 output bitwise; the head (the two-branch sigmoid included) from
    one feature tensor within 1e-6 for the int8 head (the last product sums
    f32 in another order) and within the bf16 fast path's 5e-4 for the bf16
    head (its bf16 casts between the layers round some of those f32
    differences apart: 7.1e-5 measured on an H100). The predictions spread
    over more than 1e-3. The two-branch model has 4 filters per branch, so
    its block 1 is a GEMM with K = 9 * 4 = 36, zero-padded to 40."""
    from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
    from crosstalk_tpu_torch.eval.fast_forward import make_first_block
    from crosstalk_tpu_torch.eval.int8_forward import (
        calibrate_int8,
        make_int8_head,
        make_int8_trunk,
    )

    cfg, sd = _small_checkpoint(variant)
    if variant == "double":  # so that its sigmoid outputs spread apart
        key = "regression_head.fc_layers.9.weight"
        sd[key] = sd[key] * 16
    on_card = {k: v.cuda() for k, v in sd.items()}
    x = normalize_batch_nhwc(torch.from_numpy(_raw_tiles(32, seed=6)))
    scales = calibrate_int8(cfg, sd, x, int8_dense=int8_dense)
    with torch.inference_mode():
        block0 = make_first_block(cfg, sd)(x)
        feats = make_int8_trunk(cfg, sd, scales)(block0)
        got_feats = make_int8_trunk(cfg, on_card, scales)([h.cuda() for h in block0]).cpu()
        want = make_int8_head(cfg, sd, scales)(feats)
        got = make_int8_head(cfg, on_card, scales)(feats.cuda()).cpu()
    assert torch.equal(got_feats.view(torch.int16), feats.view(torch.int16))
    spread = float(want.max() - want.min())
    assert spread > 1e-3
    tol = 1e-6 if int8_dense else 5e-4
    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["fast", "int8"])
def test_cuda_artifact_exported_and_loaded_on_the_card(cuda_device, tmp_path, tier):
    """An artifact traced on the card loads there and matches the live
    tier without the kernel within 1e-6; it refuses the CPU."""
    import numpy as np

    from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
    from crosstalk_tpu_torch.eval.int8_forward import calibrate_int8
    from crosstalk_tpu_torch.io.export import (
        export_serving_model,
        load_exported,
        make_forward,
        save_exported,
    )

    cfg, sd = _small_checkpoint("single")
    raw = _raw_tiles(6, seed=5)
    scales = None
    if tier == "int8":
        scales = calibrate_int8(cfg, {k: v.cuda() for k, v in sd.items()},
                                normalize_batch_nhwc(torch.from_numpy(raw).cuda()),
                                use_kernel=False)
    program, weights = export_serving_model(sd, cfg, None, image_size=32, device="cuda",
                                            int8_scales=scales)
    path = str(tmp_path / "m.ctkt")
    save_exported(path, program, weights, {"device": "cuda", "batch_size": "dynamic"})
    fn, _ = load_exported(path)
    live = make_forward(cfg, sd, device="cuda", use_kernel=False, int8_scales=scales)
    with torch.inference_mode():
        want = live(torch.from_numpy(raw).cuda()).cpu().numpy()
    np.testing.assert_allclose(fn(raw), want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="exported for device type 'cuda'"):
        load_exported(path, device="cpu")


# --- data parallel on the card ----------------------------------------------

def _env_for_ranks():
    import os
    from pathlib import Path

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1])
    return env


@pytest.mark.cuda
def test_cuda_nccl_one_rank_step_is_bitwise_the_plain_step(cuda_device):
    """A one-rank NCCL group (DDP's gradient mean and the loss mean divide
    by 1): the first step's loss, every gradient and the parameters after
    it equal the plain step's bit for bit (deterministic cuDNN)."""
    import torch.distributed as dist

    from crosstalk_tpu_torch.parallel.distributed import free_port, initialize
    from crosstalk_tpu_torch.train.steps import make_train_step

    group = initialize(f"localhost:{free_port()}", 1, 0, device_type="cuda", timeout_s=60)
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        out = {}
        for name, pg in (("plain", None), ("nccl", group)):
            state = _small_train_state(cuda_device)
            step = make_train_step(state, compute_dtype="bf16", seed=5, process_group=pg)
            raw = torch.from_numpy(_raw_tiles(8, seed=11)).to(cuda_device)
            y = torch.linspace(0, 0.5, 8, device=cuda_device).view(8, 1)
            loss = step(raw, y, 1e-3)
            out[name] = (loss.cpu(), {n: p.grad.cpu() for n, p in state.model.named_parameters()},
                         {k: v.cpu() for k, v in state.model.state_dict().items()})
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
        dist.destroy_process_group()
    (l0, g0, s0), (l1, g1, s1) = out["plain"], out["nccl"]
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


@pytest.mark.cuda
def test_cuda_two_gloo_ranks_on_one_card_equal_one_rank(cuda_device, tmp_path):
    """Two Gloo ranks share the card (NCCL refuses two ranks on one GPU):
    one f32 step at global batch 8 equals the one-process step on the card:
    loss rtol 1e-5, gradients 1e-4 x each leaf's max |g| + 1e-7 (the
    biases a BatchNorm follows left out), statistics 1e-5 of the leaf's
    largest value, parameters 2 x lr plus two float32 ulps of the leaf's
    largest value."""
    import subprocess
    import sys

    import numpy as np

    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.parallel.distributed import free_port
    from crosstalk_tpu_torch.tools.multirank import run_steps

    rng = np.random.default_rng(7)
    inputs = _raw_tiles(8, seed=12)
    labels = rng.uniform(0, 0.5, (8, 1)).astype(np.float32)
    np.savez(tmp_path / "batch.npz", inputs=inputs, labels=labels)
    lr, port = 1e-5, free_port()
    argv = ["--world", "2", "--port", str(port), "--out", str(tmp_path), "--data",
            str(tmp_path / "batch.npz"), "--initial_filters", "8", "--num_conv_blocks", "3",
            "--dropout", "0", "--lr", str(lr), "--augment", "--device", "cuda:0",
            "--backend", "gloo"]
    procs = [subprocess.Popen([sys.executable, "-m", "crosstalk_tpu_torch.tools.multirank",
                               "step", "--rank", str(r), *argv], env=_env_for_ranks())
             for r in (0, 1)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    two = torch.load(tmp_path / "rank0.pt", weights_only=False)
    cfg = ModelConfig(initial_filters=8, num_conv_blocks=3, compute_dtype="f32",
                      dropout_single=0.0)
    one = run_steps(cfg, 32, torch.from_numpy(inputs).to(cuda_device),
                    torch.from_numpy(labels).to(cuda_device), lr, augment=True)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    shadowed = {k for k in one["grads"] if k.endswith(".bias") and
                f"{k.rsplit('.', 2)[0]}.{int(k.split('.')[-2]) + 1}.running_mean" in one["state"]}
    for k, g in one["grads"].items():
        if k in shadowed:
            continue
        assert float((two["grads"][k] - g).abs().max()) <= 1e-4 * float(g.abs().max()) + 1e-7, k
    for k, v in one["state"].items():
        diff = float((two["state"][k].double() - v.double()).abs().max())
        if "running" in k:
            assert diff <= 1e-5 * float(v.abs().max()) + 1e-7, k
        elif k.endswith(("weight", "bias")):  # + the f32 rounding of p - lr * u
            assert diff <= 2 * lr + 2.0 ** -22 * float(v.abs().max()), k


@pytest.mark.cuda
def test_cuda_replica_predictor_equals_one_replica(cuda_device):
    """A [cuda:0, cuda:0] replica set: each replica runs K1, and the batch
    of 4 equals one replica's two batches of 2 bit for bit, and one
    replica's batch of 4 within the card's --fast envelope (5e-4)."""
    import numpy as np

    from crosstalk_tpu_torch.serve.predictor import make_predictor

    cfg, sd = _small_checkpoint("single")
    one = make_predictor(sd, cfg, (2, 4), image_size=32, device="cuda")
    before = fused_input_block.launches
    two = make_predictor(sd, cfg, (2, 4), image_size=32, devices=["cuda:0", "cuda:0"])
    assert fused_input_block.launches - before == 4  # two buckets x two replicas
    raw = _raw_tiles(4, seed=3)
    got = two(raw)
    np.testing.assert_array_equal(got, np.concatenate([one(raw[:2]), one(raw[2:])]))
    np.testing.assert_allclose(got, one(raw), rtol=0, atol=5e-4)


# --- the dispatcher and doctor on the card ----------------------------------

@pytest.mark.cuda
def test_cuda_doctor_passes_and_builds_k1(cuda_device, tmp_path, capsys):
    from crosstalk_tpu_torch.__main__ import main as dispatch
    from crosstalk_tpu_torch.io.torch_convert import save_pth

    ckpt = str(tmp_path / "m.pth")
    save_pth(ckpt, _small_checkpoint("single")[1])
    before = fused_input_block.launches
    assert dispatch(["doctor", "-p", ckpt, "--image_size", "32"]) == 0
    out = capsys.readouterr().out
    for check in ("devices", "kernel build cache", "native TIFF decoder", "--fast forward",
                  "checkpoint"):
        assert f"  ok    {check} " in out, check
    assert "K1 libinput_block_" in out and "K1 launched 2x on the card" in out
    assert fused_input_block.launches - before == 2


@pytest.mark.cuda
def test_cuda_dispatcher_evaluate_fast_launches_k1(cuda_device, tmp_path):
    import csv
    import glob
    import math

    from crosstalk_tpu_torch.__main__ import main as dispatch
    from crosstalk_tpu_torch.data.synthetic import generate_dataset
    from crosstalk_tpu_torch.io.torch_convert import save_pth

    mixed, source = generate_dataset(str(tmp_path / "data"), num_pairs=10, size=32, seed=1,
                                     progress_every=0, block=4)
    ckpt = str(tmp_path / "m.pth")
    save_pth(ckpt, _small_checkpoint("single")[1])
    before = fused_input_block.launches
    assert dispatch(["evaluate", "-m", mixed, "-s", source, "-p", ckpt, "--fast",
                     "--batch_size", "4", "--output_base", str(tmp_path / "out")]) == 0
    assert fused_input_block.launches - before == math.ceil(10 / 4)
    (path,) = glob.glob(str(tmp_path / "out" / "eval_run_*" / "test_predictions_*.csv"))
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 10 and all(math.isfinite(float(r["Predicted_Label"])) for r in rows)
