"""Card-only tests of the port: the CUDA kernel K1 against its plain PyTorch
version, the serving path (predictor, batcher thread, f16 transport), the
chunked BatchNorm backward (``models/layers.ChunkedBatchNorm2d``) and the
LeakyReLU + max-pool kernels (``ops/leaky_pool.py``) on the card. They
skip on a host without an NVIDIA card (the kernels have no CPU mode). This
file imports neither JAX nor the test fixtures that do, so where JAX is not
installed it runs, with ``tests/test_torch_port_cuda_cli.py``, as

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_port_cuda*.py

Tolerance for K1: one bf16 ulp (2**-7 relative) where |y| > 1e-3, 1e-5
absolute elsewhere (both sides sum exact bf16 products in f32, in different
orders: the kernel's tensor cores and the plain version's f32 conv). The
LeakyReLU + max-pool kernels are held bit for bit against torch's CUDA
chain.
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


def _assert_matches_plain_version(got, x, kernel, scale, bias, rows=64):
    """K1's bf16 output against its plain version ``rows`` rows at a time
    (the plain version's f32 conv output of 512 full tiles is 17 GB)."""
    b, h, w, _ = x.shape
    assert got.dtype == torch.bfloat16 and got.shape == (b, h // 2, w // 2, kernel.shape[-1])
    for i in range(0, b, rows):
        _assert_within_one_ulp(got[i:i + rows],
                               fused_input_block_reference(x[i:i + rows], kernel, scale, bias))


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
    # the main path's single-branch shape at B = 2, and at the batches of
    # the eval CLI and the score cell (64), the int8 tier probe (100), the
    # benchmark entry point (512), the two-branch probes (8) and 256
    (2, 256, 256, 2, 128), (8, 256, 256, 2, 128), (64, 256, 256, 2, 128),
    (100, 256, 256, 2, 128), (256, 256, 256, 2, 128), (512, 256, 256, 2, 128),
])
def test_cuda_kernel_matches_plain_version(cuda_device, batch, h, w, c_in, features):
    x, kernel, scale, bias = _inputs(cuda_device, batch, h, w, c_in, features)
    before = fused_input_block.launches
    got = fused_input_block(x, kernel, scale, bias)
    torch.cuda.synchronize()
    assert fused_input_block.launches == before + 1
    _assert_matches_plain_version(got, x, kernel, scale, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 8, 64, 100, 256, 512])
def test_cuda_kernel_matches_plain_version_block_diagonal(cuda_device, batch):
    """The main path's two-branch shape: both branches' C=1 kernels as one
    C=2 -> 2x64 call with zeros off the diagonal."""
    x, _, scale, bias = _inputs(cuda_device, batch, 256, 256, 2, 128, seed=1)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    kernel = torch.zeros(3, 3, 2, 128, device=cuda_device)
    kernel[:, :, 0:1, :64] = torch.randn(3, 3, 1, 64, device=cuda_device, generator=gen) * 0.3
    kernel[:, :, 1:2, 64:] = torch.randn(3, 3, 1, 64, device=cuda_device, generator=gen) * 0.3
    got = fused_input_block(x, kernel, scale, bias)
    _assert_matches_plain_version(got, x, kernel, scale, bias)


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


def _in_ram_store(n, size, seed=0):
    import numpy as np

    from crosstalk_tpu_torch.data.index import Sample
    from crosstalk_tpu_torch.data.pipeline import TileStore

    rng = np.random.default_rng(seed)
    store = TileStore.__new__(TileStore)
    alphas = rng.uniform(0.01, 0.5, n)
    store.samples = [Sample(str(i), float(a), "", "") for i, a in enumerate(alphas)]
    store.labels = alphas.astype(np.float32).reshape(-1, 1)
    store.ids = np.arange(n, dtype=np.int64)
    store.tiles = rng.random((n, size, size, 2), dtype=np.float32)
    return store


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(shuffle=True, drop_last=True, seed=3, epoch=2),
                                dict(shuffle=True, seed=1, assemble_rows=slice(2, 6))])
def test_cuda_pinned_batches_are_byte_identical_to_the_host_ones(cuda_device, kw):
    """The producer thread's batches, assembled straight into pinned memory
    and copied to the card, hold the bytes of ``iterate_batches``' own."""
    import numpy as np

    from crosstalk_tpu_torch.data.pipeline import device_batches, iterate_batches

    store = _in_ram_store(61, 16)  # more batches than the ring has slots
    host = list(iterate_batches(store, 8, **kw))
    dev = list(device_batches(iterate_batches(store, 8, **kw), cuda_device))
    assert len(host) == len(dev) > 0
    for h, d in zip(host, dev):
        assert d.inputs.is_cuda and d.labels.is_cuda and d.mask.is_cuda
        for field in ("inputs", "labels", "mask"):
            got = getattr(d, field).cpu().numpy()
            assert got.tobytes() == getattr(h, field).tobytes(), field
        assert np.array_equal(d.ids, h.ids)


@pytest.mark.cuda
def test_cuda_score_passes_equal_a_serial_run_and_stop_allocating_pinned_memory(cuda_device):
    """Five passes of ``evaluate`` with the fast forward over an in-RAM
    store (batches assembled on the producer thread into pinned memory)
    give the rows of a run that has no host pipeline (a ``DeviceDataset``);
    the first pass allocates at most one pinned block per slot of the
    pipeline's ring, and no pass after it allocates any."""
    import threading

    import numpy as np

    from crosstalk_tpu_torch.config import ModelConfig
    from crosstalk_tpu_torch.data.pipeline import _SLOTS, DeviceDataset
    from crosstalk_tpu_torch.eval.engine import evaluate
    from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward
    from crosstalk_tpu_torch.models.registry import build_model

    size = 64
    cfg = ModelConfig(initial_filters=8, num_conv_blocks=3, compute_dtype="bf16")
    torch.manual_seed(0)
    model = build_model(cfg, image_size=size).eval()
    forward = make_fast_forward(cfg, {k: v.to(cuda_device)
                                      for k, v in model.state_dict().items()})
    store = _in_ram_store(400, size)  # seven batches of 64, the last one padded
    want, want_loss = evaluate(forward, DeviceDataset(store, cuda_device), cuda_device,
                               batch_size=64)
    threads = threading.active_count()

    def host_allocs():
        return torch.cuda.host_memory_stats()["num_host_alloc"]

    allocs = []
    before = host_allocs()
    for _ in range(5):
        got, loss = evaluate(forward, store, cuda_device, batch_size=64)
        allocs.append(host_allocs())
        assert loss == want_loss
        assert [list(r) for r in got] == [list(r) for r in want]
        for a, b in zip(got, want):
            for k in a:
                assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k
        assert threading.active_count() == threads
    assert 0 < allocs[0] - before <= _SLOTS and allocs[1:] == [allocs[0]] * 4, (
        before, allocs)


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
    save_exported(path, {"cuda": program}, weights, {"batch_size": "dynamic"})
    fn, _ = load_exported(path)
    live = make_forward(cfg, sd, device="cuda", use_kernel=False, int8_scales=scales)
    with torch.inference_mode():
        want = live(torch.from_numpy(raw).cuda()).cpu().numpy()
    np.testing.assert_allclose(fn(raw), want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="exported for device type 'cuda'"):
        load_exported(path, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["single", "double"])
def test_cuda_two_platform_artifact_runs_on_each_device_type(cuda_device, tmp_path, variant):
    """``platforms=('cuda', 'cpu')``: one file, each program traced on its
    own device type, each against the live forward of its device without
    the kernel within 1e-6; the card's program is the default."""
    import numpy as np

    from crosstalk_tpu_torch.io.export import (
        export_serving_programs,
        load_exported,
        make_forward,
        save_exported,
    )

    cfg, sd = _small_checkpoint(variant)
    programs, weights = export_serving_programs(sd, cfg, image_size=32,
                                                platforms=("cuda", "cpu"))
    path = str(tmp_path / "m.ctkt")
    save_exported(path, programs, weights, {"batch_size": "dynamic"})
    raw = _raw_tiles(5, seed=6)
    for device in (None, "cuda", "cpu"):
        fn, meta = load_exported(path, device=device)
        live = make_forward(cfg, sd, device=device or "cuda", use_kernel=False)
        with torch.inference_mode():
            want = live(torch.from_numpy(raw).to(device or "cuda")).cpu().numpy()
        np.testing.assert_allclose(fn(raw), want, rtol=0, atol=1e-6)
    assert meta["platforms"] == ["cuda", "cpu"]


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


# --- the chunked BatchNorm backward past int32 indexing ---------------------

def _bn_pair(device, c, dtype, seed):
    """A ``ChunkedBatchNorm2d`` and an ``nn.BatchNorm2d`` in train mode with
    the same affine and running statistics, off their init values."""
    from crosstalk_tpu_torch.models.layers import ChunkedBatchNorm2d

    gen = torch.Generator(device=device).manual_seed(seed)
    plain = torch.nn.BatchNorm2d(c, device=device, dtype=dtype)
    with torch.no_grad():
        plain.weight.copy_(torch.rand(c, device=device, generator=gen) + 0.5)
        plain.bias.copy_(torch.randn(c, device=device, generator=gen))
        plain.running_mean.copy_(torch.randn(c, device=device, generator=gen) * 0.1)
        plain.running_var.copy_(torch.rand(c, device=device, generator=gen) + 0.5)
    bn = ChunkedBatchNorm2d(c, device=device, dtype=dtype)
    bn.load_state_dict(plain.state_dict())
    return bn.train(), plain.train()


def _channels_last_randn(shape, dtype, gen, device):
    n, c, h, w = shape
    return torch.randn(n, h, w, c, dtype=dtype, device=device, generator=gen).permute(0, 3, 1, 2)


def _bn_step(m, x, dy):
    """-> (output, (grad input, grad weight, grad bias), running mean, var,
    batches tracked) of one train-mode forward and backward of ``m``."""
    leaf = x.detach().requires_grad_()
    out = m(leaf)
    grads = torch.autograd.grad(out, [leaf, m.weight, m.bias], dy)
    return out.detach(), grads, *(t.clone() for t in m.buffers())


def _assert_bn_matches(got, want, atol_share, affine=True):
    """Output and running statistics bit for bit; weight and bias gradients
    (unless ``affine`` is False) within ``atol_share`` x the leaf's largest
    |g|; the input gradient within one ulp of its dtype per element where
    it is bf16 (each side rounds an f32 value whose sums were added in
    another order), else within ``atol_share`` x its largest |g|, and as a
    whole (L2) within ``atol_share`` of it."""
    (o1, g1, *s1), (o2, g2, *s2) = got, want
    assert torch.equal(o1, o2), float((o1 - o2).abs().max())
    assert all(torch.equal(a, b) for a, b in zip(s1, s2)), [(a - b).abs().max() for a, b in zip(s1, s2)]
    for a, b in zip(g1[1:], g2[1:]) if affine else ():
        diff, top = float((a - b).abs().max()), float(b.abs().max())
        assert diff <= atol_share * top, (diff, top)
    top, bf16 = float(g2[0].abs().max()), g2[0].dtype == torch.bfloat16
    err2 = ref2 = 0.0
    for a, b in zip(g1[0].split(16), g2[0].split(16)):  # 16 rows at a time
        if bf16:  # f32 holds bf16 values and their differences exactly
            a, b = a.float(), b.float()
        d = (a - b).abs()
        if bf16:
            worst = float((d - 2.0 ** -7 * b.abs()).max())
            assert worst <= 1e-6 * top, (worst, top)
        else:
            assert float(d.max()) <= atol_share * top, (float(d.max()), top)
        err2 += float(d.square().sum())
        ref2 += float(b.square().sum())
    assert err2 ** 0.5 <= atol_share * ref2 ** 0.5, (err2 ** 0.5, ref2 ** 0.5)


def _float64_affine_grads(x, dy, eps):
    """-> float64 (grad weight, grad bias) of a train-mode BatchNorm2d of
    ``x`` under the output gradient ``dy`` (neither depends on the weight),
    16 rows at a time."""
    c = x.shape[1]
    sums = torch.zeros(5, c, dtype=torch.float64, device=x.device)
    for xc, dyc in zip(x.split(16), dy.split(16)):
        xc, dyc = xc.double(), dyc.double()
        sums[:3] += torch.stack([xc.sum((0, 2, 3)), xc.square().sum((0, 2, 3)),
                                 dyc.sum((0, 2, 3))])
    n = x.numel() // c
    mean = sums[0] / n
    for xc, dyc in zip(x.split(16), dy.split(16)):
        sums[3] += (dyc.double() * (xc.double() - mean.view(1, -1, 1, 1))).sum((0, 2, 3))
    invstd = (sums[1] / n - mean.square() + eps).rsqrt()
    return sums[3] * invstd, sums[2]


@pytest.mark.cuda
def test_cuda_chunked_batch_norm_at_2_31_elements_matches_torch(cuda_device):
    """Block 0 of the single-branch model at batch 256: a (256, 128, 256,
    256) bf16 channels-last input with an f32 affine, 2**31 elements.
    ``ChunkedBatchNorm2d`` gives ``nn.BatchNorm2d``'s output and running
    statistics bit for bit, and its input gradient within one bf16 ulp per
    element and 1e-3 (L2) of torch's own. Its weight and bias gradients,
    sums of 2**24 f32 terms a channel, are held within 1e-5 x the leaf's
    largest of their float64 sums: torch's own int64 NCHW reduce sits about
    4e-3 x the largest from them on this input, the chunked one under 1e-6.
    The profiler sees torch's channels-last reduce in its backward, and the
    int64 NCHW reduce in torch's own."""
    from torch.profiler import ProfilerActivity, profile

    from crosstalk_tpu_torch.models.layers import ChunkedBatchNormFn

    shape = (256, 128, 256, 256)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = _channels_last_randn(shape, torch.bfloat16, gen, cuda_device).mul_(2).add_(0.5)
    dy = _channels_last_randn(shape, torch.bfloat16, gen, cuda_device)
    assert x.numel() == 2 ** 31 and dy.is_contiguous(memory_format=torch.channels_last)
    bn, plain = _bn_pair(cuda_device, 128, torch.float32, seed=8)
    out, kernels = {}, {}
    before = ChunkedBatchNormFn.engaged
    for name, m in (("chunked", bn), ("torch", plain)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out[name] = _bn_step(m, x, dy)
            torch.cuda.synchronize()
        kernels[name] = [e.key for e in prof.key_averages()]
    assert ChunkedBatchNormFn.engaged == before + 1
    cl, nchw = "batch_norm_backward_reduce_channels_last_kernel", "batch_norm_backward_reduce_kernel"
    assert any(cl in k for k in kernels["chunked"]), kernels["chunked"]
    assert not any(nchw in k for k in kernels["chunked"]), kernels["chunked"]
    assert any(nchw in k for k in kernels["torch"]), kernels["torch"]
    _assert_bn_matches(out["chunked"], out["torch"], 1e-3, affine=False)
    for got, want in zip(out["chunked"][1][1:], _float64_affine_grads(x, dy, bn.eps)):
        err, top = float((got.double() - want).abs().max()), float(want.abs().max())
        assert err <= 1e-5 * top, (err, top)
    del out, x, dy
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("patched", [True, False], ids=["patched_limit", "below_limit"])
def test_cuda_chunked_batch_norm_at_a_patched_limit_matches_torch(cuda_device, monkeypatch,
                                                                  dtype, patched):
    """The limit patched so that (7, 16, 32, 32) splits into chunks of 3, 2
    and 2 rows: torch's two CUDA primitives per chunk give ``nn.BatchNorm2d``'s
    output and statistics bit for bit, and its gradients (float64 to 1e-12
    of each leaf's largest; bf16 as at full size). cuDNN is off on both
    sides: ``nn.BatchNorm2d`` runs it on a float64 or float32 input of
    fewer than 2**31 - 1 elements, never on one the chunked path takes.
    Below the limit nothing engages and everything is bitwise."""
    from crosstalk_tpu_torch.models import layers
    from crosstalk_tpu_torch.models.layers import ChunkedBatchNormFn

    if patched:
        monkeypatch.setattr(layers, "_INT32_NUMEL", 3 * 16 * 32 * 32 + 1)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x = _channels_last_randn((7, 16, 32, 32), dtype, gen, cuda_device).mul_(2).add_(0.5)
    dy = _channels_last_randn((7, 16, 32, 32), dtype, gen, cuda_device)
    affine = torch.float64 if dtype == torch.float64 else torch.float32
    bn, plain = _bn_pair(cuda_device, 16, affine, seed=10)
    before = ChunkedBatchNormFn.engaged
    with torch.backends.cudnn.flags(enabled=False):
        got, want = _bn_step(bn, x, dy), _bn_step(plain, x, dy)
    torch.cuda.synchronize()
    assert ChunkedBatchNormFn.engaged == before + patched
    if patched:
        _assert_bn_matches(got, want, 1e-12 if dtype == torch.float64 else 1e-3)
    else:
        assert all(torch.equal(a, b) for a, b in zip((got[0], *got[1], *got[2:]),
                                                     (want[0], *want[1], *want[2:])))


@pytest.mark.cuda
@pytest.mark.parametrize("variant,engaged", [("single", 1), ("double", 0)])
def test_cuda_train_step_at_batch_256_chunks_block_0_of_single_only(cuda_device, variant,
                                                                    engaged):
    """One bf16 step of the full-width model at the CLI's -b 256: the
    single-branch block 0 (2**31 elements) takes the chunked backward once;
    no two-branch BatchNorm reaches the limit. Every conv block runs the
    LeakyReLU + max-pool kernels once each way: 6 + 6 single, 8 + 8 double."""
    from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
    from crosstalk_tpu_torch.models.layers import ChunkedBatchNormFn
    from crosstalk_tpu_torch.models.registry import build_model, init_model
    from crosstalk_tpu_torch.ops.leaky_pool import leaky_pool_backward, leaky_pool_forward
    from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step

    model = build_model(ModelConfig(variant=variant), image_size=256, device=cuda_device)
    init_model(model, torch.Generator(device=cuda_device).manual_seed(0))
    step = make_train_step(init_train_state(model, OptimConfig()), compute_dtype="bf16", seed=5)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    raw = torch.rand(256, 256, 256, 2, device=cuda_device, generator=gen) * 1800 + 100
    labels = torch.rand(256, 1, device=cuda_device, generator=gen) * 0.5
    before = ChunkedBatchNormFn.engaged
    launches = leaky_pool_forward.launches, leaky_pool_backward.launches
    loss = step(raw, labels, 1e-3)
    torch.cuda.synchronize()
    assert ChunkedBatchNormFn.engaged - before == engaged
    blocks = 6 if variant == "single" else 8
    assert (leaky_pool_forward.launches - launches[0],
            leaky_pool_backward.launches - launches[1]) == (blocks, blocks)
    assert bool(torch.isfinite(loss))
    del model, step, raw, loss
    torch.cuda.empty_cache()


# --- the LeakyReLU + 2x2 max-pool kernels (ops/leaky_pool.py) -------------

# every conv block's BatchNorm output in the train step at the CLI's -b 256
_LEAKY_POOL_BLOCKS = {
    "single": [(256, 128, 256, 256), (256, 256, 128, 128), (256, 512, 64, 64),
               (256, 512, 32, 32), (256, 512, 16, 16), (256, 512, 8, 8)],
    "double": [(256, 64, 256, 256), (256, 128, 128, 128), (256, 256, 64, 64),
               (256, 512, 32, 32)],
}
# two negative bf16 values whose LeakyReLU(0.01) rounds to one bf16 value
_LEAKY_TIE = (-1.9921875, -1.984375)


def _leaky_pool_input(shape, dtype, device, seed, ties):
    """(N, C, H, W) channels-last. ``ties``: halves in [-2, 2], so windows
    tie often, with +-inf, NaN, -0 and the LeakyReLU tie pair strewn in;
    else randn."""
    n, c, h, w = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    if not ties:
        x = torch.randn(n, h, w, c, device=device, dtype=dtype, generator=gen)
    else:
        x = torch.randint(-4, 5, (n, h, w, c), device=device, dtype=torch.int8,
                          generator=gen).to(dtype).mul_(0.5)
        flat = x.view(-1)
        for start, step, v in ((1, 4099, float("inf")), (2, 4093, float("-inf")),
                               (3, 8191, float("nan")), (5, 4091, -0.0),
                               (7, 61, _LEAKY_TIE[0]), (8, 59, _LEAKY_TIE[1])):
            flat[start::step] = v
    return x.permute(0, 3, 1, 2)


def _assert_equal_bits(got, want):
    """Equal bit for bit (NaN payloads and the signs of zeros included)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[want.dtype]
    a = got.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1).view(bits)
    b = want.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1).view(bits)
    if not torch.equal(a, b):
        where = (a != b).nonzero()[:8]
        raise AssertionError(f"{int((a != b).sum())} elements differ; first (n, h, w, c), got, want: "
                             f"{[(i.tolist(), int(a[tuple(i)]), int(b[tuple(i)])) for i in where]}")


def _check_leaky_pool_against_torch(x, g, slope=0.01):
    """The kernels' output and grad_x against autograd of torch's CUDA
    ``F.leaky_relu`` -> ``F.max_pool2d``, bit for bit; one launch each way."""
    import torch.nn.functional as F

    from crosstalk_tpu_torch.ops.leaky_pool import (
        leaky_pool_backward,
        leaky_pool_forward,
    )

    before = leaky_pool_forward.launches, leaky_pool_backward.launches
    out = leaky_pool_forward(x, slope)
    grad = leaky_pool_backward(x, g, slope)
    torch.cuda.synchronize()
    assert (leaky_pool_forward.launches, leaky_pool_backward.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    leaf = x.detach().requires_grad_()
    want_out = F.max_pool2d(F.leaky_relu(leaf, slope), 2, 2)
    (want_grad,) = torch.autograd.grad(want_out, leaf, g)
    _assert_equal_bits(out, want_out.detach())
    del want_out, out
    _assert_equal_bits(grad, want_grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("variant,block", [(v, k) for v, s in _LEAKY_POOL_BLOCKS.items()
                                           for k in range(len(s))])
def test_cuda_leaky_pool_kernels_equal_torch_at_every_block_of_batch_256(
        cuda_device, variant, block, dtype):
    """Every conv block's shape of both models at -b 256 (single's block 0
    holds 2**31 elements, so its last ones need 64-bit offsets), on
    tie-heavy inputs with +-inf, NaN and -0 (block 0 also on randn): output
    and grad_x bit for bit torch's CUDA chain's."""
    shape = _LEAKY_POOL_BLOCKS[variant][block]
    n, c, h, w = shape
    for ties in ((True, False) if block == 0 else (True,)):
        x = _leaky_pool_input(shape, dtype, cuda_device, seed=block, ties=ties)
        g = _leaky_pool_input((n, c, h // 2, w // 2), dtype, cuda_device, seed=100 + block,
                              ties=False)
        _check_leaky_pool_against_torch(x, g)
        del x, g
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_leaky_pool_kernels_equal_torch_on_every_window_order(cuda_device, dtype):
    """Every window of four drawn from {-inf, -1, NaN, the LeakyReLU tie
    pair, -0, 0} in every order, laid out as 49 x 49 windows of two images
    (the second in reverse order, so the window of -inf alone sits once at
    an image's first window and once elsewhere), under gradients with -0:
    bit for bit torch's CUDA chain."""
    vals = torch.tensor([float("-inf"), -1.0, float("nan"), *_LEAKY_TIE, -0.0, 0.0])
    grid = torch.cartesian_prod(*[torch.arange(len(vals))] * 4)  # (2401, 4) in (h, w) order
    windows = vals[grid].view(49, 49, 2, 2)
    image = windows.permute(0, 2, 1, 3).reshape(98, 98)
    x = torch.stack([image, image.flip(0, 1)])[:, None].expand(2, 16, 98, 98)
    x = x.to(cuda_device, dtype).contiguous(memory_format=torch.channels_last)
    g = torch.tensor([1.0, -0.0, -3.0, 2.5, 0.0]).repeat(2 * 49 * 49 // 5 + 1)[:2 * 49 * 49]
    g = g.view(2, 1, 49, 49).expand(2, 16, 49, 49)
    g = g.to(cuda_device, dtype).contiguous(memory_format=torch.channels_last)
    _check_leaky_pool_against_torch(x, g)


@pytest.mark.cuda
def test_cuda_leaky_pool_wrapper_rejects_what_the_kernels_do_not_take(cuda_device):
    from crosstalk_tpu_torch.ops.leaky_pool import leaky_pool_backward, leaky_pool_forward

    x = torch.rand(2, 16, 8, 8, device=cuda_device).contiguous(memory_format=torch.channels_last)
    for bad in (x.contiguous(), x.half(), x[:, :, :7, :7], x[:, :6]):
        with pytest.raises(ValueError):
            leaky_pool_forward(bad, 0.01)
    with pytest.raises(ValueError):
        leaky_pool_backward(x, torch.rand(2, 16, 8, 8, device=cuda_device), 0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["single", "double"])
@pytest.mark.parametrize("compute_dtype", ["bf16", "f32"])
def test_cuda_train_step_through_the_leaky_pool_kernels_equals_the_bypassed_step(
        cuda_device, monkeypatch, variant, compute_dtype):
    """Three steps of the full-width model at 256 px, batch 16, from one
    state: through the kernels, and twice with them bypassed (``takes``
    patched to refuse). cuDNN is deterministic here, so the two bypassed
    runs are bitwise one and their spread is 0: the kernels' losses,
    gradients and state equal them bit for bit, and every conv block
    launches each kernel once a step."""
    import copy

    from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
    from crosstalk_tpu_torch.models.registry import build_model, init_model
    from crosstalk_tpu_torch.ops import leaky_pool
    from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step

    model = build_model(ModelConfig(variant=variant), image_size=256, device=cuda_device)
    init_model(model, torch.Generator(device=cuda_device).manual_seed(0))
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    raw = torch.rand(3, 16, 256, 256, 2, device=cuda_device, generator=gen) * 1800 + 100
    labels = torch.rand(3, 16, 1, device=cuda_device, generator=gen) * 0.5
    takes = leaky_pool.takes

    def run(fused):
        monkeypatch.setattr(leaky_pool, "takes", takes if fused else (lambda x: False))
        state = init_train_state(copy.deepcopy(model), OptimConfig())
        step = make_train_step(state, compute_dtype=compute_dtype, seed=5)
        before = leaky_pool.leaky_pool_forward.launches, leaky_pool.leaky_pool_backward.launches
        losses = [step(raw[i], labels[i], 1e-3) for i in range(3)]
        torch.cuda.synchronize()
        launched = (leaky_pool.leaky_pool_forward.launches - before[0],
                    leaky_pool.leaky_pool_backward.launches - before[1])
        return (torch.stack(losses), {k: p.grad.clone() for k, p in state.model.named_parameters()},
                {k: v.clone() for k, v in state.model.state_dict().items()}, launched)

    blocks = 6 if variant == "single" else 8
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        plain, again, fused = run(False), run(False), run(True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    assert plain[3] == again[3] == (0, 0)
    assert fused[3] == (3 * blocks, 3 * blocks)
    for a, b in ((again, plain), (fused, plain)):
        assert torch.equal(a[0], b[0])
        for got, want in zip(a[1:3], b[1:3]):
            assert list(got) == list(want)
            assert all(torch.equal(got[k], want[k]) for k in want), \
                [k for k in want if not torch.equal(got[k], want[k])]


# --- SwinV2-B (models/swinv2.py) at its published widths -------------------

def _swin_step(device, seed, compute_dtype="bf16"):
    from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
    from crosstalk_tpu_torch.models.registry import build_model, init_model
    from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step

    model = build_model(ModelConfig(variant="swinv2-b"), image_size=256, device=device)
    init_model(model, torch.Generator(device=device).manual_seed(seed))
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = init_train_state(model, OptimConfig())
    return state, make_train_step(state, compute_dtype=compute_dtype, seed=seed,
                                  augment=False), weights


@pytest.mark.cuda
def test_cuda_swinv2_steps_enqueue_without_a_sync(cuda_device):
    """Two full-width bf16 steps at batch 8 under the sync debug mode
    "error": no step reads back to the host or copies from pageable host
    memory, and no table is rebuilt."""
    from crosstalk_tpu_torch.models import swinv2

    built = swinv2.tables_built.value
    state, step, _ = _swin_step(cuda_device, 1)
    assert swinv2.tables_built.value == built + 4
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    raw = torch.rand(8, 256, 256, 2, device=cuda_device, generator=gen)
    labels = torch.rand(8, 1, device=cuda_device, generator=gen) * 0.5
    cpb, calls = swinv2.cpb_evaluations.value, swinv2.window_attention_calls.value
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [step(raw, labels, 1e-4) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(torch.stack(losses)).all())
    assert swinv2.tables_built.value == built + 4 and state.step == 2
    assert swinv2.cpb_evaluations.value == cpb + 48
    assert swinv2.window_attention_calls.value == calls + 48


@pytest.mark.cuda
def test_cuda_swinv2_bf16_step_within_the_cell_s_limits_of_the_reference(cuda_device):
    """One full-width bf16 step at batch 16 against the float32 reference
    (``tests/swinv2_ref.py``, TF32 off) under the step's own drop-path
    masks: the step's predictions and the gradient Adam took (read back
    from its first moment, L2 included; the output bias and the final
    LayerNorm's shift left out, as the cell's driver leaves them out)
    within the limits of the cell
    ``swinv2-b.train-b128`` (``benchmark/workloads/``), as its driver reads
    them."""
    import json
    import os
    import statistics
    import sys

    import torch.nn.functional as F

    from crosstalk_tpu_torch.data.transforms import (
        DROPOUT_STREAM,
        counter_key,
        normalize_batch_nhwc,
    )

    sys.path.insert(0, os.path.dirname(__file__))
    import swinv2_ref as ref

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "workloads", "swinv2-b.train-b128.json")) as f:
        limits = json.load(f)["limits"]
    ref.plain_numerics()
    state, step, w0 = _swin_step(cuda_device, 4)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    raw = torch.rand(16, 256, 256, 2, device=cuda_device, generator=gen)
    labels = torch.rand(16, 1, device=cuda_device, generator=gen) * 0.5
    seen = []
    hook = state.model.register_forward_hook(
        lambda m, a, out: seen.append(out.detach().float().reshape(-1)))
    step(raw, labels, 1e-4)
    hook.remove()
    params = dict(state.model.named_parameters())
    got = {k: state.optimizer.state[p]["exp_avg"] / 0.1 for k, p in params.items()}

    masks = torch.empty((48, 16), device=cuda_device).bernoulli_(
        state.model.drop_path.keep,
        generator=torch.Generator(device=cuda_device).manual_seed(counter_key(4, 0,
                                                                              DROPOUT_STREAM, 0)))
    w = {k: v.clone().requires_grad_(k in params) for k, v in w0.items()}
    x = normalize_batch_nhwc(raw).permute(0, 3, 1, 2)
    pred = ref.forward(w, x, image=256, masks=[(masks[2 * i], masks[2 * i + 1])
                                                for i in range(24)])
    F.mse_loss(pred, labels).backward()
    diff = (seen[0] - pred.detach()[:, 0]).abs()
    norms = {k: float((w[k].grad + 1e-4 * w0[k]).norm()) for k in params
             if k not in ("head.bias", "norm.bias")}
    floor = statistics.median(norms.values())
    grad_gap = max(abs(float(got[k].norm()) - n) / max(n, floor) for k, n in norms.items())
    assert float(diff.max()) <= limits["pred_gap"]
    assert float(diff.mean()) <= limits["pred_mean_gap"]
    assert grad_gap <= limits["grad_gap"]
