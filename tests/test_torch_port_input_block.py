"""The port's fused input block (K1) against the JAX package's Pallas kernel.

On the CPU the wrapper runs its plain PyTorch version; it is held here
against ``crosstalk_tpu.ops.pallas.input_block.fused_input_block`` in
interpret mode. The CUDA kernel itself is held against the plain version on
the card in tests/test_torch_port_cuda.py.

Tolerance: one bf16 ulp (2**-7 relative) where |y| > 1e-3, 1e-5 absolute
elsewhere. Both sides sum exact bf16 products in f32, in different orders;
a sum that lands near a bf16 rounding boundary may round one ulp apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crosstalk_tpu.ops.pallas.input_block import fused_input_block as jax_block
from crosstalk_tpu_torch.ops.input_block import (
    CHANNEL_SLICE,
    fold_bn_affine,
    fused_input_block,
    fused_input_block_packed,
    pack_input_block,
    padded_taps,
)

ULP = 2.0 ** -7


def assert_within_one_ulp(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    big = np.abs(want) > 1e-3
    rel = np.abs(got - want)[big] / np.abs(want)[big]
    assert rel.size == 0 or rel.max() <= ULP, rel.max()
    assert np.abs(got - want)[~big].max(initial=0.0) <= 1e-5


def _inputs(rng, batch, size, c_in, kernel):
    features = kernel.shape[-1]
    x = rng.random((batch, size, size, c_in)).astype(np.float32)
    scale = rng.normal(1.0, 0.3, (features,)).astype(np.float32)
    scale[::5] = -scale[::5]  # a negative scale flips which pool phase wins
    bias = rng.normal(0, 0.2, (features,)).astype(np.float32)
    return x, kernel, scale, bias


def _compare(x, kernel, scale, bias, packed_entry=False):
    want = jax_block(*(jnp.asarray(a) for a in (x, kernel, scale, bias)),
                     interpret=True)
    before = fused_input_block.launches
    args = [torch.from_numpy(a) for a in (x, kernel, scale, bias)]
    if packed_entry:
        got = fused_input_block_packed(args[0], pack_input_block(*args[1:]))
    else:
        got = fused_input_block(*args)
    assert fused_input_block.launches == before  # CPU calls launch nothing
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert_within_one_ulp(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("c_in,features,size", [(2, 128, 32), (1, 64, 64), (2, 128, 64)])
def test_plain_version_matches_pallas_kernel(c_in, features, size):
    rng = np.random.default_rng(0)
    kernel = rng.normal(0, 0.2, (3, 3, c_in, features)).astype(np.float32)
    _compare(*_inputs(rng, 3, size, c_in, kernel))


def _block_diagonal_kernel(rng, f=64):
    kernel = np.zeros((3, 3, 2, 2 * f), np.float32)
    kernel[:, :, 0:1, :f] = rng.normal(0, 0.3, (3, 3, 1, f))
    kernel[:, :, 1:2, f:] = rng.normal(0, 0.3, (3, 3, 1, f))
    return kernel


def test_plain_version_matches_pallas_kernel_block_diagonal():
    """The two-branch call: both branches' C=1 kernels stacked into one
    C=2 -> 2F kernel with zeros off the diagonal."""
    rng = np.random.default_rng(1)
    _compare(*_inputs(rng, 2, 32, 2, _block_diagonal_kernel(rng)))


@pytest.mark.parametrize("c_in,features,size,block_diagonal", [
    (2, 128, 32, False), (1, 64, 64, False), (2, 128, 64, False), (2, 128, 32, True)])
def test_packed_entry_matches_pallas_kernel(c_in, features, size, block_diagonal):
    """The entry the fast forward calls, on weights packed once, on the CPU
    (its plain version on the packed bf16 kernel)."""
    rng = np.random.default_rng(5)
    if block_diagonal:
        kernel = _block_diagonal_kernel(rng, features // 2)
    else:
        kernel = rng.normal(0, 0.2, (3, 3, c_in, features)).astype(np.float32)
    _compare(*_inputs(rng, 2, size, c_in, kernel), packed_entry=True)


@pytest.mark.parametrize("c_in", [1, 2, 3, 4])
@pytest.mark.parametrize("features", [8, 12, 64, 128, 200])
def test_packed_layout_holds_the_folded_kernel(c_in, features):
    """The GEMM layout read back under its documented K order, k =
    (3 dh + dw) C + c, is the bf16 folded kernel; the padding is zero."""
    rng = np.random.default_rng(6)
    kernel = torch.from_numpy(rng.normal(0, 0.3, (3, 3, c_in, features)).astype(np.float32))
    scale = torch.from_numpy(rng.normal(1, 0.3, features).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.2, features).astype(np.float32))
    packed = pack_input_block(kernel, scale, bias)
    k_pad = {1: 16, 2: 24, 3: 32, 4: 40}[c_in]
    f_pad = -(-features // CHANNEL_SLICE) * CHANNEL_SLICE
    assert padded_taps(c_in) == k_pad and packed.features == features
    assert packed.gemm.shape == (f_pad, k_pad) and packed.gemm.dtype == torch.bfloat16
    assert packed.bias.shape == (f_pad,) and packed.bias.dtype == torch.float32
    folded = (kernel * scale).to(torch.bfloat16)
    assert torch.equal(packed.folded, folded)
    gemm = packed.gemm.float()
    for dh in range(3):
        for dw in range(3):
            for c in range(c_in):
                k = (3 * dh + dw) * c_in + c
                assert torch.equal(gemm[:features, k], folded[dh, dw, c].float())
    assert not gemm[features:].any() and not gemm[:, 9 * c_in:].any()
    assert torch.equal(packed.bias[:features], bias) and not packed.bias[features:].any()


def test_fold_bn_affine_matches_jax():
    from crosstalk_tpu.ops.pallas.input_block import fold_bn_affine as jax_fold

    rng = np.random.default_rng(2)
    args = [rng.normal(0, 1, 16).astype(np.float32) for _ in range(4)]
    args.append(rng.random(16).astype(np.float32) + 0.1)  # variance > 0
    want = jax_fold(*(jnp.asarray(a) for a in args))
    got = fold_bn_affine(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("x_shape,k_shape,f", [
    ((1, 8, 7, 2), (3, 3, 2, 8), 8),    # odd W
    ((1, 9, 8, 2), (3, 3, 2, 8), 8),    # odd H
    ((1, 8, 8, 5), (3, 3, 5, 8), 8),    # C > 4
    ((1, 8, 8, 2), (3, 3, 1, 8), 8),    # kernel C mismatch
    ((1, 8, 8, 2), (3, 3, 2, 8), 4),    # scale/bias length mismatch
    ((8, 8, 2), (3, 3, 2, 8), 8),       # not 4-D
])
def test_wrapper_rejects_shapes_the_kernel_does_not_take(x_shape, k_shape, f):
    with pytest.raises(ValueError):
        fused_input_block(torch.zeros(x_shape), torch.zeros(k_shape),
                          torch.ones(f), torch.zeros(f))


@pytest.mark.parametrize("x_shape", [(1, 8, 8, 1), (1, 8, 7, 2), (8, 8, 2)])
def test_packed_entry_rejects_inputs_that_do_not_fit_the_packed_kernel(x_shape):
    packed = pack_input_block(torch.zeros(3, 3, 2, 8), torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError):
        fused_input_block_packed(torch.zeros(x_shape), packed)
