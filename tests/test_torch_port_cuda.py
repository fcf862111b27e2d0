"""Card-only tests of the port: the CUDA kernel against its plain PyTorch
version. They skip on a host without an NVIDIA card (the kernel has no CPU
mode). This file imports neither JAX nor the test fixtures that do, so where
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
