"""LeakyReLU followed by a 2x2 stride-2 max pool, with its gradient, as one
autograd function that keeps no index tensor: the tail of every conv block
(``models/layers.conv_block``) in the train step.

``LeakyPoolFn.apply(x, slope)`` on an (N, C, H, W) channels-last tensor with
even H and W returns ``F.max_pool2d(F.leaky_relu(x, slope), 2, 2)`` and
saves only ``x``; its backward recomputes each window's max from ``x`` and
routes the pooled gradient through LeakyReLU's slope, giving torch's
gradient of that chain bit for bit (same tie rule, same roundings). On a
CUDA tensor both directions launch the hand-written kernels of
``csrc/leaky_pool.cu`` (built at first use, see ``_build.py``; its source
note gives the bound and the design), counted in
``leaky_pool_forward.launches`` and ``leaky_pool_backward.launches``; on a
CPU tensor they run the plain PyTorch versions below, which hold the same
algorithm against torch's CPU chain in the tests. There is no fallback
between the two: a CUDA call launches the kernel or raises.

The kernels replace no TPU kernel (the JAX package leaves this chain to
XLA's fusion). They were added because torch's four passes and its int64
pool indices move 19 bytes an element of a bf16 train step, and this pair
7 (the bound at the single-branch model's 2**31-element first block at
batch 256: forward 5.37 GB, 1.60 ms; backward 9.66 GB, 2.88 ms at
3.35 TB/s).

Two differences between torch's CPU and CUDA builds are kept, the plain
versions following the CPU and the kernels the card: a window whose four
values are all -inf routes its gradient to the window's first element on
the CPU, and on the card to the image's first element, which only window
(0, 0) holds (torch's CUDA kernel starts every window's index at 0); and a
pooled gradient of -0 reaches the max as +0 on the CPU (added to a zeroed
gradient) and as -0 on the card.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from crosstalk_tpu_torch.ops import _build

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_VECTOR_BYTES = 16  # one vector load or store of the kernels
_launches_lock = threading.Lock()


def takes(x: torch.Tensor) -> bool:
    """Whether the kernels take ``x``: a CUDA bf16 or f32 (N, C, H, W)
    channels-last tensor with even H and W, C a whole number of 16-byte
    vectors, and a storage offset of whole vectors (torch's CUDA allocator
    aligns every block to 512 bytes; the launch checks the pointer)."""
    return (x.is_cuda and x.dtype in _DTYPES and x.dim() == 4
            and x.is_contiguous(memory_format=torch.channels_last)
            and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0
            and x.shape[1] * x.element_size() % _VECTOR_BYTES == 0
            and x.storage_offset() * x.element_size() % _VECTOR_BYTES == 0)


def _leaky(xf: torch.Tensor, slope: float, dtype) -> torch.Tensor:
    """LeakyReLU as torch computes it: in float, rounded to ``dtype``."""
    return torch.where(xf > 0, xf, xf * slope).to(dtype)


def _phases(t: torch.Tensor):
    """The four positions of each 2x2 window, in (h, w) order."""
    return [t[:, :, dh::2, dw::2] for dh in (0, 1) for dw in (0, 1)]


def _window_max(x: torch.Tensor, slope: float):
    """-> (the pooled LeakyReLU(x) in float, the winner's phase 0-3): a
    running max from -inf, replaced where y > max or y is NaN, so the first
    maximum wins and the last NaN. A window of -inf alone keeps phase 0."""
    n, c, h, w = x.shape
    best = torch.full((n, c, h // 2, w // 2), float("-inf"), dtype=torch.float32,
                      device=x.device)
    arg = torch.zeros(best.shape, dtype=torch.int8, device=x.device)
    for k, xk in enumerate(_phases(x)):
        y = _leaky(xk.float(), slope, x.dtype).float()
        take = (y > best) | y.isnan()
        best = torch.where(take, y, best)
        arg = arg.masked_fill(take, k)
    return best, arg


def leaky_pool_forward_reference(x: torch.Tensor, slope: float) -> torch.Tensor:
    """Plain PyTorch forward: (N, C, H/2, W/2) in x's dtype and layout."""
    best, _ = _window_max(x, slope)
    return best.to(x.dtype).contiguous(memory_format=torch.channels_last)


def leaky_pool_backward_reference(x: torch.Tensor, grad_out: torch.Tensor,
                                  slope: float) -> torch.Tensor:
    """Plain PyTorch backward: grad_x (N, C, H, W) channels-last, the
    pooled gradient (added to 0 in float, as torch's CPU backward does) at
    each window's max and 0 elsewhere, through LeakyReLU's slope."""
    _, arg = _window_max(x, slope)
    routed = grad_out.float() + 0.0
    grad_x = torch.empty_like(x, memory_format=torch.channels_last)
    for k, (xk, gk) in enumerate(zip(_phases(x), _phases(grad_x))):
        gy = torch.where(arg == k, routed, 0.0)
        gk.copy_(torch.where(xk.float() > 0, gy, gy * slope))
    return grad_x


def _check(x: torch.Tensor) -> None:
    if not takes(x) or x.data_ptr() % _VECTOR_BYTES:
        raise ValueError(
            "the leaky_pool kernels take a CUDA bf16 or f32 (N, C, H, W) channels-last "
            "tensor, 16-byte aligned, with even H and W and C a multiple of "
            f"{_VECTOR_BYTES} bytes; got {x.dtype} {tuple(x.shape)} on {x.device} "
            f"with strides {x.stride()}")


_entries = {}


def _launcher(name: str, pointers: int):
    """The C entry point, with pointers and the stream as c_void_p (a
    default ctypes int would cut a 64-bit pointer); typed once."""
    if name not in _entries:
        fn = getattr(_build.load("leaky_pool"), name)
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [ctypes.c_int] + [ptr] * pointers + [i64] * 4 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return _entries[name]


def _launch(name: str, counter, x: torch.Tensor, tensors, slope: float) -> None:
    n, c, h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _launcher(name, len(tensors))(
            _DTYPES[x.dtype], *(t.data_ptr() for t in tensors), n, h, w, c,
            float(slope), stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")
    with _launches_lock:  # autograd runs backward on its own threads
        counter.launches += 1


def leaky_pool_forward(x: torch.Tensor, slope: float) -> torch.Tensor:
    """The pooled LeakyReLU(x), (N, C, H/2, W/2) channels-last: the kernel
    on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return leaky_pool_forward_reference(x, slope)
    _check(x)
    n, c, h, w = x.shape
    out = torch.empty((n, c, h // 2, w // 2), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    _launch("leaky_pool_forward_launch", leaky_pool_forward, x, (x, out), slope)
    return out


def leaky_pool_backward(x: torch.Tensor, grad_out: torch.Tensor,
                        slope: float) -> torch.Tensor:
    """grad_x of ``leaky_pool_forward(x, slope)`` under ``grad_out``: the
    kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return leaky_pool_backward_reference(x, grad_out, slope)
    _check(x)
    n, c, h, w = x.shape
    if grad_out.shape != (n, c, h // 2, w // 2) or grad_out.dtype != x.dtype:
        raise ValueError(f"grad_out must be {x.dtype} {(n, c, h // 2, w // 2)}, got "
                         f"{grad_out.dtype} {tuple(grad_out.shape)}")
    grad_out = grad_out.contiguous(memory_format=torch.channels_last)
    grad_x = torch.empty_like(x, memory_format=torch.channels_last)
    _launch("leaky_pool_backward_launch", leaky_pool_backward, x, (x, grad_out, grad_x),
            slope)
    return grad_x


leaky_pool_forward.launches = 0
leaky_pool_backward.launches = 0


class LeakyPoolFn(torch.autograd.Function):
    """``F.max_pool2d(F.leaky_relu(x, slope), 2, 2)`` that saves only ``x``
    (no pooled input, no indices); see the module's docstring."""

    @staticmethod
    def forward(ctx, x, slope: float):
        ctx.slope = slope
        ctx.save_for_backward(x)
        return leaky_pool_forward(x, slope)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        (x,) = ctx.saved_tensors
        return leaky_pool_backward(x, grad_out, ctx.slope), None
