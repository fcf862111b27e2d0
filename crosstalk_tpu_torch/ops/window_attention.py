"""SwinV2's scaled cosine attention in windows of 64 tokens, head size 32,
with its gradient, as one autograd function that reads q, k and v where the
qkv projection left them: the attention of every ``models/swinv2.py``
block on the card in bf16.

``WindowAttentionFn.apply(qkv, bias, scale)``: ``qkv`` (bw, 64, 3, h, 32)
is the qkv projection's output viewed by (token, q/k/v, head, channel);
``bias`` (1, R, 64, 64) holds the position bias, R = h (every window
alike) or R = nW x h (the region mask added, window w reading row
``(w mod nW) h + head``); ``scale`` (h, 1, 1) the heads' logit scales. It
returns the attention's output (bw, 64, h x 32), heads side by side as the
projection reads them:

    u = q / sqrt(|q|^2 + 32 eps),  w = k / sqrt(|k|^2 + 32 eps)
    out = softmax(s_h u w^T + bias) v

which is ``F.scaled_dot_product_attention(rms_norm(q) * s, rms_norm(k),
v, bias, scale=1/32)``, the path the model keeps elsewhere. In its
working precision (bf16 on the card): the row norms, the softmax and every
sum in f32; ``s u`` and ``w`` rounded for the products, the softmax's
unnormalised weights rounded for ``P v``, the output divided by their f32
row sum, then rounded. It saves the f32 inverse norms and each row's
logsumexp (``stats``, (bw, h, 3, 64)). The backward recomputes P from
them and forms dV, dP, dS and the norms' gradients; the bias's gradient
(a sum over the windows that share each of its rows) and the scales' are
reduced in a fixed order with no atomics: the windows of each bias row
are cut into chunks of ``chunk_size(...)`` windows, each chunk summed in
window order, then the chunks in order. So two backward calls on the same
inputs give the same bits.

On a CUDA tensor both directions launch the hand-written kernels of
``csrc/window_attention.cu`` (built at first use, see ``_build.py``; its
source note gives the bound and the design), counted in
``window_attention_forward.launches`` and
``window_attention_backward.launches``; on a CPU tensor they run the plain
PyTorch versions below (``forward_reference``, ``backward_reference``),
the same algorithm, which the tests hold against the model's
``rms_norm`` + SDPA path. There is no fallback between the two: a CUDA
call launches the kernels or raises. ``takes`` says which inputs the
model hands to this function.

The kernels replace no TPU kernel (the JAX package has no SwinV2). They
were added because the chain of torch ops for this attention (permuted
q/k copies, two ``rms_norm`` passes each way, SDPA with a float mask whose
gradient it writes for every window, the sum of that gradient over the
batch, the output's transpose) took most of a SwinV2-B train step at
batch 128 on an H100 (PERF.md), where the attention's own bytes need
about 1.3 ms forward and 2.5 ms backward a step.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

from crosstalk_tpu_torch.ops import _build

TOKENS = 64    # tokens of a window (8 x 8)
HEAD_DIM = 32  # channels of a head
# rms_norm(t, eps) / sqrt(d) = t / sqrt(|t|^2 + d eps) (models/swinv2.py)
NORM_EPS = 1e-12
# blocks of the backward kernel resident on one SM (its shared memory, two
# item buffers, allows 3; csrc/window_attention.cu), and an H100's SMs
BACKWARD_BLOCKS_PER_SM = 3
H100_SMS = 132
_ALIGN = 16  # bytes of one cp.async copy of the kernels
_launches_lock = threading.Lock()


def takes(qkv: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor) -> bool:
    """Whether the kernels take these inputs: CUDA bf16 tensors on one
    device, ``qkv`` contiguous (bw, 64, 3, h, 32), ``bias`` contiguous
    (1, R, 64, 64) with R = m h for an m that divides bw, ``scale``
    contiguous with h elements."""
    if not (qkv.is_cuda and qkv.dtype == torch.bfloat16 and qkv.dim() == 5
            and bias.dim() == 4):
        return False
    bw, n, three, h, d = qkv.shape
    rows = bias.shape[1]
    return (n == TOKENS and d == HEAD_DIM and three == 3 and qkv.is_contiguous()
            and bias.dtype == scale.dtype == torch.bfloat16
            and bias.device == scale.device == qkv.device
            and tuple(bias.shape) == (1, rows, n, n) and bias.is_contiguous()
            and rows > 0 and rows % h == 0 and bw % (rows // h) == 0
            and scale.numel() == h and scale.is_contiguous())


@functools.lru_cache(maxsize=None)
def chunk_size(rows: int, windows: int, slots: int = BACKWARD_BLOCKS_PER_SM * H100_SMS) -> int:
    """Windows of one bias row that one block of the backward kernel sums
    in order (the last chunk of a row may hold fewer): ``rows`` bias rows,
    each shared by ``windows`` windows, ``slots`` blocks resident at once
    on the card: the chunks per row that take the least time, counted as
    waves of blocks times a block's items plus one (its 64 x 64 f32
    partial sum, written and read back, moves about an item's bytes), the
    fewest chunks of those."""
    def cost(chunks):
        return -(-rows * chunks // slots) * (-(-windows // chunks) + 1)

    chunks = min(range(1, windows + 1), key=cost)
    return -(-windows // chunks)


def backward_slots(device: torch.device) -> int:
    """Blocks of the backward kernel resident at once on ``device``."""
    return BACKWARD_BLOCKS_PER_SM * _sms(torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split(qkv: torch.Tensor):
    """(bw, n, 3, h, d) -> q, k, v as (bw, h, n, d) float32."""
    q, k, v = qkv.float().permute(2, 0, 3, 1, 4).unbind(0)
    return q, k, v


def _bias_of_windows(bias: torch.Tensor, bw: int, h: int) -> torch.Tensor:
    """-> (bw, h, n, n) float32: window w, head j reads bias row
    ``(w mod m) h + j``, m = R / h."""
    n = bias.shape[-1]
    m = bias.shape[1] // h
    return bias.float().view(1, m, h, n, n).expand(bw // m, m, h, n, n).reshape(bw, h, n, n)


def _normed(qkv, stats, scale):
    """-> (q, k, v, s u rounded, w rounded, the f32 factor s / |q|) as the
    kernels form them from the saved inverse norms."""
    low = qkv.dtype
    q, k, v = _split(qkv)
    h = q.shape[1]
    fq = stats[:, :, 0] * scale.float().reshape(1, h, 1)
    qn = (q * fq[..., None]).to(low).float()
    kn = (k * stats[:, :, 1, :, None]).to(low).float()
    return q, k, v, qn, kn, fq


def _logits(qn, kn, bias):
    bw, h = qn.shape[:2]
    return qn @ kn.transpose(-1, -2) + _bias_of_windows(bias, bw, h)


def forward_reference(qkv: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor):
    """Plain PyTorch forward: -> (out (bw, n, h d) in qkv's dtype, stats
    (bw, h, 3, n) float32: 1 / |q|, 1 / |k| (with the 32 eps) and the
    logsumexp of each row), rounded where the kernel rounds (to qkv's
    dtype: nowhere in f32)."""
    with torch.autocast(qkv.device.type, enabled=False):
        low = qkv.dtype
        bw, n, _, h, d = qkv.shape
        q, k, _ = _split(qkv)
        stats = torch.empty((bw, h, 3, n), dtype=torch.float32, device=qkv.device)
        stats[:, :, 0] = 1.0 / torch.sqrt((q * q).sum(-1) + d * NORM_EPS)
        stats[:, :, 1] = 1.0 / torch.sqrt((k * k).sum(-1) + d * NORM_EPS)
        _, _, v, qn, kn, _ = _normed(qkv, stats, scale)
        s = _logits(qn, kn, bias)
        top = s.amax(-1, keepdim=True)
        p = torch.exp(s - top)
        total = p.sum(-1, keepdim=True)
        out = (p.to(low).float() @ v) / total
        stats[:, :, 2] = (top + torch.log(total))[..., 0]
        return out.to(low).transpose(1, 2).reshape(bw, n, h * d), stats


def _chunked_sum(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(M, ...) -> (...): each run of ``chunk`` rows summed in order, then
    the runs' sums in order."""
    runs = []
    for start in range(0, t.shape[0], chunk):
        acc = t[start].clone()
        for i in range(start + 1, min(start + chunk, t.shape[0])):
            acc += t[i]
        runs.append(acc)
    total = runs[0]
    for r in runs[1:]:
        total = total + r
    return total


def backward_reference(qkv: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                       stats: torch.Tensor, grad_out: torch.Tensor, chunk=None):
    """Plain PyTorch backward of ``forward_reference`` under ``grad_out``
    (bw, n, h d): -> (grad of qkv (bw, n, 3, h, d) in its dtype, of bias
    and of scale, each in its own dtype and shape). ``chunk``: windows per
    chunk of the bias's and scales' sums (default ``chunk_size``'s on an
    H100)."""
    with torch.autocast(qkv.device.type, enabled=False):
        low = qkv.dtype
        bw, n, _, h, d = qkv.shape
        rows = bias.shape[1]
        m = rows // h
        chunk = chunk or chunk_size(rows, bw // m)
        q, k, v, qn, kn, fq = _normed(qkv, stats, scale)
        p = torch.exp(_logits(qn, kn, bias) - stats[:, :, 2, :, None])
        do = grad_out.float().reshape(bw, n, h, d).transpose(1, 2)
        dv = p.to(low).float().transpose(-1, -2) @ do
        dp = do @ v.transpose(-1, -2)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        ds_low = ds.to(low).float()
        dqn = ds_low @ kn
        dkn = ds_low.transpose(-1, -2) @ qn
        u = q * stats[:, :, 0, :, None]
        along_q = (u * dqn).sum(-1)  # s's gradient, row by row
        dq = fq[..., None] * (dqn - u * along_q[..., None])
        wk = k * stats[:, :, 1, :, None]
        dk = stats[:, :, 1, :, None] * (dkn - wk * (wk * dkn).sum(-1, keepdim=True))
        dqkv = torch.stack((dq, dk, dv), dim=2).to(low)  # (bw, h, 3, n, d)
        dqkv = dqkv.permute(0, 3, 2, 1, 4).contiguous()
        # window w = i m + (w mod m): bias row (w mod m) h + head
        dbias = _chunked_sum(ds.reshape(bw // m, rows, n, n), chunk)
        per_row = _chunked_sum(along_q.sum(-1).reshape(bw // m, rows), chunk)
        dscale = per_row.view(m, h).sum(0)
        return (dqkv, dbias.to(bias.dtype).view(bias.shape),
                dscale.to(scale.dtype).view(scale.shape))


class _Reference(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, scale):
        out, stats = forward_reference(qkv, bias, scale)
        ctx.save_for_backward(qkv, bias, scale, stats)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        return backward_reference(*ctx.saved_tensors, grad_out)


def window_attention_reference(qkv: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                               heads: int) -> torch.Tensor:
    """The kernels' algorithm in plain PyTorch, with its gradient, on any
    device: ``qkv`` (bw, n, 3 h d) or (bw, n, 3, h, d) -> (bw, n, h d)."""
    bw, n = qkv.shape[:2]
    return _Reference.apply(qkv.reshape(bw, n, 3, heads, -1), bias, scale)


def _check(qkv, bias, scale) -> None:
    if not takes(qkv, bias, scale) or any(
            t.data_ptr() % _ALIGN for t in (qkv, bias)):
        raise ValueError(
            "the window-attention kernels take CUDA bf16 tensors on one device, 16-byte "
            f"aligned: qkv contiguous (bw, {TOKENS}, 3, h, {HEAD_DIM}), bias contiguous "
            f"(1, m h, {TOKENS}, {TOKENS}) with m dividing bw, scale with h elements; got "
            f"qkv {qkv.dtype} {tuple(qkv.shape)} on {qkv.device}, bias {bias.dtype} "
            f"{tuple(bias.shape)}, scale {scale.dtype} {tuple(scale.shape)}")


_entries = {}


def _launcher(name: str, pointers: int, ints: int):
    """The C entry point: ``pointers`` pointers, the windows (int64),
    ``ints`` ints and the stream, pointers and stream as c_void_p (a
    default ctypes int would cut a 64-bit pointer); typed once."""
    if name not in _entries:
        fn = getattr(_build.load("window_attention"), name)
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * pointers + [ctypes.c_int64] + [ctypes.c_int] * ints + [ptr]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return _entries[name]


def _launch(name: str, counter, tensors, qkv, *ints: int) -> None:
    """Launch ``name`` on qkv's device and current stream with the
    tensors' pointers, qkv's windows and heads, and ``ints``."""
    bw, _, _, h, _ = qkv.shape
    index = qkv.device.index
    # the kernels launch on the current device: switch only where it differs
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _launcher(name, len(tensors), 1 + len(ints))(
            *(t.data_ptr() for t in tensors), bw, h, *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")
    with _launches_lock:  # autograd runs backward on its own threads
        counter.launches += 1


def window_attention_forward(qkv: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor):
    """-> (out (bw, n, h d), stats (bw, h, 3, n) float32): the kernel on
    CUDA tensors, the plain version on CPU ones."""
    if qkv.device.type == "cpu":
        return forward_reference(qkv, bias, scale)
    _check(qkv, bias, scale)
    bw, n, _, h, d = qkv.shape
    out = torch.empty((bw, n, h * d), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((bw, h, 3, n), dtype=torch.float32, device=qkv.device)
    _launch("window_attention_forward_launch", window_attention_forward,
            (qkv, bias, scale, out, stats), qkv, bias.shape[1])
    return out, stats


def window_attention_backward(qkv: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                              stats: torch.Tensor, grad_out: torch.Tensor):
    """-> the gradients of qkv, bias and scale under ``grad_out``: the
    kernels on CUDA tensors, the plain version on CPU ones."""
    if qkv.device.type == "cpu":
        return backward_reference(qkv, bias, scale, stats, grad_out)
    _check(qkv, bias, scale)
    bw, n, _, h, d = qkv.shape
    if grad_out.shape != (bw, n, h * d) or grad_out.dtype != qkv.dtype:
        raise ValueError(f"grad_out must be {qkv.dtype} {(bw, n, h * d)}, got "
                         f"{grad_out.dtype} {tuple(grad_out.shape)}")
    if (stats.shape != (bw, h, 3, n) or stats.dtype != torch.float32
            or stats.device != qkv.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be contiguous float32 {(bw, h, 3, n)} on {qkv.device}, "
                         f"got {stats.dtype} {tuple(stats.shape)} on {stats.device}")
    grad_out = grad_out.contiguous()
    if grad_out.data_ptr() % _ALIGN:
        grad_out = grad_out.clone()
    rows = bias.shape[1]
    windows = bw // (rows // h)
    chunk = chunk_size(rows, windows, backward_slots(qkv.device))
    chunks = -(-windows // chunk)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(bias)
    dscale = torch.empty_like(scale)
    # per (chunk, bias row): its 64 x 64 sum, then its scale's sum
    partial = torch.empty(chunks * rows * (n * n + 1), dtype=torch.float32,
                          device=qkv.device)
    _launch("window_attention_backward_launch", window_attention_backward,
            (qkv, bias, scale, stats, grad_out, dqkv, dbias, dscale, partial), qkv, rows,
            chunk)
    return dqkv, dbias, dscale


window_attention_forward.launches = 0
window_attention_backward.launches = 0


class WindowAttentionFn(torch.autograd.Function):
    """The attention of ``(qkv, bias, scale)``, saving qkv and the f32 row
    statistics; see the module's docstring."""

    @staticmethod
    def forward(ctx, qkv, bias, scale):
        out, stats = window_attention_forward(qkv, bias, scale)
        ctx.save_for_backward(qkv, bias, scale, stats)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        return window_attention_backward(*ctx.saved_tensors, grad_out)

