"""Device-side tile transforms (port of crosstalk_tpu/data/transforms.py).

  * normalize: per-tile min-max ``(img - min) / (max - min)``, identity when
    the tile is constant (reference train_model.py:211-216);
  * train augmentation: horizontal flip with p=0.5 and vertical flip with
    p=0.5, each applied to *both* channels of a sample together
    (train_model.py:227-234), run on the batch's device.

The flips come from a counter-based hash of (seed, global step, global
example index), computed on the device with integer tensor ops: no
generator state, no host round trip, and a draw that does not depend on
how the step's batch is cut into microbatches. The JAX package draws from
``fold_in`` of its PRNG key instead, so the two packages flip different
samples for the same seed (a port divergence, ROADMAP §3).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
# stream tags of ``counter_key``: one per independent draw of a train step
FLIP_STREAM = 1
DROPOUT_STREAM = 2


def _mix32(x):
    """A 32-bit integer finalizer (xor-shift-multiply) on a Python int or an
    int64 tensor holding values in [0, 2**32). The multipliers are below
    2**31, so every product fits in int64 and no step overflows."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def counter_key(*words: int) -> int:
    """Hash non-negative integers (seed, step, stream, ...) to a 32-bit key:
    the stateless counterpart of the JAX package's ``fold_in`` chain."""
    h = 0x243F6A88
    for w in words:
        h = _mix32(h ^ (w & _M32))
    return h


def normalize_batch_nhwc(batch: torch.Tensor) -> torch.Tensor:
    """Min-max normalize a (B, H, W, C) batch per (sample, channel) tile."""
    lo = batch.amin(dim=(1, 2), keepdim=True)
    hi = batch.amax(dim=(1, 2), keepdim=True)
    span = hi - lo
    safe = torch.where(span > 0, span, torch.ones_like(span))
    return torch.where(span > 0, (batch - lo) / safe, batch)


def flip_bits(seed: int, step: int, index: torch.Tensor) -> torch.Tensor:
    """-> (B, 2) bool: (hflip, vflip) for the examples at global indices
    ``index`` (int64) of train step ``step``. Each is 1 with p=1/2."""
    key = counter_key(seed, step, FLIP_STREAM)
    h = _mix32(_mix32(index ^ key))
    return torch.stack([(h >> 31) & 1, (h >> 30) & 1], dim=1).bool()


def paired_random_flips(batch: torch.Tensor, seed: int, step: int,
                        index_offset: int = 0) -> torch.Tensor:
    """Random horizontal + vertical flips, per sample, channels kept paired.

    ``batch`` is (B, H, W, C). Sample ``i`` draws from its global example
    index ``index_offset + i``, so a microbatch (or a data-parallel shard)
    passing its offset flips exactly what the whole batch would have: the
    draw is layout-invariant.
    """
    b = batch.shape[0]
    index = torch.arange(index_offset, index_offset + b, device=batch.device)
    bits = flip_bits(seed, step, index)
    do_h = bits[:, 0].view(b, 1, 1, 1)
    do_v = bits[:, 1].view(b, 1, 1, 1)
    batch = torch.where(do_h, batch.flip(2), batch)  # horizontal: flip W
    return torch.where(do_v, batch.flip(1), batch)   # vertical: flip H


def prepare_train_batch(raw_batch: torch.Tensor, seed: int, step: int,
                        augment: bool = True, index_offset: int = 0) -> torch.Tensor:
    """Full on-device preprocessing of a raw (B, H, W, 2) float32 batch."""
    batch = normalize_batch_nhwc(raw_batch)
    if augment:
        batch = paired_random_flips(batch, seed, step, index_offset=index_offset)
    return batch
