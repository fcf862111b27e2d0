"""The documented draws of the program's train step, frozen here so that
the reference recomputes them from (seed, step) alone.

* Batch order: each epoch a permutation of the tile indices by
  ``numpy.random.default_rng(SeedSequence([seed, epoch]))``, cut into
  batches with the last partial one dropped.
* Flips: a counter hash of (seed, step, stream 1) and each example's
  index in the step's batch; bit 31 of the hash flips horizontally, bit 30
  vertically.
* Dropout: a generator on the batch's device seeded with the counter hash
  of (seed, step, stream 2, microbatch 0); the two head dropouts draw their
  keep masks from it in order, each ``bernoulli(1 - p)`` over a tensor of
  the activation's shape and compute type.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

_M32 = 0xFFFFFFFF
FLIP_STREAM = 1
DROPOUT_STREAM = 2


def _mix32(x):
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def counter_key(*words: int) -> int:
    h = 0x243F6A88
    for w in words:
        h = _mix32(h ^ (w & _M32))
    return h


def epoch_batches(n: int, batch: int, seed: int, epoch: int) -> List[np.ndarray]:
    order = np.arange(n)
    np.random.default_rng(np.random.SeedSequence([seed, epoch])).shuffle(order)
    return [order[i:i + batch] for i in range(0, (n // batch) * batch, batch)]


def flips(seed: int, step: int, rows: int, device) -> torch.Tensor:
    """-> (rows, 2) bool: (horizontal, vertical) per example."""
    index = torch.arange(rows, device=device, dtype=torch.int64)
    h = _mix32(_mix32(index ^ counter_key(seed, step, FLIP_STREAM)))
    return torch.stack([(h >> 31) & 1, (h >> 30) & 1], dim=1).bool()


def dropout_masks(seed: int, step: int, rows: int, p: float, dtype,
                  device) -> List[torch.Tensor]:
    """-> the two head dropouts' keep masks, (rows, 512) and (rows, 128),
    as float32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(counter_key(seed, step, DROPOUT_STREAM, 0))
    return [torch.empty((rows, n), dtype=dtype, device=device)
            .bernoulli_(1.0 - p, generator=gen).float() for n in (512, 128)]
