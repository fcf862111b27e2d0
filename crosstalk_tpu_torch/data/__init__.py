"""Tile pairing, TIFF decode and the host -> device batch pipeline.

The JAX package's names, with ``device_batches`` for its
``device_prefetch`` (pinned host buffers and asynchronous copies in place
of a JAX prefetch of sharded device arrays).
"""

from crosstalk_tpu_torch.data.index import (
    PairIndex,
    Sample,
    UnlabeledIndex,
    pair_unlabeled,
    split_samples,
)
from crosstalk_tpu_torch.data.pipeline import (
    Batch,
    DeviceDataset,
    TileStore,
    device_batches,
    iterate_batches,
    load_tiles,
    num_batches,
)
from crosstalk_tpu_torch.data.tiff import read_tile
from crosstalk_tpu_torch.data.transforms import normalize_tile, paired_random_flips

__all__ = [
    "PairIndex",
    "Sample",
    "UnlabeledIndex",
    "pair_unlabeled",
    "split_samples",
    "read_tile",
    "normalize_tile",
    "paired_random_flips",
    "Batch",
    "TileStore",
    "DeviceDataset",
    "load_tiles",
    "iterate_batches",
    "num_batches",
    "device_batches",
]
