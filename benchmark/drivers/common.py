"""Helpers the drivers share: the program's view of a configuration file and
of the benchmark's tiles."""

from __future__ import annotations

import numpy as np


def model_config(config: dict):
    """The configuration file -> the program's ``ModelConfig``."""
    from crosstalk_tpu_torch.config import ModelConfig

    kw = dict(variant=config["variant"], leaky_slope=config["leaky_slope"],
              bn_eps=config["bn_eps"], bn_momentum=config["bn_momentum"],
              compute_dtype=config["compute_dtype"])
    if config["variant"] == "single":
        kw.update(input_channels=config["input_channels"],
                  initial_filters=config["initial_filters"],
                  num_conv_blocks=config["num_conv_blocks"],
                  max_filters=config["max_filters"], dropout_single=config["dropout"])
    else:
        kw.update(initial_filters_per_branch=config["initial_filters_per_branch"],
                  dropout_double=config["dropout"])
    return ModelConfig(**kw)


def tile_store(tiles: np.ndarray, alphas: np.ndarray):
    """A ``TileStore`` over tiles already in memory: the packed
    (N, H, W, 2) float32 array and labels that the eval and train CLIs'
    store holds once it has decoded a directory of TIFF pairs (image ids
    0..N-1)."""
    from crosstalk_tpu_torch.data.index import Sample
    from crosstalk_tpu_torch.data.pipeline import TileStore

    store = TileStore.__new__(TileStore)
    store.samples = [Sample(str(i), float(a), "", "") for i, a in enumerate(alphas)]
    store.labels = np.asarray(alphas, np.float32).reshape(-1, 1)
    store.ids = np.arange(len(alphas), dtype=np.int64)
    store.tiles = tiles
    return store


def gap(got: float, want: float, scale: float) -> float:
    """|got - want| / scale, with a NaN on one side only read as infinite."""
    if np.isnan(got) and np.isnan(want):
        return 0.0
    if np.isnan(got) or np.isnan(want):
        return float("inf")
    return abs(got - want) / scale
