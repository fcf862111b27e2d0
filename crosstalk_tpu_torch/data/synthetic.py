"""Synthetic paired-tile dataset generator (the port's copy of the
``uniform`` preset of crosstalk_tpu/data/synthetic.py, in the reference's
on-disk layout; the same seed writes the same bytes).

The reference repo bundles ``Training_Data/{Mixed,Source}`` — 100 paired
256x256 float64 TIFFs named ``image_<ID>_alpha_<A>_(mixed|source).tif``
(schema regex train_model.py:105). This module generates an equivalent:
blobby structure with a known bleed-through coefficient,
``mixed = other + alpha * source``. The train CLI's quickstart bootstrap
uses it: a zero-flag ``python -m crosstalk_tpu_torch.cli.train`` writes the
sample set when ``./Training_Data`` is missing.
"""

from __future__ import annotations

import os

import numpy as np

from crosstalk_tpu_torch.data.tiff import write_tile


def generate_pair(rng: np.random.Generator, size: int, block: int = 8):
    """-> (mixed, source, alpha): one paired tile with known bleed-through.

    ``block`` sets the blob granularity. Alpha identifiability after the
    per-tile min-max normalization scales with the number of independent
    blobs (size/block)^2.
    """
    alpha = round(float(rng.uniform(0.01, 0.5)), 2)

    def field():
        # ceil division so any size works (the [:size, :size] crop can only
        # shrink)
        n = -(-size // block)
        base = rng.random((n, n))
        return np.kron(base, np.ones((block, block)))[:size, :size]

    source = field() + 0.05 * rng.random((size, size))
    other = field() + 0.05 * rng.random((size, size))
    return other + alpha * source, source, alpha


def generate_dataset(
    out_dir: str,
    num_pairs: int = 1000,
    size: int = 256,
    seed: int = 0,
    start_id: int = 100000,
    progress_every: int = 500,
    block: int = 8,
) -> tuple:
    """Write ``num_pairs`` paired float64 tiles under ``out_dir`` in the
    reference's exact layout; returns (mixed_dir, source_dir)."""
    mixed_dir = os.path.join(out_dir, "Mixed")
    source_dir = os.path.join(out_dir, "Source")
    os.makedirs(mixed_dir, exist_ok=True)
    os.makedirs(source_dir, exist_ok=True)

    rng = np.random.default_rng(seed)
    for i in range(num_pairs):
        mixed, source, alpha = generate_pair(rng, size, block=block)
        name = f"image_{start_id + i}_alpha_{alpha}"
        write_tile(os.path.join(mixed_dir, f"{name}_mixed.tif"), mixed)
        write_tile(os.path.join(source_dir, f"{name}_source.tif"), source)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"{i + 1}/{num_pairs}", flush=True)
    return mixed_dir, source_dir
