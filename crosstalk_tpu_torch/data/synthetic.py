"""Synthetic paired-tile dataset generator (the port's copy of
crosstalk_tpu/data/synthetic.py: the ``uniform`` and ``microscopy``
presets, in the reference's on-disk layout; pure numpy, so the same seed
writes the same bytes as the JAX package).

The reference repo bundles ``Training_Data/{Mixed,Source}`` — 100 paired
256x256 float64 TIFFs named ``image_<ID>_alpha_<A>_(mixed|source).tif``
(schema regex train_model.py:105). This module generates an equivalent:
blobby structure with a known bleed-through coefficient,
``mixed = other + alpha * source``. The train CLI's quickstart bootstrap
uses it: a zero-flag ``python -m crosstalk_tpu_torch.cli.train`` writes the
sample set when ``./Training_Data`` is missing; so do
``tools/make_dataset.py``, ``tools/scale_bench.py`` and
``tools/unmix_demo.py``.
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


def _blur(x: np.ndarray, sigma: float) -> np.ndarray:
    """FFT Gaussian blur (periodic boundary; numpy-only, no scipy)."""
    k = np.fft.fftfreq(x.shape[0])
    g = np.exp(-2.0 * (np.pi * k * sigma) ** 2)
    return np.real(np.fft.ifft2(np.fft.fft2(x) * np.outer(g, g)))


def _norm01(x: np.ndarray) -> np.ndarray:
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo)


def generate_pair_microscopy(rng: np.random.Generator, size: int):
    """-> (mixed, source, alpha): one pair matched to the REAL bundled IDR
    tiles' statistics (the reference's Training_Data):

    * right-skewed sparse intensities — after per-tile min-max
      normalization the real tiles put ~57% of pixels in the bottom decile
      (normalized mean 0.12-0.15); v1 ``generate_pair`` is uniform
      (mean 0.50). Achieved by raising a blurred Gaussian field to a
      power p ∈ [1.5, 5].
    * wide per-tile structural variance — the real per-tile power-spectrum
      centroid spans ~5-37 px⁻¹ (22.8 ± 14.4) and foreground fraction
      0.50 ± 0.42: some tiles are dense cell fields, some nearly empty.
      Blur sigma is sampled log-uniform [1, 8] per pair, plus per-pixel
      shot-noise at a sampled level.
    * CORRELATED channels — the real mixed tile's non-source component is
      another channel of the same acquisition: corr(mixed − α·source,
      source) measured anywhere from 0.08 to 0.99. The two fields here
      share a latent structure with per-pair weight w ∈ [0, 0.95].
    * faint raw source — real source tiles span ~[0.003, 0.05] raw (a
      detector offset + weak signal) while mixed tiles are O(0.2-1).
      Mixing happens in FIELD units (mixed = other + α·source_field), so
      the raw-unit regression slope is α/c_src — the 7-800× spread seen
      in the real pairs.

    Alpha stays identifiable from the normalized pair through the shared-
    structure clutter, but the task is materially harder than v1 (that is
    the point: v1-trained models transfer poorly to the real tiles —
    TRAINING_RESULTS "sim-to-real").
    """
    alpha = round(float(rng.uniform(0.01, 0.5)), 2)

    sigma = float(np.exp(rng.uniform(np.log(1.0), np.log(8.0))))
    p = float(rng.uniform(1.5, 5.0))
    w = float(rng.uniform(0.0, 0.95))
    noise = float(rng.uniform(0.0, 0.08))

    g_shared = _blur(rng.standard_normal((size, size)), sigma)
    g_src = _blur(rng.standard_normal((size, size)), sigma)
    g_oth = _blur(rng.standard_normal((size, size)), sigma)

    def channel(own):
        f = _norm01(w * g_shared + (1.0 - w) * own) ** p
        f = f + noise * rng.random((size, size))
        return f

    source_f = channel(g_src)
    other_f = channel(g_oth)

    # raw units: faint source (detector offset + weak scale), bright mixed
    c_src = float(np.exp(rng.uniform(np.log(0.004), np.log(0.05))))
    source = 0.0035 + c_src * source_f
    c_mix = float(rng.uniform(0.3, 1.0))
    off_m = float(rng.uniform(0.05, 0.3))
    mixed = off_m + c_mix * (other_f + alpha * source_f)
    return mixed, source, alpha


# Every preset is called as fn(rng, size, block=...) by generate_dataset;
# ``block`` is the v1 blob granularity and presets that don't have the
# concept ignore it. tools/make_dataset derives its --preset choices
# from this registry — adding a preset here is the only required change.
_PRESETS = {
    "uniform": generate_pair,  # v1: dense uniform blocks, independent channels
    "microscopy": lambda rng, size, block=8: generate_pair_microscopy(rng, size),
}


def generate_dataset(
    out_dir: str,
    num_pairs: int = 1000,
    size: int = 256,
    seed: int = 0,
    start_id: int = 100000,
    progress_every: int = 500,
    block: int = 8,
    preset: str = "uniform",
) -> tuple:
    """Write ``num_pairs`` paired float64 tiles under ``out_dir`` in the
    reference's exact layout; returns (mixed_dir, source_dir).

    ``preset='uniform'`` is the v1 generator (dense fields, independent
    channels — easy identifiability); ``preset='microscopy'`` matches the
    real bundled IDR tiles' statistics (see generate_pair_microscopy)."""
    if preset not in _PRESETS:
        raise ValueError(f"unknown preset {preset!r}; "
                         f"options: {sorted(_PRESETS)}")
    mixed_dir = os.path.join(out_dir, "Mixed")
    source_dir = os.path.join(out_dir, "Source")
    os.makedirs(mixed_dir, exist_ok=True)
    os.makedirs(source_dir, exist_ok=True)

    rng = np.random.default_rng(seed)
    for i in range(num_pairs):
        mixed, source, alpha = _PRESETS[preset](rng, size, block=block)
        name = f"image_{start_id + i}_alpha_{alpha}"
        write_tile(os.path.join(mixed_dir, f"{name}_mixed.tif"), mixed)
        write_tile(os.path.join(source_dir, f"{name}_source.tif"), source)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"{i + 1}/{num_pairs}", flush=True)
    return mixed_dir, source_dir
