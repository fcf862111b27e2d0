"""Real-texture remix dataset: labeled mixtures synthesized FROM real tiles
(the port's copy of crosstalk_tpu/data/remix.py; pure numpy, so the same
seed and bank write the same bytes as the JAX package).

Statistics-*imitating* synthesis (`data/synthetic.py`
``microscopy`` preset) does not transfer to the reference's 100 real bundled
IDR tiles (TRAINING_RESULTS "Sim-to-real": every synthetic-trained checkpoint
scores worse than predict-the-mean on the real labels). This module is the
stronger experiment: instead of imitating the real tiles' statistics, use the
real tiles THEMSELVES as base textures and inject bleed-through with *drawn,
known* alphas —

    mixed_field = base_field + alpha * source_field,   alpha ~ U[0.01, 0.5]

so every generated pair has genuine microscopy texture (reference
``Training_Data``, README.md:5 — the tool's actual domain) with a label that
is true by construction. The open question this answers: does a model trained
on real-texture known-alpha mixes (a) generalize to held-out real textures it
never saw, and (b) predict the real bundle's own filename alphas?

Construction per generated pair (all draws from one seeded Generator):

  * **source texture** = a real SOURCE tile (faint raw units preserved —
    detector offset + weak signal, exactly the deployment source channel),
    dihedral-transformed (one of the 8 flips/rotations; no wrap-around rolls,
    which would add seam artifacts real tiles don't have).
  * **base texture** = a real MIXED tile of a *different* image id, also
    dihedral-transformed. A real mixed tile is the most faithful "other
    channel": real background, real cells, and — honestly — whatever bleed
    its own acquisition already carried from ITS paired source. Because the
    base is always a different image id, that residue is uncorrelated clutter
    with respect to the drawn label, never label contamination. (Same-id
    pairing is excluded exactly so the drawn alpha stays the unique
    coefficient of the written source tile.)
  * **mixing** happens in per-tile min-max field units (the model's own
    input normalization, train_model.py:211-216, makes raw affine scale
    invisible to the network), then the written mixed tile is re-scaled to
    the real mixed tiles' raw range (offset 0.05-0.3, scale 0.3-1.0 — the
    measured bundle statistics, see ``generate_pair_microscopy``). The
    written source tile keeps its ORIGINAL raw values: min-max normalization
    is invariant to that choice, and the original is the realistic artifact.

Texture-held-out protocol: ``split_texture_ids`` deterministically partitions
the real image ids so a held-out set can be built from textures the training
corpus NEVER saw (score (a) above is then a real generalization claim, not a
memorization one). Score (b) is the eval CLI run on the untouched real bundle.

Outputs use the reference's exact on-disk layout
(``image_<ID>_alpha_<A>_(mixed|source).tif``, float64 — schema regex
train_model.py:105) so the standard train/eval CLIs consume them unchanged.
"""

from __future__ import annotations

import os

import numpy as np

from crosstalk_tpu_torch.data.index import PairIndex
from crosstalk_tpu_torch.data.tiff import read_tile, write_tile


def _norm01(x: np.ndarray) -> np.ndarray:
    lo, hi = float(x.min()), float(x.max())
    if hi <= lo:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def _dihedral(x: np.ndarray, k: int) -> np.ndarray:
    """One of the 8 square-symmetry transforms (k in 0..7)."""
    if k & 4:
        x = x.T
    if k & 1:
        x = x[::-1]
    if k & 2:
        x = x[:, ::-1]
    return np.ascontiguousarray(x)


def split_texture_ids(mixed_dir: str, source_dir: str,
                      holdout_frac: float = 0.2, seed: int = 43):
    """Deterministically partition the real bank's image ids.

    -> (train_ids, holdout_ids), each a sorted list of image-id strings.
    The permutation is seeded so the same bank always splits identically;
    generate the training corpus from ``train_ids`` and the texture-held-out
    evaluation corpus from ``holdout_ids``.
    """
    ids = sorted({s.image_id for s in
                  PairIndex(mixed_dir, source_dir).samples})
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(ids))
    n_hold = int(round(holdout_frac * len(ids)))
    hold = {ids[i] for i in perm[:n_hold]}
    return sorted(set(ids) - hold), sorted(hold)


class RemixBank:
    """In-memory bank of real tiles, filtered to an image-id subset.

    Loads every tile once (the reference bundle is 100 pairs x 512 KB — tiny);
    ``pair(rng)`` then draws remixed pairs at numpy speed.
    """

    def __init__(self, mixed_dir: str, source_dir: str, image_ids=None):
        samples = PairIndex(mixed_dir, source_dir).samples
        if image_ids is not None:
            keep = set(image_ids)
            samples = [s for s in samples if s.image_id in keep]
        # the invariant pair() depends on is >=2 DISTINCT image ids (its
        # rejection loop draws until base id != source id), not >=2 samples:
        # one image mixed at several alphas is legal under PairIndex's
        # (image_id, alpha) key and would loop forever
        if len({s.image_id for s in samples}) < 2:
            raise ValueError(
                f"remix needs >=2 distinct image ids after filtering, got "
                f"{len({s.image_id for s in samples})} across "
                f"{len(samples)} pairs from {mixed_dir!r}/{source_dir!r}")
        self.ids = [s.image_id for s in samples]
        self.mixed = [read_tile(s.mixed_path, dtype=np.float64)
                      for s in samples]
        self.source = [read_tile(s.source_path, dtype=np.float64)
                       for s in samples]
        shape = self.mixed[0].shape
        for arr in (*self.mixed, *self.source):
            if arr.shape != shape:
                raise ValueError(
                    f"real bank tiles disagree on shape: {arr.shape} vs {shape}")
        self.size = shape[0]

    def pair(self, rng: np.random.Generator):
        """-> (mixed, source, alpha): one remixed pair with a drawn label."""
        i = int(rng.integers(len(self.ids)))
        while True:
            j = int(rng.integers(len(self.ids)))
            if self.ids[j] != self.ids[i]:
                break
        alpha = round(float(rng.uniform(0.01, 0.5)), 2)

        source_raw = _dihedral(self.source[i], int(rng.integers(8)))
        base_raw = _dihedral(self.mixed[j], int(rng.integers(8)))

        mixed_field = _norm01(base_raw) + alpha * _norm01(source_raw)
        # written mixed tile re-scaled to the real mixed tiles' raw range;
        # the written source keeps its original raw values (min-max
        # normalization is invariant to both choices)
        off = float(rng.uniform(0.05, 0.3))
        scale = float(rng.uniform(0.3, 1.0))
        return off + scale * mixed_field, source_raw, alpha


def generate_remix_dataset(
    out_dir: str,
    mixed_dir: str,
    source_dir: str,
    num_pairs: int = 2000,
    seed: int = 0,
    start_id: int = 500000,
    image_ids=None,
    progress_every: int = 500,
) -> tuple:
    """Write ``num_pairs`` remixed paired float64 tiles under ``out_dir`` in
    the reference's exact layout; returns (mixed_dir, source_dir).

    ``image_ids`` restricts the real-texture bank (see ``split_texture_ids``
    for the train/held-out texture protocol).
    """
    bank = RemixBank(mixed_dir, source_dir, image_ids=image_ids)
    out_mixed = os.path.join(out_dir, "Mixed")
    out_source = os.path.join(out_dir, "Source")
    os.makedirs(out_mixed, exist_ok=True)
    os.makedirs(out_source, exist_ok=True)

    rng = np.random.default_rng(seed)
    for i in range(num_pairs):
        mixed, source, alpha = bank.pair(rng)
        name = f"image_{start_id + i}_alpha_{alpha}"
        write_tile(os.path.join(out_mixed, f"{name}_mixed.tif"), mixed)
        write_tile(os.path.join(out_source, f"{name}_source.tif"), source)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"{i + 1}/{num_pairs}", flush=True)
    return out_mixed, out_source
