"""Filename-pairing data index (the port's copy of crosstalk_tpu/data/index.py:
the labeled pairing with the same regex and sample order, the unlabeled
pairing by filename stem of the predict CLI, and the train CLI's seeded
70/15/15 split).

Reimplements the reference's dataset-discovery semantics (reference
train_model.py:97-154, duplicated at test-cross-talk-model.py:125-182 — here
implemented once) byte-for-byte:

  * files are matched by the regex ``image_(\\d+)_alpha_(\\d+\\.?\\d*)_(mixed|source)\\.tif``
    (train_model.py:105);
  * the alpha value from the filename is kept as a *string* in the pairing key
    to avoid float-comparison issues (train_model.py:108,118);
  * a mixed file in the mixed dir is joined to a source file in the source dir
    on the compound key ``(image_id, alpha_str)``; unpaired entries are dropped
    (train_model.py:133-141);
  * a ``ValueError`` is raised when no pairs are found (train_model.py:143-146);
  * samples are sorted by ``(image_id, scalar_label)`` — note image_id is a
    *string*, so the order is lexicographic on the id, exactly like the
    reference's sort (train_model.py:150) — which makes splits stable.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional, Sequence

import torch

FILE_PATTERN = re.compile(r"image_(\d+)_alpha_(\d+\.?\d*)_(mixed|source)\.tif")


@dataclasses.dataclass(frozen=True)
class Sample:
    """One paired (mixed, source) tile with its alpha label."""

    image_id: str        # kept as a string (sort key + eval CSV Image_ID column)
    scalar_label: float  # alpha, parsed from the filename
    mixed_path: str
    source_path: str


def _scan_dir(directory: str, want_type: str) -> dict:
    """Map ``(image_id, alpha_str) -> filename`` for files of ``want_type``.

    Mirrors process_files_in_dir (train_model.py:112-126): only ``.tif`` files,
    only names matching the pattern, and only the type expected for the
    directory (a 'source' file sitting in the mixed dir is ignored).
    """
    found = {}
    for filename in os.listdir(directory):
        if not filename.endswith(".tif"):
            continue
        match = FILE_PATTERN.search(filename)
        if not match:
            continue
        image_id, alpha_str, file_type = match.groups()
        if file_type == want_type:
            found[(image_id, alpha_str)] = filename
    return found


class PairIndex:
    """The sorted list of paired samples for a (mixed_dir, source_dir) pair."""

    def __init__(self, mixed_dir: str, source_dir: str):
        self.mixed_dir = mixed_dir
        self.source_dir = source_dir

        mixed = _scan_dir(mixed_dir, "mixed")
        source = _scan_dir(source_dir, "source")

        samples: List[Sample] = []
        for key, mixed_file in mixed.items():
            source_file = source.get(key)
            if source_file is None:
                continue
            image_id, alpha_str = key
            samples.append(
                Sample(
                    image_id=image_id,
                    scalar_label=float(alpha_str),
                    mixed_path=os.path.join(mixed_dir, mixed_file),
                    source_path=os.path.join(source_dir, source_file),
                )
            )

        if not samples:
            raise ValueError(
                "No matching samples found. Ensure filenames adhere to "
                "'image_ID_alpha_VALUE_(mixed|source).tif' pattern and "
                "corresponding mixed/source files exist for each (ID, Alpha) pair."
            )

        # Stable, reference-identical order: lexicographic id, then float alpha.
        samples.sort(key=lambda s: (s.image_id, s.scalar_label))
        self.samples: List[Sample] = samples

    def __len__(self) -> int:
        return len(self.samples)


# --- unlabeled pairing (deployment extension, no reference counterpart) ---
#
# The reference can only read tiles whose filenames embed the ground-truth
# alpha (FILE_PATTERN above, train_model.py:105), so it cannot score new
# acquisitions: they have no alpha to put in the name. ``pair_unlabeled``
# pairs tiles by filename stem instead, for the predict CLI (cli/predict.py).

_TIF_EXTS = (".tif", ".tiff")
_ROLE_TOKENS = {
    "mixed": ("mixed", "bleed"),
    "source": ("source", "pure"),
}


def _unlabeled_key(filename: str, role: str) -> Optional[str]:
    """Pairing key for an unlabeled tile: the lowercased stem, with a
    trailing role token (``_mixed``/``-bleed``/``.source``/...) stripped so
    the two directories' conventional namings line up. Keys are
    case-insensitive; identical filenames in both dirs pair too (no token to
    strip). Non-TIFF files map to ``None``."""
    stem, ext = os.path.splitext(filename)
    if ext.lower() not in _TIF_EXTS:
        return None
    low = stem.lower()
    for token in _ROLE_TOKENS[role]:
        for sep in ("_", "-", "."):
            suffix = sep + token
            if low.endswith(suffix):
                return low[: -len(suffix)]
    return low


@dataclasses.dataclass(frozen=True)
class UnlabeledIndex:
    """Result of ``pair_unlabeled``: paired samples (``scalar_label`` is NaN,
    there is no ground truth) and the filenames that found no partner."""

    samples: List[Sample]
    unpaired_mixed: List[str]
    unpaired_source: List[str]


def pair_unlabeled(mixed_dir: str, source_dir: str) -> UnlabeledIndex:
    """Pair (mixed, source) tiles across two directories by filename stem.

    ``foo_mixed.tif`` pairs with ``foo_source.tif``, ``scan3-bleed.tiff``
    with ``scan3-source.tiff``, and ``cell7.tif`` with ``cell7.tif``. Keys
    are case-insensitive (the reported ``image_id`` is the lowercased key).
    The labeled reference schema pairs too. Raises ``ValueError`` on an
    ambiguous directory (two files normalizing to one key, including by case
    alone) or when nothing pairs.
    """
    def scan(directory: str, role: str) -> dict:
        keyed: dict = {}
        for filename in sorted(os.listdir(directory)):
            key = _unlabeled_key(filename, role)
            if key is None:
                continue
            if key in keyed:
                raise ValueError(
                    f"Ambiguous {role} directory: '{keyed[key]}' and "
                    f"'{filename}' both normalize to pairing key '{key}'."
                )
            keyed[key] = filename
        return keyed

    mixed = scan(mixed_dir, "mixed")
    source = scan(source_dir, "source")

    samples = [
        Sample(
            image_id=key,
            scalar_label=float("nan"),
            mixed_path=os.path.join(mixed_dir, mixed[key]),
            source_path=os.path.join(source_dir, source[key]),
        )
        for key in sorted(mixed.keys() & source.keys())
    ]
    if not samples:
        raise ValueError(
            "No pairable tiles found: no filename stem (after stripping a "
            "trailing _mixed/_bleed or _source/_pure token) appears in both "
            "directories."
        )
    return UnlabeledIndex(
        samples=samples,
        unpaired_mixed=sorted(mixed[k] for k in mixed.keys() - source.keys()),
        unpaired_source=sorted(source[k] for k in source.keys() - mixed.keys()),
    )


def split_samples(
    samples: Sequence[Sample],
    train_ratio: float,
    val_ratio: float,
    seed: int = 43,
):
    """Deterministic 3-way split -> (train, val, test) sample lists.

    The reference shuffles indices with ``torch.manual_seed(43);
    torch.randperm(N)`` (train_model.py:576-585); this draws the same
    permutation from a CPU generator seeded alike, so the same files land in
    each split as in the reference and in the JAX package.
    """
    n = len(samples)
    gen = torch.Generator()
    gen.manual_seed(seed)
    perm = torch.randperm(n, generator=gen).tolist()

    train_size = int(train_ratio * n)
    val_size = int(val_ratio * n)
    train = [samples[i] for i in perm[:train_size]]
    val = [samples[i] for i in perm[train_size : train_size + val_size]]
    test = [samples[i] for i in perm[train_size + val_size :]]
    return train, val, test
