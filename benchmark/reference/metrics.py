"""The five classical image-comparison metrics of the published eval script
(djpbarry/Torch-Unet ``test-cross-talk-model.py``), per tile in float64
numpy and scipy, on the min-max normalized mixed (channel 0) and source
(channel 1) planes:

* Pearsons Correlation: ``scipy.stats.pearsonr`` of the pixels (NaN when a
  plane is constant);
* Root Mean Squared Error: ``sqrt(mean((a - b)^2))``;
* Structural Similarity Index: skimage's ``structural_similarity`` at its
  defaults (7x7 uniform window, K1 0.01, K2 0.03, sample covariance, the
  mean over the map without its 3-pixel border) with
  ``data_range = max(max a, max b) - min(min a, min b)``;
* Histogram Correlation: Pearson r of ``np.histogram(plane, bins=256)`` of
  the two planes;
* Normalized Mutual Information: scikit-learn's
  ``normalized_mutual_info_score`` (arithmetic mean, natural log) of
  ``np.digitize(plane, np.linspace(min, max, 256))``.

This file imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.ndimage import uniform_filter

NAMES = ("Root Mean Squared Error", "Structural Similarity Index",
         "Histogram Correlation", "Normalized Mutual Information",
         "Pearsons Correlation")


def normalize(plane: np.ndarray) -> np.ndarray:
    p = plane.astype(np.float64)
    lo, hi = p.min(), p.max()
    return (p - lo) / (hi - lo) if hi > lo else p


def _pearson(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.ravel(), b.ravel()
    if a.max() == a.min() or b.max() == b.min():
        return float("nan")
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


def _ssim(a: np.ndarray, b: np.ndarray, data_range: float) -> float:
    win, pad = 7, 3
    cov = win * win / (win * win - 1.0)
    ux, uy = uniform_filter(a, win), uniform_filter(b, win)
    vx = cov * (uniform_filter(a * a, win) - ux * ux)
    vy = cov * (uniform_filter(b * b, win) - uy * uy)
    vxy = cov * (uniform_filter(a * b, win) - ux * uy)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return float(s[pad:-pad, pad:-pad].mean())


def _entropy(counts: np.ndarray) -> float:
    p = counts[counts > 0] / counts.sum()
    return float(-(p * np.log(p)).sum())


def _nmi(a: np.ndarray, b: np.ndarray) -> float:
    la = np.digitize(a.ravel(), np.linspace(a.min(), a.max(), 256))
    lb = np.digitize(b.ravel(), np.linspace(b.min(), b.max(), 256))
    _, ia = np.unique(la, return_inverse=True)
    _, ib = np.unique(lb, return_inverse=True)
    na, nb = ia.max() + 1, ib.max() + 1
    if na == nb == 1:
        return 1.0
    joint = np.bincount(ia * nb + ib, minlength=na * nb).reshape(na, nb).astype(np.float64)
    n = joint.sum()
    pa, pb = joint.sum(1) / n, joint.sum(0) / n
    nz = joint > 0
    pij = joint[nz] / n
    mi = float((pij * (np.log(pij) - np.log(np.outer(pa, pb)[nz]))).sum())
    if mi == 0.0:
        return 0.0
    return mi / (0.5 * (_entropy(joint.sum(1)) + _entropy(joint.sum(0))))


def tile_metrics(mixed: np.ndarray, source: np.ndarray) -> Dict[str, float]:
    """Raw (H, W) planes -> the five metrics."""
    a, b = normalize(mixed), normalize(source)
    ha = np.histogram(a, bins=256)[0].astype(np.float64)
    hb = np.histogram(b, bins=256)[0].astype(np.float64)
    dr = max(a.max(), b.max()) - min(a.min(), b.min())
    return {
        "Root Mean Squared Error": float(np.sqrt(np.mean((a - b) ** 2))),
        "Structural Similarity Index": _ssim(a, b, dr),
        "Histogram Correlation": _pearson(ha, hb),
        "Normalized Mutual Information": _nmi(a, b),
        "Pearsons Correlation": _pearson(a, b),
    }
