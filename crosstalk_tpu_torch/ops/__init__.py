"""Kernels (``input_block``) and the batched classical metrics (the JAX
package's names)."""

from crosstalk_tpu_torch.ops.metrics import (
    classical_metrics,
    hist_correlation,
    nmi,
    pearson,
    rmse,
    ssim,
)

__all__ = [
    "classical_metrics",
    "hist_correlation",
    "nmi",
    "pearson",
    "rmse",
    "ssim",
]
