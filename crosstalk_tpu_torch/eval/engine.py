"""Evaluation engine (port of crosstalk_tpu/eval/engine.py).

Per batch, on the model's device: normalize -> forward -> squared error and
the five classical metrics; the host only formats CSV rows. Every sample is
evaluated through pad-and-mask: the last batch is padded with index-0 rows,
whose metric values are zeroed so they are visibly not samples, and the
loss divides by the number of real samples.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from crosstalk_tpu_torch.data.pipeline import (
    DeviceDataset,
    TileStore,
    device_batches,
    iterate_batches,
    num_batches,
)
from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
from crosstalk_tpu_torch.io import artifacts
from crosstalk_tpu_torch.ops.metrics import classical_metrics

_METRICS = artifacts.EVAL_FIELDNAMES[3:]


def _eval_step(forward: Callable, inputs, labels, mask, with_metrics: bool = True):
    """Normalize -> forward -> per-sample squared error (and metrics)."""
    batch = normalize_batch_nhwc(inputs)
    preds = forward(batch).float()
    sq_err = torch.square(preds - labels)[:, 0] * mask
    out = {"preds": preds[:, 0], "sq_err": sq_err}
    if with_metrics:
        # zero the padding rows; real constant tiles keep their
        # reference-semantics NaN
        out.update({
            k: torch.where(mask > 0, v, torch.zeros_like(v))
            for k, v in classical_metrics(batch).items()
        })
    return out


def model_forward(model: nn.Module, compute_dtype: str = "f32") -> Callable:
    """The nn.Module's eval forward on NHWC batches (``'bf16'`` runs it
    under bf16 autocast)."""
    device_type = next(model.parameters()).device.type

    def forward(batch_nhwc: torch.Tensor) -> torch.Tensor:
        with torch.autocast(device_type, dtype=torch.bfloat16,
                            enabled=compute_dtype == "bf16"):
            return model(batch_nhwc.permute(0, 3, 1, 2))

    return forward


def _progress(iterable, desc: Optional[str], total: int):
    if desc is None:
        return iterable
    try:
        from tqdm import tqdm
    except ImportError:  # tqdm is optional — plain iteration is fine
        return iterable
    return tqdm(iterable, desc=desc, total=total, disable=None)


@torch.inference_mode()
def evaluate(
    forward: Callable,
    store: Union[TileStore, DeviceDataset],
    device: torch.device,
    batch_size: int = 64,
    desc: Optional[str] = None,
    with_metrics: bool = True,
) -> Tuple[List[Dict], float]:
    """-> (per-sample rows in dataset order, mean MSE loss).

    ``forward(batch_nhwc) -> (B, 1)`` runs on ``device``: ``model_forward``
    or ``eval.fast_forward.make_fast_forward``. Rows use the 8-column eval
    schema (test-cross-talk-model.py:39-41) when ``with_metrics``, else the
    2-column train-side schema (train_model.py:68), with float32 values as
    the reference's CSVs print them. ``store`` may be a ``DeviceDataset``
    (batches gathered on the device)."""
    rows: List[Dict] = []
    total_sq_err = 0.0
    total_n = 0
    batch_size = min(batch_size, max(1, len(store)))
    if isinstance(store, DeviceDataset):
        batches = store.batches(batch_size)
    else:
        batches = device_batches(iterate_batches(store, batch_size), device)
    batches = _progress(batches, desc, num_batches(len(store), batch_size))
    for batch in batches:
        out = _eval_step(forward, batch.inputs, batch.labels, batch.mask,
                         with_metrics)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        labels = batch.labels.cpu().numpy()[:, 0]
        real = int(batch.mask.sum().item())
        total_sq_err += float(out["sq_err"].sum())
        total_n += real
        for j in range(real):
            row = {
                "Actual_Label": np.float32(labels[j]),
                "Predicted_Label": np.float32(out["preds"][j]),
            }
            if with_metrics:
                row = {"Image_ID": int(batch.ids[j]), **row,
                       **{k: np.float32(out[k][j]) for k in _METRICS}}
            rows.append(row)

    return rows, total_sq_err / max(total_n, 1)


def evaluate_and_save(
    forward: Callable,
    store: Union[TileStore, DeviceDataset],
    device: torch.device,
    dataset_name: str,
    output_dir: str,
    ts: str,
    batch_size: int = 64,
    train_suffix: Optional[str] = None,
) -> float:
    """Evaluate, write the predictions CSV and its plots.

    Eval side (``train_suffix`` None): ``{split}_predictions_{ts}.csv`` in
    the 8-column schema and one scatter per metric
    (test-cross-talk-model.py:92-121). Train side
    (``train_suffix='{ts}_{bs}_{lr}'``): ``{split}_predictions_{suffix}.csv``
    in the 2-column schema and ``{split}_predictions_plot_{suffix}.png``
    (train_model.py:64-93)."""
    with_metrics = train_suffix is None
    rows, loss = evaluate(
        forward, store, device, batch_size,
        desc=f"{dataset_name.capitalize()} Set Evaluation",
        with_metrics=with_metrics,
    )
    print(f"Final {dataset_name.capitalize()} Loss: {loss:.6f}")
    suffix = ts if with_metrics else train_suffix
    fieldnames = artifacts.EVAL_FIELDNAMES if with_metrics else artifacts.TRAIN_FIELDNAMES
    artifacts.write_predictions_csv(
        os.path.join(output_dir, f"{dataset_name}_predictions_{suffix}.csv"),
        rows, fieldnames,
    )
    if rows:
        if with_metrics:
            artifacts.plot_metric_scatters(output_dir, rows, dataset_name, ts)
        else:
            artifacts.plot_predictions_scatter(
                output_dir, rows, dataset_name,
                f"{dataset_name}_predictions_plot_{suffix}.png",
            )
    return loss
