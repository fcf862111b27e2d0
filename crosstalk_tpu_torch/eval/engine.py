"""Evaluation engine (port of crosstalk_tpu/eval/engine.py).

Per batch, on the model's device: normalize -> forward -> squared error and
the five classical metrics; the host only formats CSV rows. Every sample is
evaluated through pad-and-mask: the last batch is padded with index-0 rows,
whose metric values are zeroed so they are visibly not samples, and the
loss divides by the number of real samples.

Data parallel (crosstalk_tpu/eval/engine.py:108-156): with a process group
each rank evaluates its row slice of every padded batch and the outputs,
masks, labels and ids are all-gathered, so every rank builds the same rows
(rank 0 writes them). With a replica set the forward is
``parallel.replicated_forward`` and ``replicas`` says how many blocks it
splits a batch into. Either way the batch is rounded to a multiple of the
device count.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
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
from crosstalk_tpu_torch.parallel.distributed import (
    allgather_to_host,
    is_primary,
    process_row_slice,
    world_size,
)
from crosstalk_tpu_torch.utils.profiling import check_finite, span

_METRICS = artifacts.EVAL_FIELDNAMES[3:]
_passes = itertools.count()  # the ``pass`` attribute of evaluate's spans


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
    check_finite("the eval step's outputs", out)  # --debug_nans
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
    process_group: Optional[dist.ProcessGroup] = None,
    replicas: int = 1,
) -> Tuple[List[Dict], float]:
    """-> (per-sample rows in dataset order, mean MSE loss).

    ``forward(batch_nhwc) -> (B, 1)`` runs on ``device``: ``model_forward``
    or ``eval.fast_forward.make_fast_forward``. Rows use the 8-column eval
    schema (test-cross-talk-model.py:39-41) when ``with_metrics``, else the
    2-column train-side schema (train_model.py:68), with float32 values as
    the reference's CSVs print them. ``store`` may be a ``DeviceDataset``
    (batches gathered on the device; one device only).

    ``process_group``: this process is one rank of it and evaluates its
    rows of each batch; every rank returns the same rows and loss.
    ``replicas``: the number of row blocks ``forward`` splits a batch into
    (``parallel.replicated_forward``). The batch is rounded to a multiple
    of ranks x replicas.

    Spans (``utils/profiling.span``, recorded while a profiler session
    runs): one ``crosstalk.engine.pass`` (attribute ``pass``) and, per
    batch, its children on this thread, which inherit ``pass``: the
    pipeline's ``wait`` for the next assembled batch,
    ``crosstalk.engine.launch`` (the host enqueuing normalize, forward and
    metrics; not twinned, it launches kernels) and ``crosstalk.engine.rows``
    (twinned: the loss sum and the row dicts, from after the read-back).
    The pipeline's ``assemble`` and ``stage`` run on its producer thread:
    they are given the pass's ``pass`` and are no children of it. The host's
    wait in the read-back is in the pass span's self time alone."""
    rows: List[Dict] = []
    total_sq_err = 0.0
    total_n = 0
    batch_size = min(batch_size, max(1, len(store)))
    ranks = world_size(process_group) if process_group is not None else 1
    multiple = ranks * replicas
    batch_size = max((batch_size // multiple) * multiple, multiple)
    assemble = process_row_slice(batch_size, process_group) if ranks > 1 else None
    pass_id = next(_passes)
    if isinstance(store, DeviceDataset):
        if ranks > 1:
            raise ValueError("DeviceDataset evaluation is single-device; pass a "
                             "TileStore for rank-sharded evaluation")
        batches = store.batches(batch_size)
    else:
        batches = device_batches(
            iterate_batches(store, batch_size, assemble_rows=assemble), device,
            tags={"pass": pass_id})
    # closed on an error too: that stops and joins the pipeline's producer
    with (span("crosstalk.engine.pass", host_only=False, **{"pass": pass_id}),
          contextlib.closing(batches)):
        for index, batch in enumerate(
                _progress(batches, desc, num_batches(len(store), batch_size))):
            with span("crosstalk.engine.launch", host_only=False, batch=index):
                out = _eval_step(forward, batch.inputs, batch.labels, batch.mask,
                                 with_metrics)
            parts = (out, batch.mask, batch.labels, batch.ids)
            if ranks > 1:  # every rank holds its rows only: gather all, in rank order
                out, mask, labels, ids = allgather_to_host(parts, process_group)
            else:
                out, mask, labels = ({k: v.cpu().numpy() for k, v in out.items()},
                                     batch.mask.cpu().numpy(),
                                     batch.labels.cpu().numpy())
                ids = batch.ids
            with span("crosstalk.engine.rows", host_only=True, batch=index):
                labels = labels[:, 0]
                real = int(mask.sum())
                total_sq_err += float(out["sq_err"].sum())
                total_n += real
                for j in range(real):
                    row = {
                        "Actual_Label": np.float32(labels[j]),
                        "Predicted_Label": np.float32(out["preds"][j]),
                    }
                    if with_metrics:
                        row = {"Image_ID": int(ids[j]), **row,
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
    process_group: Optional[dist.ProcessGroup] = None,
    replicas: int = 1,
) -> float:
    """Evaluate, write the predictions CSV and its plots.

    Eval side (``train_suffix`` None): ``{split}_predictions_{ts}.csv`` in
    the 8-column schema and one scatter per metric
    (test-cross-talk-model.py:92-121). Train side
    (``train_suffix='{ts}_{bs}_{lr}'``): ``{split}_predictions_{suffix}.csv``
    in the 2-column schema and ``{split}_predictions_plot_{suffix}.png``
    (train_model.py:64-93). Under ``process_group`` every rank evaluates
    and rank 0 alone prints and writes."""
    with_metrics = train_suffix is None
    primary = is_primary(process_group)
    rows, loss = evaluate(
        forward, store, device, batch_size,
        desc=f"{dataset_name.capitalize()} Set Evaluation" if primary else None,
        with_metrics=with_metrics, process_group=process_group, replicas=replicas,
    )
    if not primary:
        return loss
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
