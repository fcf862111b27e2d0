"""Offline scoring, as the eval CLI runs it with ``--fast``: the engine's
``evaluate`` (host batch assembly, pinned copies, normalize, the folded-BN
bf16 forward with block 0 in kernel K1, the five metrics, a read-back per
batch) over a ``TileStore``, pass after pass.

Parameters (``traffic/<name>.json``): ``tiles`` in the store,
``batch_size``, ``calibration_tiles`` (the tiles whose batch statistics
become the BatchNorm running statistics), ``metric_sample`` (tiles whose
metrics the reference recomputes).

Correctness: every prediction of every pass in the window against the
reference's float32 forward of that tile (``pred_gap``, the largest
absolute difference, and ``pred_mean_gap``, the mean one, which a shift of
every prediction moves), and the five metrics of a sample of tiles drawn from
the seed in every pass against the reference's float64 metrics
(``metrics_gap``, the largest absolute difference).

Variants: ``control`` serves the program's own int8 tier (as ``predict
--int8`` runs it) for the predictions and the reference's metrics on
bfloat16-rounded planes for the metrics; ``altered`` adds 1.0 to one
prediction of each batch where the forward produces it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import flops, inputs
from benchmark.drivers.common import gap, model_config, tile_store
from benchmark.harness import Run
from benchmark.reference import metrics as ref_metrics
from benchmark.reference import model as ref_model


def _forward(run: Run, mcfg, weights, store):
    from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
    from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward
    from crosstalk_tpu_torch.eval.int8_forward import calibrate_int8, make_int8_forward
    from crosstalk_tpu_torch.parallel.mesh import replicated_forward

    def replica(d):
        sd = {k: v.to(d) for k, v in weights.items()}
        if run.variant != "control":
            return make_fast_forward(mcfg, sd)
        calib = normalize_batch_nhwc(torch.from_numpy(store.tiles[:256]).to(d))
        return make_int8_forward(mcfg, sd, calibrate_int8(mcfg, sd, calib))

    forward = replicated_forward(replica, [run.device])
    if run.variant != "altered":
        return forward

    def altered(x):
        out = forward(x)
        return torch.cat([out[:1] + 1.0, out[1:]])

    return altered


def run(r: Run) -> None:
    from crosstalk_tpu_torch.device import set_parity_numerics
    from crosstalk_tpu_torch.eval.engine import evaluate
    from crosstalk_tpu_torch.ops.input_block import fused_input_block

    p, cfg, dev = r.params, r.config, r.device
    n, bs = p["tiles"], p["batch_size"]
    set_parity_numerics()
    tiles, alphas = inputs.make_tiles(r.seed, n, cfg["image_size"], dev)
    weights = inputs.make_weights(cfg, r.seed, dev, tiles[:p["calibration_tiles"]],
                                 p["bn_shift"])
    store = tile_store(tiles.cpu().numpy(), alphas.cpu().numpy())
    del tiles, alphas
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    mcfg = model_config(cfg)
    forward = _forward(r, mcfg, weights, store)
    evaluate(forward, store, dev, batch_size=bs)  # warm-up: the window's shapes

    pick = np.random.default_rng(inputs.sub_seed(r.seed, "metric sample")).choice(
        n, size=min(p["metric_sample"], n), replace=False)
    launches = fused_input_block.launches
    passes, ends = [], []
    with r.window() as w:
        while True:
            passes.append(_answers(evaluate(forward, store, dev, batch_size=bs)[0], n, pick))
            ends.append(w.elapsed())
            if w.elapsed() >= r.seconds:
                break
    r.readings["pass_s"] = list(np.diff([0.0] + ends))
    r.read_memory_peak()
    scored = len(passes) * n
    r.e2e["score_tiles_per_s"] = scored / r.window_s
    r.work.update(tiles=scored, model_flops=scored * flops.forward_flops_per_tile(cfg),
                  k1_launches=fused_input_block.launches - launches, k1_rows=bs)
    del forward
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _compare(r, weights, store, passes, pick)


def _answers(rows, n: int, pick) -> tuple:
    """A pass's rows -> (the prediction of every tile, NaN where none came;
    the metrics of the sampled tiles), kept as arrays: a window's worth of
    row dicts would give the collector millions of objects to walk."""
    preds = np.full(n, np.nan)
    for row in rows:
        preds[row["Image_ID"]] = row["Predicted_Label"]
    by_id = {row["Image_ID"]: row for row in rows}
    sample = np.array([[float(by_id[i][k]) if i in by_id else np.nan
                        for k in ref_metrics.NAMES] for i in pick])
    return preds, sample


def _compare(r: Run, weights, store, passes, pick) -> None:
    cfg, n = r.config, len(store)
    ref_model.plain_numerics()
    raw = torch.from_numpy(store.tiles)
    want = torch.cat([ref_model.predict(cfg, weights, raw[i:i + 256].to(r.device))
                      for i in range(0, n, 256)]).cpu().numpy().astype(np.float64)
    got = np.stack([preds for preds, _ in passes])
    r.attempted = got.size
    r.failed = int((~np.isfinite(got)).sum())
    r.check("pred_gap", float(np.nanmax(np.abs(got - want))))
    r.check("pred_mean_gap", float(np.nanmean(np.abs(got - want))))
    r.readings["pred_spread"] = float(want.std())

    worst = 0.0
    for j, i in enumerate(pick):
        mixed, source = store.tiles[i, :, :, 0], store.tiles[i, :, :, 1]
        want_m = ref_metrics.tile_metrics(mixed, source)
        if r.variant == "control":
            rounded = [torch.from_numpy(ref_metrics.normalize(c)).to(torch.bfloat16)
                       .double().numpy() for c in (mixed, source)]
            m = ref_metrics.tile_metrics(*rounded)
            got_m = [[m[k] for k in ref_metrics.NAMES]]
        else:
            got_m = [sample[j] for _, sample in passes]
        for values in got_m:
            for name, v in zip(ref_metrics.NAMES, values):
                worst = max(worst, gap(float(v), want_m[name], 1.0))
    r.check("metrics_gap", worst)
