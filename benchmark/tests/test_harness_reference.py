"""The plain reference against the program, at a small size on the CPU:
the float32 forward of both models, the train steps with their flips,
dropout masks and Adam, the batch order, and the five metrics."""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.drivers.common import model_config
from benchmark.reference import metrics as ref_metrics
from benchmark.reference import model as ref_model
from benchmark.reference import rules
from benchmark.reference import train as ref_train
from benchmark.tests.conftest import TINY


def _config(variant, **over):
    from benchmark import harness

    cfg = harness.load_json(harness.BENCH_DIR / "configs" / f"{variant}.json")
    return {**cfg, **TINY[variant], "compute_dtype": "f32", **over}


@pytest.mark.parametrize("variant", ["single", "double"])
def test_reference_forward_matches_the_program(variant):
    from crosstalk_tpu_torch.eval.engine import model_forward
    from crosstalk_tpu_torch.models.registry import build_model

    cfg = _config(variant)
    tiles, _ = inputs.make_tiles(7, 24, cfg["image_size"], "cpu")
    w = inputs.make_weights(cfg, 7, "cpu", tiles[:16])
    model = build_model(model_config(cfg), image_size=cfg["image_size"])
    model.load_state_dict(w)
    from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc

    with torch.no_grad():
        got = model_forward(model, "f32")(normalize_batch_nhwc(tiles))[:, 0]
    want = ref_model.predict(cfg, w, tiles)
    assert want.std() > 0.02  # the calibrated statistics spread the predictions
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", ["single", "double"])
def test_reference_train_steps_match_the_program(variant):
    from crosstalk_tpu_torch.config import OptimConfig
    from crosstalk_tpu_torch.data.pipeline import DeviceDataset
    from crosstalk_tpu_torch.models.registry import build_model
    from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step

    from benchmark.drivers.common import tile_store
    from benchmark.drivers.train import OPTIM

    cfg, seed, lr = _config(variant), 2**33 + 5, 1e-3
    tiles, alphas = inputs.make_tiles(seed, 32, cfg["image_size"], "cpu")
    w = inputs.make_weights(cfg, seed, "cpu")
    model = build_model(model_config(cfg), image_size=cfg["image_size"])
    model.load_state_dict(w)
    state = init_train_state(model, OptimConfig(learning_rate=lr))
    step = make_train_step(state, compute_dtype="f32", seed=seed)
    data = DeviceDataset(tile_store(tiles.numpy(), alphas.numpy()), torch.device("cpu"))
    losses, grad = [], None
    for i, b in enumerate(list(data.batches(8, shuffle=True, drop_last=True, seed=seed))[:3]):
        losses.append(float(step(b.inputs, b.labels, lr)))
        if i == 0:
            grad = {k: state.optimizer.state[p]["exp_avg"] / 0.1
                    for k, p in model.named_parameters()}
    batches = [(tiles[idx], alphas[idx])
               for idx in rules.epoch_batches(32, 8, seed, 0)[:3]]
    ref = ref_train.reference_run(cfg, OPTIM, w, batches, seed, lr)
    assert np.allclose(losses, ref["losses"], rtol=1e-5)
    # against the leaf's norm or the median leaf's, as the train cells compare
    floor = np.median(list(ref["grad"].values()))
    for k, v in ref_train.leaf_norms(grad).items():
        assert abs(v - ref["grad"][k]) <= 1e-4 * max(ref["grad"][k], floor), k
    floor = np.median(list(ref["change"].values()))
    for k, p in model.named_parameters():
        change = float((p.detach() - w[k]).double().norm())
        assert abs(change - ref["change"][k]) <= 1e-4 * max(ref["change"][k], floor), k
    buffers = dict(model.named_buffers())
    assert set(ref["stats_change"]) == {k for k in buffers if k.endswith(("_mean", "_var"))}
    floor = np.median(list(ref["stats_change"].values()))
    for k, want in ref["stats_change"].items():
        change = float((buffers[k] - w[k]).double().norm())
        assert abs(change - want) <= 1e-4 * max(want, floor), k
    assert torch.allclose(ref["first_preds"].std(), ref["first_preds"].std() * 0 + 1,
                          rtol=10)  # the first step's predictions are not all one value


def test_the_frozen_draws_are_the_program_s():
    from crosstalk_tpu_torch.data.pipeline import _epoch_index_batches
    from crosstalk_tpu_torch.data.transforms import counter_key, flip_bits

    seed = 2**32 + 77
    for step in (0, 1, 5):
        index = torch.arange(64)
        assert torch.equal(rules.flips(seed, step, 64, "cpu"), flip_bits(seed, step, index))
        assert rules.counter_key(seed, step, 2, 0) == counter_key(seed, step, 2, 0)
    for epoch in (0, 3):
        want = [idx for idx, _ in _epoch_index_batches(40, 8, True, True, seed, epoch)]
        got = rules.epoch_batches(40, 8, seed, epoch)
        assert all(np.array_equal(a, b) for a, b in zip(got, want)) and len(got) == len(want)


def test_reference_metrics_match_the_program():
    from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
    from crosstalk_tpu_torch.ops.metrics import classical_metrics

    tiles, _ = inputs.make_tiles(3, 6, 64, "cpu")
    got = classical_metrics(normalize_batch_nhwc(tiles))
    for i in range(6):
        want = ref_metrics.tile_metrics(tiles[i, :, :, 0].numpy(), tiles[i, :, :, 1].numpy())
        for name in ref_metrics.NAMES:
            assert abs(float(got[name][i]) - want[name]) <= 2e-4, (name, i)


def test_control_precisions_round():
    x = torch.linspace(-3, 3, 1001)
    assert torch.equal(ref_model._op(x, "f32"), x)
    bf = ref_model._op(x, "bf16")
    fp8 = ref_model._op(x, "fp8")
    assert 0 < (bf - x).abs().max() < (fp8 - x).abs().max() < 0.2
