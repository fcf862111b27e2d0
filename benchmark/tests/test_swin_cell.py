"""The cell ``swinv2-b.train-b128`` on the CPU at a tiny size: a sound run
is correct, each planted fault and the fp8 control are not, a traced run
reports the cell's per-layer metrics, and the FLOP count is the published
one."""

import json
import time

import pytest

from benchmark import flops_swinv2, harness

CELL = "swinv2-b.train-b128"
TINY = dict(image_size=64, embed_dim=16, depths=[2, 2, 2, 2], num_heads=[1, 2, 2, 4],
            window_size=4, compute_dtype="f32")


def tiny_run(variant="program", trace=False):
    import torch

    cell = harness.load_cell(CELL)
    cell.config = {**cell.config, **TINY}
    cell.params = {**cell.params, "tiles": 32, "batch_size": 8}
    return harness.Run(cell, 2**31 + 4321, 0.5, trace, torch.device("cpu"),
                       time.monotonic(), variant=variant)


def test_a_sound_run_is_correct():
    run = harness.execute(tiny_run())
    line = harness.result_line(run)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"train_tiles_per_s", "setup_s"}
    assert run.readings["leaves_left_out"] == []
    assert len(run.readings["mean_residual_grad_gap"]) == 2
    json.loads(json.dumps(line))


@pytest.mark.parametrize("variant", ["unchanged", "half_batch"])
def test_a_broken_timed_path_is_not_correct(variant):
    run = harness.execute(tiny_run(variant))
    assert run.correct is False, run.checks


def test_a_traced_run_reports_the_cell_s_per_layer_metrics():
    run = tiny_run(trace=True)
    line = harness.result_line(harness.execute(run))
    # the attention's range is device activity: a CPU trace has none
    assert set(line["metrics"]) == {"mfu.train", "device_idle.train",
                                    "host_forward.swin_train"}
    assert {m["name"] for m in run.cell.per_layer} >= set(line["metrics"]) | {
        "window_attn.swin_train"}


def test_the_published_forward_flops():
    cfg = harness.load_cell(CELL).config
    # 20.3 GMACs a tile at 2 input channels (timm lists 20.4 at 3)
    assert 40.4e9 < flops_swinv2.forward_flops_per_tile(cfg) < 40.6e9
    assert flops_swinv2.train_flops_per_tile(cfg) == 3 * flops_swinv2.forward_flops_per_tile(cfg)
