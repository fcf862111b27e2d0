"""Training SwinV2-B as the train CLI runs it with resident data: the train
driver (``drivers/train.py``) with the transformer in the CNN's place.

The same production step (``train.steps.make_train_step``: on-device
normalize and paired flips, bf16 autocast, MSE, Adam with coupled L2) on
the same feed (``DeviceDataset``, reshuffled every epoch, the losses read
once per epoch), the same window with its copied step, and the same checks
(``pred_gap``, ``pred_mean_gap``, ``grad_gap``, ``change_gap``, as
``drivers/train.py`` defines them), against the plain reference
``reference/swinv2.py`` from the same weights, batches, flips and
drop-path masks. The model has no running statistics, so ``change_gap``
reads the parameters' change alone. ``grad_gap`` leaves out, besides the
leaves the train driver leaves out, the two whose gradient is a fixed
vector times the batch's mean residual (``MEAN_RESIDUAL_LEAVES``: the
output bias, and the final LayerNorm's shift, which reaches the output
through the mean over tokens and the head alone). By the checked window
step (~72) that mean is as small as the shift bf16 gives the mean
prediction, so their relative gap reads that shift (1.16 on one seed of
18, PERF.md). Their gap is kept in ``readings``; their change stays in
``change_gap``.
Weights come from the seed (``reference/swinv2.make_weights``).

Parameters: ``tiles``, ``batch_size``, ``lr``, ``checked_steps``.
Variants: ``control`` (the reference in fp8 in the program's place),
``unchanged`` (a step that returns its state unchanged) and
``half_batch`` (half of each batch left out).
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark import flops_swinv2, inputs
from benchmark.drivers import train
from benchmark.drivers.common import tile_store
from benchmark.harness import Run
from benchmark.reference import swinv2 as ref_swin
from benchmark.reference.train import leaf_norms

MEAN_RESIDUAL_LEAVES = ("head.bias", "norm.bias")


def program_config(config: dict):
    """The configuration file -> the program's ``ModelConfig``."""
    from crosstalk_tpu_torch.config import ModelConfig

    return ModelConfig(
        variant=config["variant"], input_channels=config["input_channels"],
        swin_patch=config["patch_size"], swin_embed_dim=config["embed_dim"],
        swin_depths=tuple(config["depths"]), swin_heads=tuple(config["num_heads"]),
        swin_window=config["window_size"], swin_mlp_ratio=config["mlp_ratio"],
        swin_drop_path=config["drop_path_rate"], swin_cpb_hidden=config["cpb_hidden"],
        swin_ln_eps=config["layer_norm_eps"], compute_dtype=config["compute_dtype"])


class _Program(train._Program):
    def __init__(self, r: Run, weights):
        from crosstalk_tpu_torch.config import OptimConfig
        from crosstalk_tpu_torch.models.registry import build_model
        from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step

        cfg = r.config
        model = build_model(program_config(cfg), image_size=cfg["image_size"],
                            device=r.device)
        model.load_state_dict(weights)
        self.state = init_train_state(model, OptimConfig())
        self.step = make_train_step(self.state, compute_dtype=cfg["compute_dtype"],
                                    seed=r.seed)
        self.stat_keys = []


class _Control(train._Control):
    def __init__(self, r: Run, weights):
        self.ref = ref_swin.SwinReferenceTraining(r.config, train.OPTIM, weights, "fp8")
        self.seed = r.seed
        self.seen = None


def _timed_step(r: Run, weights):
    if r.variant == "control":
        return _Control(r, weights)
    prog = _Program(r, weights)
    step = prog.step
    if r.variant == "unchanged":
        def unchanged(inputs, labels, lr):
            with torch.no_grad():
                preds = prog.state.model.train()(inputs.permute(0, 3, 1, 2))
            return torch.mean((preds.float() - labels) ** 2)
        prog.step = unchanged
    elif r.variant == "half_batch":
        def half(inputs, labels, lr):
            h = inputs.shape[0] // 2
            return step(inputs[:h], labels[:h], lr)
        prog.step = half
    return prog


def run(r: Run) -> None:
    from crosstalk_tpu_torch.data.pipeline import DeviceDataset
    from crosstalk_tpu_torch.device import set_parity_numerics

    p, cfg, dev = r.params, r.config, r.device
    n, bs, lr, checked = p["tiles"], p["batch_size"], p["lr"], p["checked_steps"]
    set_parity_numerics()
    tiles, alphas = inputs.make_tiles(r.seed, n, cfg["image_size"], dev)
    weights = ref_swin.make_weights(cfg, r.seed, dev)
    store = tile_store(tiles.cpu().numpy(), alphas.cpu().numpy())
    del tiles, alphas
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    prog = _timed_step(r, weights)
    data = DeviceDataset(store, dev)
    feed = train._batches(data, bs, r.seed)

    # the checked steps, through the window's step and feed
    losses, first_preds, first = [], None, {}
    for i in range(checked):
        b = next(feed)
        with prog.watch() as seen:
            losses.append(float(prog.step(b.inputs, b.labels, lr)))
        if i == 0:
            first_preds = seen[0] if seen else None
            first = {k: v.detach().cpu() for k, v in train._first_gradient(prog).items()}
    change = leaf_norms({k: v - weights[k] for k, v in prog.params().items()})
    fed = checked
    warm = []  # the rest of epoch 0 and its loss read: every path the window takes
    for b in iter(lambda: next(feed), None):
        warm.append(prog.step(b.inputs, b.labels, lr))
        fed += 1
    if warm:
        torch.stack(warm).isfinite().all().item()
    room = (train._copy_buffers(prog), train._copy_buffers(prog, second_moment=False))

    steps, pending, failed, replay = 0, [], 0, None
    with r.window() as w:
        while replay is None or w.elapsed() < r.seconds:
            b = next(feed)
            if b is None:
                failed += int((~torch.isfinite(torch.stack(pending))).sum())
                pending = []
                continue
            if replay is None and w.elapsed() >= r.seconds / 2:
                replay = train._checked_window_step(prog, b, lr, fed, room)
                pending.append(replay["loss"])
            else:
                pending.append(prog.step(b.inputs, b.labels, lr))
            fed += 1
            steps += 1
    if pending:
        failed += int((~torch.isfinite(torch.stack(pending))).sum())
    r.read_memory_peak()
    r.attempted, r.failed = steps, failed
    done = steps * bs
    r.e2e["train_tiles_per_s"] = done / r.window_s
    r.work.update(tiles=done, model_flops=done * flops_swinv2.train_flops_per_tile(cfg))
    del prog, data, feed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _compare(r, weights, store, losses, first_preds, first, change, replay)


def _graded(moved):
    """The leaves ``grad_gap`` reads: ``moved`` but ``MEAN_RESIDUAL_LEAVES``."""
    return [k for k in moved if k not in MEAN_RESIDUAL_LEAVES]


def _compare(r: Run, weights, store, losses, first_preds, first, change, replay) -> None:
    cfg, p = r.config, r.params
    ref_swin.plain_numerics()
    ref = ref_swin.SwinReferenceTraining(cfg, train.OPTIM, weights, "f32")
    ref_losses, ref_first_preds, ref_first, raw_grad = [], None, {}, {}
    for i in range(p["checked_steps"]):
        raw, labels = train._batch(r, store, i)
        ref_losses.append(ref.step(raw, labels, r.seed, p["lr"]))
        if i == 0:
            ref_first_preds = ref.last_preds
            ref_first = {k: v.clone() for k, v in ref.first_moment_as_gradient().items()}
            raw_grad = leaf_norms(ref.last_grad)
    ref_change = leaf_norms({k: ref.w[k] - weights[k] for k in ref.keys})
    del ref
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    r.readings.update(losses=losses, ref_losses=ref_losses, loss_gap=max(gaps),
                      first_loss_gap=gaps[0])
    grad, ref_grad = leaf_norms(first), leaf_norms(ref_first)
    moved = train._moved(raw_grad)
    r.readings["leaves_left_out"] = sorted(set(raw_grad) - set(moved))
    r.readings["grad_gap_all_leaves"] = train._relative_worst(grad, ref_grad, ref_grad)
    r.readings["mean_residual_grad_gap"] = [
        train._relative_worst(grad, ref_grad, MEAN_RESIDUAL_LEAVES)[0]]
    found = {
        "pred": [train._pred_gaps(first_preds, ref_first_preds)],
        "grad": [train._relative_worst(grad, ref_grad, _graded(moved))],
        "change": [train._relative_worst(change, ref_change, moved)],
    }
    _replay(r, weights, store, replay, found)
    r.readings["found"] = found
    r.check("pred_gap", max(g for g, _ in found["pred"]))
    r.check("pred_mean_gap", max(g for _, g in found["pred"]))
    r.check("grad_gap", max(g for g, _ in found["grad"]))
    r.check("change_gap", max(g for g, _ in found["change"]))


def _replay(r: Run, weights, store, replay, found) -> None:
    """The reference takes the window's copied step from the program's own
    state before it (``drivers/train.py``'s ``_replay``, without running
    statistics)."""
    before, after = replay["before"], replay["after"]
    b1 = train.OPTIM["adam_b1"]
    ref = ref_swin.SwinReferenceTraining(r.config, train.OPTIM, before["params"], "f32",
                                         t=before["t"], m=before["m"], v=before["v"])
    raw, labels = train._batch(r, store, replay["batch"])
    loss = ref.step(raw, labels, r.seed, r.params["lr"])
    r.readings["window_step"] = {"step": before["t"], "loss": float(replay["loss"]),
                                 "ref_loss": loss}
    preds = replay["preds"][0] if replay["preds"] else None
    found["pred"].append(train._pred_gaps(preds, ref.last_preds))

    def grads(m: Dict[str, torch.Tensor]):
        return leaf_norms({k: (m[k] - b1 * before["m"][k]) / (1 - b1) for k in ref.keys})

    moved = train._moved(leaf_norms(ref.last_grad))
    got, want = grads(after["m"]), grads(ref.m)
    r.readings["mean_residual_grad_gap"].append(
        train._relative_worst(got, want, MEAN_RESIDUAL_LEAVES)[0])
    found["grad"].append(train._relative_worst(got, want, _graded(moved)))
    found["change"].append(train._relative_worst(
        leaf_norms({k: after["params"][k] - before["params"][k] for k in ref.keys}),
        leaf_norms({k: ref.w[k] - before["params"][k] for k in ref.keys}), moved))
