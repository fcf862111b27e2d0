"""Training, as the train CLI runs it with its resident data
(``DeviceDataset``): the production step ``train.steps.make_train_step``
(on-device normalize and paired flips, bf16 autocast, MSE, backward, Adam
with coupled L2) on shuffled batches, epoch after epoch, the losses read
once per epoch as the training loop reads them.

Parameters: ``tiles`` in the data set, ``batch_size``, ``lr``,
``checked_steps``.

Correctness: set-up builds the one train state that the window goes on
to use and takes its first ``checked_steps`` steps through the window's
own step and feed (the first batches of epoch 0, rows that all differ).
The reference follows them in float32 from the same weights, batches,
flips and dropout masks. Past the window's middle one step is taken with
the whole state (parameters, running statistics, Adam's moments, the step
count) copied before and after it; once the window has closed the
reference takes that step from the copy before. Compared, each the worst
over the first step (or the checked steps) and the window's step:

* ``pred_gap`` and ``pred_mean_gap``: the largest and the mean
  |prediction - reference| over the step's rows, the predictions as the
  step's own forward made them (read by a forward hook);
* ``grad_gap``: the worst leaf's |norm - reference norm| of the gradient
  as Adam took it (read back from its first moment), over the larger of
  the reference leaf's norm and the median leaf's;
* ``change_gap``: the same for the parameters' change, and for the
  running statistics' change, over the checked steps and over the
  window's step.

The gradient and the parameters' change leave out the leaves whose
reference gradient (without L2) is under a thousandth of the median
leaf's: the biases that a BatchNorm follows, whose gradient is zero but
for round-off, so that they move under Adam by round-off alone. Each
step's loss gap is read (``readings``) and not compared: no control or
fault sets it an upper reading (PERF.md).

Variants: ``control`` puts the reference, in fp8, in the program's place;
``unchanged`` is a step that returns its state unchanged; ``half_batch``
leaves out half of each batch and takes the mean over the rest;
``late_change`` doubles the learning rate from the first step after the
checked ones on, a step that changes once set-up is past.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import flops, inputs
from benchmark.drivers.common import model_config, tile_store
from benchmark.harness import Run
from benchmark.reference import model as ref_model
from benchmark.reference import rules
from benchmark.reference import train as ref_train

OPTIM = {"weight_decay": 1e-4, "adam_b1": 0.9, "adam_b2": 0.999, "adam_eps": 1e-8}


def _mask_dtype(cfg: dict):
    return torch.bfloat16 if cfg["compute_dtype"] == "bf16" else torch.float32


class _Program:
    """The program's train state and step, and what the checks read of it."""

    def __init__(self, r: Run, weights):
        from crosstalk_tpu_torch.config import OptimConfig
        from crosstalk_tpu_torch.models.registry import build_model
        from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step

        cfg = r.config
        model = build_model(model_config(cfg), image_size=cfg["image_size"], device=r.device)
        model.load_state_dict(weights)
        self.state = init_train_state(model, OptimConfig())
        self.step = make_train_step(self.state, compute_dtype=cfg["compute_dtype"],
                                    seed=r.seed)
        self.stat_keys = ref_model.running_stats(cfg)

    @property
    def t(self) -> int:
        return self.state.step

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.state.model.named_parameters())

    def stats(self) -> Dict[str, torch.Tensor]:
        buffers = dict(self.state.model.named_buffers())
        return {k: buffers[k] for k in self.stat_keys}

    def moment(self, name: str) -> Dict[str, torch.Tensor]:
        """Adam's ``exp_avg`` or ``exp_avg_sq`` (zero before its first step)."""
        opt = self.state.optimizer
        return {k: (opt.state[p][name] if p in opt.state else torch.zeros_like(p))
                for k, p in self.params().items()}

    @contextlib.contextmanager
    def watch(self):
        """-> a list that receives the predictions of each forward of the
        steps taken inside the block, as the step's own forward made them."""
        seen: List[torch.Tensor] = []
        hook = self.state.model.register_forward_hook(
            lambda module, args, out: seen.append(out.detach().float().reshape(-1).clone()))
        try:
            yield seen
        finally:
            hook.remove()


class _Control:
    """The reference in fp8, with the program's call."""

    def __init__(self, r: Run, weights):
        self.ref = ref_train.ReferenceTraining(r.config, OPTIM, weights, "fp8",
                                               _mask_dtype(r.config))
        self.seed = r.seed
        self.seen: Optional[List[torch.Tensor]] = None

    @property
    def t(self) -> int:
        return self.ref.t

    def step(self, inputs, labels, lr):
        loss = torch.tensor(self.ref.step(inputs, labels[:, 0], self.seed, lr))
        if self.seen is not None:
            self.seen.append(self.ref.last_preds.float().clone())
        return loss

    def params(self):
        return {k: self.ref.w[k] for k in self.ref.keys}

    def stats(self):
        return {k: self.ref.w[k] for k in self.ref.stat_keys}

    def moment(self, name: str):
        return self.ref.m if name == "exp_avg" else self.ref.v

    @contextlib.contextmanager
    def watch(self):
        self.seen = []
        try:
            yield self.seen
        finally:
            self.seen = None


def _state(prog, second_moment: bool = True) -> dict:
    """The train state's tensors: parameters, running statistics and Adam's
    moments."""
    out = {"params": prog.params(), "stats": prog.stats(), "m": prog.moment("exp_avg")}
    if second_moment:
        out["v"] = prog.moment("exp_avg_sq")
    return out


def _copy_buffers(prog, second_moment: bool = True) -> dict:
    """Room for a copy of the train state, taken in set-up so that the
    window allocates nothing."""
    return {g: {k: torch.empty_like(v) for k, v in d.items()}
            for g, d in _state(prog, second_moment).items()}


def _copy_state(prog, into: dict) -> dict:
    for g, d in _state(prog, "v" in into).items():
        for k, v in d.items():
            into[g][k].copy_(v.detach())
    return {**into, "t": prog.t}


def _checked_window_step(prog, b, lr, fed: int, room) -> dict:
    """One step of the window with the state copied around it, for the
    reference to replay once the window has closed."""
    before = _copy_state(prog, room[0])
    with prog.watch() as seen:
        loss = prog.step(b.inputs, b.labels, lr)
    return {"before": before, "after": _copy_state(prog, room[1]),
            "loss": loss, "preds": seen, "batch": fed}


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
    elif r.variant == "late_change":
        def late(inputs, labels, lr):
            late_lr = 2 * lr if prog.t >= r.params["checked_steps"] else lr
            return step(inputs, labels, late_lr)
        prog.step = late
    return prog


def _batches(data, bs: int, seed: int):
    for epoch in itertools.count():
        yield from data.batches(bs, shuffle=True, drop_last=True, seed=seed, epoch=epoch)
        yield None  # the epoch's end: the loop reads its losses here


def run(r: Run) -> None:
    from crosstalk_tpu_torch.data.pipeline import DeviceDataset
    from crosstalk_tpu_torch.device import set_parity_numerics

    p, cfg, dev = r.params, r.config, r.device
    n, bs, lr, checked = p["tiles"], p["batch_size"], p["lr"], p["checked_steps"]
    set_parity_numerics()
    tiles, alphas = inputs.make_tiles(r.seed, n, cfg["image_size"], dev)
    weights = inputs.make_weights(cfg, r.seed, dev, bn_shift=p["bn_shift"])
    store = tile_store(tiles.cpu().numpy(), alphas.cpu().numpy())
    del tiles, alphas
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    prog = _timed_step(r, weights)
    data = DeviceDataset(store, dev)
    feed = _batches(data, bs, r.seed)

    # the checked steps, through the window's step and feed
    losses, first = [], {}
    for i in range(checked):
        b = next(feed)
        with prog.watch() as seen:
            losses.append(float(prog.step(b.inputs, b.labels, lr)))
        if i == 0:
            first_preds = seen[0] if seen else None
            first = {k: v.detach().cpu() for k, v in _first_gradient(prog).items()}
    change = ref_train.leaf_norms({k: v - weights[k] for k, v in prog.params().items()})
    stats_change = ref_train.leaf_norms({k: v - weights[k] for k, v in prog.stats().items()})
    fed = checked
    warm = []  # the rest of epoch 0 and its loss read: every path the window takes
    for b in iter(lambda: next(feed), None):
        warm.append(prog.step(b.inputs, b.labels, lr))
        fed += 1
    if warm:
        torch.stack(warm).isfinite().all().item()
    room = (_copy_buffers(prog), _copy_buffers(prog, second_moment=False))

    # one step past the window's middle is copied around for the reference
    steps, pending, failed, replay = 0, [], 0, None
    with r.window() as w:
        while replay is None or w.elapsed() < r.seconds:
            b = next(feed)
            if b is None:
                failed += int((~torch.isfinite(torch.stack(pending))).sum())
                pending = []
                continue
            if replay is None and w.elapsed() >= r.seconds / 2:
                replay = _checked_window_step(prog, b, lr, fed, room)
                pending.append(replay["loss"])
            else:
                pending.append(prog.step(b.inputs, b.labels, lr))
            fed += 1
            steps += 1
    if pending:
        failed += int((~torch.isfinite(torch.stack(pending))).sum())
    r.read_memory_peak()
    r.attempted, r.failed = steps, failed
    tiles = steps * bs
    r.e2e["train_tiles_per_s"] = tiles / r.window_s
    r.work.update(tiles=tiles, model_flops=tiles * flops.train_flops_per_tile(cfg))
    del prog, data, feed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _compare(r, weights, store, losses, first_preds, first, change, stats_change, replay)


def _first_gradient(prog) -> Dict[str, torch.Tensor]:
    """After one step: the gradient Adam took, read back from its first moment."""
    return {k: m / (1 - OPTIM["adam_b1"]) for k, m in prog.moment("exp_avg").items()}


def _relative_worst(got: Dict[str, float], want: Dict[str, float], keys):
    """-> (the worst leaf's gap, that leaf)."""
    floor = float(np.median(list(want.values())))
    return max((abs(got[k] - want[k]) / max(want[k], floor, 1e-30), k) for k in keys)


def _pred_gaps(got: Optional[torch.Tensor], want: torch.Tensor):
    """-> (largest, mean) |prediction - reference| over a step's rows;
    infinite where the step's forward made no row or another number."""
    if got is None or got.shape != want.shape:
        return math.inf, math.inf
    d = (got.to(want.device).double() - want.double()).abs()
    return float(d.max()), float(d.mean())


def _moved(raw_grad: Dict[str, float]):
    """The leaves whose reference gradient (without L2) is at least a
    thousandth of the median leaf's."""
    floor = 1e-3 * float(np.median(list(raw_grad.values())))
    return [k for k, v in raw_grad.items() if v >= floor]


def _batch(r: Run, store, fed: int):
    """The rows of the ``fed``-th batch of the feed, by the frozen rule."""
    n, bs = len(store), r.params["batch_size"]
    epoch, j = divmod(fed, n // bs)
    idx = rules.epoch_batches(n, bs, r.seed, epoch)[j]
    return (torch.from_numpy(store.tiles[idx]).to(r.device),
            torch.from_numpy(store.labels[idx, 0]).to(r.device))


def _compare(r: Run, weights, store, losses, first_preds, first, change, stats_change,
             replay) -> None:
    cfg, p = r.config, r.params
    ref_model.plain_numerics()
    batches = [_batch(r, store, i) for i in range(p["checked_steps"])]
    ref = ref_train.reference_run(cfg, OPTIM, weights, batches, r.seed, p["lr"],
                                  mask_dtype=_mask_dtype(cfg))
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    r.readings.update(losses=losses, ref_losses=ref["losses"], loss_gap=max(gaps),
                      first_loss_gap=gaps[0])
    flips, diffs = {}, {}
    for k, want in ref["first_gradient"].items():
        got = first[k].to(want.device)
        flips[k] = float(((got < 0) != (want < 0)).float().mean())
        diffs[k] = float((got - want).double().norm() / want.double().norm().clamp_min(1e-30))
    grad = ref_train.leaf_norms(first)
    r.readings["leaves"] = {k: [grad[k], ref["grad"][k], change[k], ref["change"][k],
                                ref["raw_grad"][k], flips[k], diffs[k]] for k in ref["grad"]}
    moved = _moved(ref["raw_grad"])
    r.readings["leaves_left_out"] = sorted(set(ref["raw_grad"]) - set(moved))
    r.readings["grad_gap_all_leaves"] = _relative_worst(grad, ref["grad"], ref["grad"])
    found = {
        "pred": [_pred_gaps(first_preds, ref["first_preds"])],
        "grad": [_relative_worst(grad, ref["grad"], moved)],
        "change": [_relative_worst(change, ref["change"], moved),
                   _relative_worst(stats_change, ref["stats_change"], ref["stats_change"])],
    }
    del ref
    _replay(r, weights, store, replay, found)
    r.readings["found"] = found
    r.check("pred_gap", max(g for g, _ in found["pred"]))
    r.check("pred_mean_gap", max(g for _, g in found["pred"]))
    r.check("grad_gap", max(g for g, _ in found["grad"]))
    r.check("change_gap", max(g for g, _ in found["change"]))


def _replay(r: Run, weights, store, replay, found) -> None:
    """The reference takes the window's copied step from the program's own
    state before it; its predictions, gradient (read back from the first
    moment), parameters' and running statistics' change join ``found``."""
    before, after = replay["before"], replay["after"]
    b1 = OPTIM["adam_b1"]
    start = {**weights, **before["params"], **before["stats"]}
    ref = ref_train.ReferenceTraining(r.config, OPTIM, start, "f32", _mask_dtype(r.config),
                                      t=before["t"], m=before["m"], v=before["v"])
    raw, labels = _batch(r, store, replay["batch"])
    loss = ref.step(raw, labels, r.seed, r.params["lr"])
    r.readings["window_step"] = {"step": before["t"], "loss": float(replay["loss"]),
                                 "ref_loss": loss}
    preds = replay["preds"][0] if replay["preds"] else None
    found["pred"].append(_pred_gaps(preds, ref.last_preds))

    def norms(state, keys, base):
        return ref_train.leaf_norms({k: state[k] - base[k] for k in keys})

    g_got = ref_train.leaf_norms({k: (after["m"][k] - b1 * before["m"][k]) / (1 - b1)
                                  for k in ref.keys})
    g_want = ref_train.leaf_norms({k: (ref.m[k] - b1 * before["m"][k]) / (1 - b1)
                                   for k in ref.keys})
    moved = _moved(ref_train.leaf_norms(ref.last_grad))
    found["grad"].append(_relative_worst(g_got, g_want, moved))
    found["change"].append(_relative_worst(norms(after["params"], ref.keys, before["params"]),
                                           norms(ref.w, ref.keys, before["params"]), moved))
    found["change"].append(_relative_worst(
        norms(after["stats"], ref.stat_keys, before["stats"]),
        norms(ref.w, ref.stat_keys, before["stats"]), ref.stat_keys))
