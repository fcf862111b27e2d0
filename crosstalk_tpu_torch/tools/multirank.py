"""Multi-rank equivalence checks: N ranks against one, on the same inputs.

Each command runs as ONE rank of a process group; start one process per
rank (same ``--port``), then compare what rank 0 saves with the same
function run in a single process (``run_steps`` / ``run_eval`` with no
group):

    python -m crosstalk_tpu_torch.tools.multirank step --rank R --world 2 \\
        --port P --data batch.npz --out DIR [--device cuda:0 --backend gloo]
    python -m crosstalk_tpu_torch.tools.multirank eval --rank R --world 2 \\
        --port P --checkpoint m.pth -m MIXED -s SOURCE --out DIR [--fast]

Each rank runs on the card (``--device cuda``, the default, raises on a
host without one) unless ``--device cpu`` is given.

``step`` takes train steps on this rank's rows of the global batch in
``--data`` (``inputs`` (B, H, W, 2), ``labels`` (B, 1); float64 arrays
make the model and the step float64) and saves the losses, the first
step's gradients, the parameters and the BatchNorm statistics after the
last step. ``eval`` runs the rank-sharded evaluation engine over the
pairs and saves the gathered rows, the loss, the fused input-block
kernel's launches in this process, and the time of one eval batch's
all-gather. Two ranks may share one card only with ``--backend gloo``
(``--device cuda:0 --backend gloo``): NCCL refuses that, Gloo does not.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def model_config(args):
    from crosstalk_tpu_torch.config import ModelConfig

    kw = {}
    if args.initial_filters is not None:
        kw["initial_filters" if args.variant == "single"
           else "initial_filters_per_branch"] = args.initial_filters
    if args.num_conv_blocks is not None:
        kw["num_conv_blocks"] = args.num_conv_blocks
    if args.dropout is not None:
        kw["dropout_single" if args.variant == "single" else "dropout_double"] = args.dropout
    return ModelConfig(variant=args.variant, compute_dtype=args.compute_dtype, **kw)


def run_steps(cfg, image_size: int, inputs: torch.Tensor, labels: torch.Tensor,
              lr: float, steps: int = 1, weights: Optional[Dict] = None,
              seed: int = 0, augment: bool = False, grad_accum: int = 1,
              group: Optional[dist.ProcessGroup] = None,
              mask: Optional[torch.Tensor] = None,
              dtype: torch.dtype = torch.float32) -> Dict:
    """``steps`` train steps of a fresh model on ``inputs``/``labels`` (this
    rank's rows under ``group``; the model on their device) -> losses, the
    first step's gradients, and the state_dict after the last step, all on
    the CPU; with ``mask``, also the validation step's (squared-error sum,
    count) on the same rows afterwards. ``weights`` is a state_dict; else
    the model is initialized from ``seed``. ``dtype=torch.float64`` (with
    float64 inputs) gives the step a float64 reference."""
    from crosstalk_tpu_torch.config import OptimConfig
    from crosstalk_tpu_torch.models.registry import build_model, init_model
    from crosstalk_tpu_torch.train.steps import (
        init_train_state,
        make_train_step,
        make_val_step,
    )

    multirank = group is not None and dist.get_world_size(group) > 1
    model = build_model(cfg, image_size=image_size,
                        process_group=group if multirank else None)
    if weights is None:
        init_model(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(weights)
    state = init_train_state(model.to(inputs.device, dtype), OptimConfig(learning_rate=lr))
    step = make_train_step(state, compute_dtype=cfg.compute_dtype, seed=seed,
                           augment=augment, grad_accum=grad_accum, process_group=group)
    losses, grads = [], {}
    for i in range(steps):
        losses.append(float(step(inputs, labels, lr)))
        if i == 0:
            grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
    out = {"losses": losses, "grads": grads,
           "state": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}}
    if mask is not None:
        val = make_val_step(model, cfg.compute_dtype, group)(inputs, labels, mask)
        out["val"] = [float(v) for v in val]
    return out


def run_eval(forward, mixed_dir: str, source_dir: str, device, batch_size: int,
             group: Optional[dist.ProcessGroup] = None, cache_dir: Optional[str] = None):
    """The evaluation engine over the pairs (rank-sharded under ``group``)
    -> (rows as arrays, loss)."""
    from crosstalk_tpu_torch.data.index import PairIndex
    from crosstalk_tpu_torch.data.pipeline import TileStore
    from crosstalk_tpu_torch.eval.engine import evaluate

    store = TileStore(PairIndex(mixed_dir, source_dir).samples, jobs=4, cache_dir=cache_dir)
    rows, loss = evaluate(forward, store, device, batch_size, process_group=group)
    return {k: np.array([r[k] for r in rows]) for k in rows[0]}, loss


def gather_seconds(local_rows: int, group, device, reps: int = 10) -> float:
    """Host seconds of one eval batch's all-gather (the engine's: seven
    per-row outputs, mask, labels and ids of ``local_rows`` rows per rank)."""
    from crosstalk_tpu_torch.parallel.distributed import allgather_to_host

    out = {k: torch.zeros(local_rows, device=device) for k in range(7)}
    tree = (out, torch.ones(local_rows, device=device),
            torch.zeros(local_rows, 1, device=device), np.zeros(local_rows, np.int64))
    allgather_to_host(tree, group)
    t0 = time.perf_counter()
    for _ in range(reps):
        allgather_to_host(tree, group)
    return (time.perf_counter() - t0) / reps


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("command", choices=["step", "eval"])
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--out", required=True, help="directory for rank<R>.pt")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card), cuda:<i> or cpu")
    p.add_argument("--backend", default=None,
                   help="default: nccl on cuda, gloo on cpu; gloo lets two ranks share one card")
    p.add_argument("--timeout", type=float, default=60.0, help="rendezvous timeout, s")
    p.add_argument("-o", "--variant", default="single", choices=["single", "double"])
    p.add_argument("--initial_filters", type=int, default=None)
    p.add_argument("--num_conv_blocks", type=int, default=None)
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--compute_dtype", default="f32", choices=["f32", "bf16"])
    # step
    p.add_argument("--data", help="npz with inputs (B, H, W, 2), labels (B, 1) "
                   "and, for a validation step, mask (B,)")
    p.add_argument("--weights", default=None, help=".pth to start from (else --seed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--augment", action="store_true")
    p.add_argument("--grad_accum", type=int, default=1)
    # eval
    p.add_argument("--checkpoint", nargs="+", default=[],
                   help="eval: one .pth per -o variant given with --variants")
    p.add_argument("--variants", nargs="+", default=None)
    p.add_argument("-m", "--mixed_dir")
    p.add_argument("-s", "--source_dir")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--fast", action="store_true")
    p.add_argument("--cache_dir", default=None)
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from crosstalk_tpu_torch.device import resolve_device, set_parity_numerics
    from crosstalk_tpu_torch.parallel.distributed import initialize, process_row_slice

    device = torch.device(args.device)
    resolve_device(device.type)  # raises for a card on a host without one
    if device.type == "cuda":
        torch.cuda.set_device(device)
    set_parity_numerics()
    group = initialize(f"localhost:{args.port}", args.world, args.rank,
                       backend=args.backend, device_type=device.type,
                       timeout_s=args.timeout)
    try:
        if args.command == "step":
            data = np.load(args.data)
            rows = process_row_slice(len(data["inputs"]), group)
            weights = (None if args.weights is None
                       else torch.load(args.weights, map_location="cpu", weights_only=True))
            inputs = torch.from_numpy(data["inputs"][rows]).to(device)
            out = run_steps(model_config(args), data["inputs"].shape[1], inputs,
                            torch.from_numpy(data["labels"][rows]).to(device),
                            args.lr, args.steps, weights, args.seed, args.augment,
                            args.grad_accum, group,
                            torch.from_numpy(data["mask"][rows]).to(device)
                            if "mask" in data else None,
                            dtype=torch.promote_types(inputs.dtype, torch.float32))
        else:
            from crosstalk_tpu_torch.eval.engine import model_forward
            from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward
            from crosstalk_tpu_torch.io.torch_convert import load_pth, model_config_for_checkpoint
            from crosstalk_tpu_torch.models.registry import build_model
            from crosstalk_tpu_torch.ops.input_block import fused_input_block

            out = {}
            for variant, ckpt in zip(args.variants or [args.variant], args.checkpoint):
                sd = load_pth(ckpt)
                cfg = model_config_for_checkpoint(variant, sd, compute_dtype=args.compute_dtype)
                if args.fast:
                    forward = make_fast_forward(cfg, {k: v.to(device) for k, v in sd.items()})
                else:
                    from crosstalk_tpu_torch.data.index import PairIndex
                    from crosstalk_tpu_torch.data.tiff import read_tile

                    px = read_tile(PairIndex(args.mixed_dir, args.source_dir)
                                   .samples[0].mixed_path).shape[0]
                    model = build_model(cfg, image_size=px, device=device)
                    model.load_state_dict(sd)
                    forward = model_forward(model, args.compute_dtype)
                fused_input_block.launches = 0
                table, loss = run_eval(forward, args.mixed_dir, args.source_dir, device,
                                       args.batch_size, group, args.cache_dir)
                out[variant] = {"rows": table, "loss": loss,
                                "launches": fused_input_block.launches}
            out["gather_s"] = gather_seconds(args.batch_size // args.world, group, device)
        os.makedirs(args.out, exist_ok=True)
        torch.save(out, os.path.join(args.out, f"rank{args.rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
