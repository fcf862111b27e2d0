"""Where a training step's time goes on the card.

    python -m crosstalk_tpu_torch.tools.profile_train [--batch 256] [--steps 3] [--top 12]

For each model (full-width single- and two-branch, random weights from a
seed, bf16 autocast as the train CLI runs it) it takes two warmup steps on
device-resident random tiles, then prints, from ``torch.profiler`` over
``--steps`` steps: the CUDA kernels by total device time, the share of the
kernel time in convolutions, BatchNorm, elementwise/pool work and the
optimizer, and the device's busy share (kernel time / host wall time).

Needs a CUDA card; imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from crosstalk_tpu_torch.tools.profile_eval import _kernel_times, _print_top

# kernel-name fragments -> the part of the step they belong to
_GROUPS = (
    ("optimizer", ("adam", "multi_tensor", "foreach")),
    ("batchnorm", ("batch_norm", "batchnorm", "bn_", "welford")),
    ("conv/gemm", ("conv", "gemm", "sm90", "cutlass", "xmma", "wgrad", "dgrad",
                   "fprop", "implicit", "cudnn")),
    ("pool", ("max_pool", "maxpool")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise/other"


def profile_steps(variant: str, batch: int, steps: int, top: int) -> None:
    from torch.profiler import ProfilerActivity, profile

    from crosstalk_tpu_torch.config import ModelConfig, OptimConfig
    from crosstalk_tpu_torch.models.registry import build_model, init_model
    from crosstalk_tpu_torch.train.steps import init_train_state, make_train_step

    model = init_model(build_model(ModelConfig(variant=variant)),
                       torch.Generator().manual_seed(0))
    state = init_train_state(model.cuda(), OptimConfig())
    step = make_train_step(state, compute_dtype="bf16", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tiles = torch.rand(batch, 256, 256, 2, device="cuda", generator=gen)
    labels = torch.rand(batch, 1, device="cuda", generator=gen) * 0.5
    for _ in range(2):
        step(tiles, labels, 1e-4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(tiles, labels, 1e-4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _kernel_times(prof)
    total = _print_top(f"{variant} bf16 train step x{steps}, batch {batch}", rows, top)
    groups: dict = {}
    for name, us, _ in rows:
        groups[_group(name)] = groups.get(_group(name), 0.0) + us
    print(f"{variant}: per step {total / steps / 1e3:.2f} ms of kernels, wall "
          f"{wall / steps * 1e3:.2f} ms, device busy {100 * total / 1e6 / wall:.1f}%; "
          + ", ".join(f"{g} {100 * us / total:.1f}%" for g, us in
                      sorted(groups.items(), key=lambda kv: -kv[1])))
    del state, step, model
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args(argv)

    from crosstalk_tpu_torch.device import resolve_device, set_parity_numerics

    resolve_device("cuda")
    set_parity_numerics()  # as the train CLI runs
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}, torch {torch.__version__}")
    for variant in ("single", "double"):
        profile_steps(variant, args.batch, args.steps, args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
