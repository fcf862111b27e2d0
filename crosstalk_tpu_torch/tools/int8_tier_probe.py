"""End-to-end probe of the opt-in int8 serving tier (port of the root
``tools/int8_tier_probe.py``).

    python -m crosstalk_tpu_torch.tools.int8_tier_probe [--skip_double]
        [--batch 512] [--data_dir DIR] [--device cuda|cpu]
    python -m crosstalk_tpu_torch.tools.int8_tier_probe -p best_model.pth -o single

Per model family: the bf16 ``--fast`` forward's and the int8 forward's
tiles/s (``eval/fast_forward.py``, ``eval/int8_forward.py``) with the
benchmark's serving unit (``tools/bench.infer_unit``: ``SCAN_LEN`` steps of
``normalize_batch_nhwc(x + i * 1e-9)`` and the forward, consumed by the sum
of the predictions, fenced by a synchronize; one warm-up unit, the best of
3; on out-of-memory the batch halves down to 16), the speedup, and the
int8-vs-f32 MAE and the spread of the f32 predictions on up to 100 real
tiles of ``--data_dir`` (``Mixed/`` and ``Source/``; the reference's bundled
``Training_Data`` layout). The int8 scales are calibrated on the first 64
of those tiles, normalized once.

Default weights are random (seed 0) with the BatchNorm running statistics
moved off their init (``burn_batch_stats``): the throughput ratio does not
depend on the weights, but the deviation does, so re-measure it on the
checkpoint you intend to serve: ``-p ckpt.pth -o family`` probes that
checkpoint only. A checkpoint trained at other than 256 px exits 2: the
probe measures the 256 px serving shape only. Prints one line per family
and, last, a JSON object of the numbers.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from crosstalk_tpu_torch.config import ModelConfig
from crosstalk_tpu_torch.data.index import PairIndex
from crosstalk_tpu_torch.data.pipeline import load_tiles
from crosstalk_tpu_torch.data.transforms import normalize_batch_nhwc
from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward
from crosstalk_tpu_torch.eval.int8_forward import calibrate_int8, make_int8_forward
from crosstalk_tpu_torch.io.torch_convert import (
    StateDict,
    count_blocks,
    image_size_compatible,
    infer_image_size,
    load_pth,
    model_config_for_checkpoint,
    structure,
)
from crosstalk_tpu_torch.models.registry import build_model
from crosstalk_tpu_torch.tools.bench import (
    INFER_FLOOR,
    card,
    infer_unit,
    init_weights,
    timed,
    with_halving,
)

SCAN_LEN = 16
REF_DATA = "./Training_Data"
SIZE = 256
CALIBRATION_TILES = 64


def real_tiles(data_dir: str, n: int = 100) -> np.ndarray:
    """The first ``n`` pairs of ``data_dir``'s ``Mixed/`` and ``Source/``
    in the index's order -> (n, H, W, 2) float32, not normalized."""
    idx = PairIndex(f"{data_dir}/Mixed", f"{data_dir}/Source")
    return load_tiles(idx.samples[:n])


def burn_batch_stats(sd: StateDict, variant: str, rng: np.random.Generator) -> StateDict:
    """Every BatchNorm running mean and variance + N(0, 0.01)^2, drawn from
    ``rng`` in the JAX variables tree's leaf order (sorted keys: the head's
    ``DenseBNBlock_*`` before the branches, ``mean`` before ``var``), each
    draw rounded to float32 before it is squared. -> a new state_dict."""
    branches, head = structure(variant)
    named = [(flax + (f"ConvBlock_{i}",), f"{prefix}.{4 * i + 1}")
             for prefix, flax in branches for i in range(count_blocks(sd, prefix))]
    named += [((f"DenseBNBlock_{i}",), f"{head}.{bn}") for i, bn in ((0, 2), (1, 6))]
    out = dict(sd)
    for _, prefix in sorted(named):
        for stat in ("running_mean", "running_var"):
            a = sd[f"{prefix}.{stat}"]
            draw = rng.normal(0, 0.01, tuple(a.shape)).astype(np.float32)
            out[f"{prefix}.{stat}"] = a + torch.from_numpy(draw).to(a.device) ** 2
    return out


def rate(forward, batch: int, device: torch.device):
    """-> (tiles/s of the serving unit of ``forward``, the batch that ran)."""
    def seconds(b: int) -> float:
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.random((b, SIZE, SIZE, 2)).astype(np.float32)).to(device)
        with torch.inference_mode():
            return timed(lambda: infer_unit([forward], [x], SCAN_LEN), [device])

    dt, batch = with_halving(seconds, batch, INFER_FLOOR, [device])
    return SCAN_LEN * batch / dt, batch


@torch.inference_mode()
def deviation(cfg: ModelConfig, sd: StateDict, quant, real: torch.Tensor):
    """-> (int8-vs-f32 MAE, spread of the f32 predictions) on the
    normalized tiles ``real``: ``quant`` against the f32 parity model (the
    plain model, no autocast)."""
    model = build_model(cfg, image_size=real.shape[1], device=real.device)
    model.load_state_dict(sd)
    p_f32 = model(real.permute(0, 3, 1, 2)).float().cpu().numpy()
    p_int8 = quant(real).float().cpu().numpy()
    return float(np.abs(p_int8 - p_f32).mean()), float(np.ptp(p_f32))


def run(argv=None) -> dict:
    """Parse ``argv`` and probe; -> the numbers, or ``{"error": message}``
    for a checkpoint of another tile size."""
    from crosstalk_tpu_torch.device import resolve_device, set_parity_numerics

    p = argparse.ArgumentParser(
        prog="python -m crosstalk_tpu_torch.tools.int8_tier_probe",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--skip_double", action="store_true")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("-p", "--model_path", default=None,
                   help="Probe a TRAINED .pth checkpoint instead of "
                        "random-init weights — the deviation number that "
                        "matters for deploying the tier (throughput is "
                        "weight-independent). Probes only the checkpoint's "
                        "family (-o)")
    p.add_argument("-o", "--model_options", default="single",
                   choices=["single", "double"],
                   help="-p checkpoint's model family")
    p.add_argument("--data_dir", default=REF_DATA,
                   help="directory holding the real tiles' Mixed/ and Source/ "
                        f"(default {REF_DATA})")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="measure on the CUDA card (default) or the CPU")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    set_parity_numerics()  # the f32 model's convs must not run in TF32
    out = {"device": str(device), "card": card(device), "checkpoint": args.model_path,
           "families": {}}
    real = normalize_batch_nhwc(torch.from_numpy(real_tiles(args.data_dir)).to(device))
    out["real_tiles"] = real.shape[0]

    if args.model_path is not None:
        variants = [args.model_options]
    else:
        variants = ["single"] + ([] if args.skip_double else ["double"])
    for variant in variants:
        if args.model_path is not None:
            sd = load_pth(args.model_path)
            if not image_size_compatible(sd, variant, SIZE):
                px = infer_image_size(sd, variant)
                return {**out, "error": f"error: {args.model_path} was trained at {px}px "
                                        "tiles; this probe measures the 256px serving shape "
                                        "only"}
            cfg = model_config_for_checkpoint(variant, sd)
        else:
            cfg = ModelConfig(variant=variant)
            sd = burn_batch_stats(init_weights(cfg, SIZE).state_dict(), variant,
                                  np.random.default_rng(7))
        sd = {k: v.to(device) for k, v in sd.items()}
        out["families"][variant] = probe_family(cfg, sd, real, args.batch)
    return out


def probe_family(cfg: ModelConfig, sd: StateDict, real: torch.Tensor, batch: int) -> dict:
    """One family on the device of ``sd`` and ``real`` (normalized tiles):
    calibrate on ``real[:64]``, both rates at ``batch``, the deviation on
    ``real``."""
    scales = calibrate_int8(cfg, sd, real[:CALIBRATION_TILES])
    fast = make_fast_forward(cfg, sd)
    quant = make_int8_forward(cfg, sd, scales)
    tps_bf16, b1 = rate(fast, batch, real.device)
    tps_int8, b2 = rate(quant, batch, real.device)
    mae, spread = deviation(cfg, sd, quant, real)
    return {"config": repr(cfg), "bf16_tps": tps_bf16, "bf16_batch": b1, "int8_tps": tps_int8,
            "int8_batch": b2, "speedup": tps_int8 / tps_bf16, "mae_vs_f32": mae,
            "f32_spread": spread}


def report(result: dict) -> list:
    """The printed lines of ``result`` (an error goes to stderr, not here)."""
    lines = [f"devices: {result['card'] or result['device']}"]
    for variant, r in result["families"].items():
        if result["checkpoint"] is not None:
            lines.append(f"probing trained checkpoint {result['checkpoint']} ({r['config']})")
        lines.append(
            f"{variant}: bf16 {r['bf16_tps']:7.1f} tiles/s (b{r['bf16_batch']})"
            f" | int8 {r['int8_tps']:7.1f} tiles/s (b{r['int8_batch']})"
            f" | speedup {r['speedup']:.2f}x"
            f" | real-tile MAE vs f32 {r['mae_vs_f32']:.2e} "
            f"(pred spread {r['f32_spread']:.3f})")
    if "error" not in result:
        lines.append(json.dumps(result))
    return lines


def main(argv=None) -> int:
    result = run(argv)
    for line in report(result):
        print(line, flush=True)
    if "error" in result:
        print(result["error"], file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
