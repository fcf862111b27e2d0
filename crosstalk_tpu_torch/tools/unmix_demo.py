"""Visual unmix demo: before/after crosstalk correction with a trained
model (port of tools/unmix_demo.py).

The reference's thesis is that a trained regression recovers the bleed
coefficient well enough to *subtract* the crosstalk; its repo shows scatter
plots but never the corrected image. This tool turns the claim into a
number and, where matplotlib is installed, a picture:

  1. generate K synthetic demo pairs with a known mixing model
     (``mixed = clean + alpha * source``, data/synthetic.py) — the true
     clean channel is recoverable exactly as ``mixed - alpha_true*source``;
  2. score them end to end through the port's predict CLI with ``--fast
     --unmix`` (the same code path a user runs on unlabeled acquisitions;
     on the card block 0 runs in the fused input-block kernel K1);
  3. report the fraction of bleed energy removed,
     ``1 - MSE(corrected, clean) / MSE(mixed, clean)``, and render a montage
     (source | mixed | corrected | true clean, plus the injected bleed
     ``mixed - clean`` and the residual ``corrected - clean`` on a shared
     scale). Without matplotlib the montage is skipped with a notice.

Panels show a zoomed crop (``--crop``, default 96px) of the full scored
tile; metrics are computed on the full tiles. Demo pairs are drawn from the
training distribution on purpose.

Usage:
    python -m crosstalk_tpu_torch.tools.unmix_demo -p best_model.pth \\
        [-o results/unmix_demo.png] [--device cuda|cpu]

Prints one JSON summary line (pairs, mean |alpha error|, mean bleed-energy
removed %, the PNG path or null).
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys
import tempfile

import numpy as np

from crosstalk_tpu_torch.data.synthetic import generate_pair
from crosstalk_tpu_torch.data.tiff import read_tile, write_tile


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Before/after crosstalk-correction demo."
    )
    parser.add_argument("-p", "--model_path", required=True,
                        help="Trained .pth checkpoint")
    parser.add_argument("-o", "--out", default="results/unmix_demo.png",
                        help="Output PNG path")
    parser.add_argument("--pairs", type=int, default=4,
                        help="Demo pairs to generate and show (rows)")
    parser.add_argument("--size", type=int, default=256,
                        help="Tile size (must match the checkpoint)")
    parser.add_argument("--seed", type=int, default=7,
                        help="Demo-pair RNG seed")
    parser.add_argument("--crop", type=int, default=96,
                        help="Displayed crop size (px); metrics always use "
                             "the full tile. 0 = show the full tile")
    parser.add_argument("--model_options", default="single",
                        choices=["single", "double"])
    parser.add_argument("--initial_filters", type=int, default=None,
                        help="Model width override — must match checkpoint")
    parser.add_argument("--num_conv_blocks", type=int, default=None,
                        help="Single-branch depth override")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="Score on the CUDA card (default) or the CPU")
    return parser


def _montage(args, k, sources, mixeds, cleans, corrected, alphas, preds,
             removed_pct, alpha_err):
    """Write the before/after PNG; -> its path, or None without matplotlib."""
    from crosstalk_tpu_torch.io.artifacts import _pyplot

    plt = _pyplot()
    if plt is None:
        print(f"matplotlib is not installed: skipped {args.out}")
        return None
    c = args.crop if 0 < args.crop < args.size else args.size
    lo = (args.size - c) // 2

    def view(img):
        return img[lo:lo + c, lo:lo + c]

    col_titles = ["Pure source", "Mixed (bleed in)",
                  "Corrected (predicted α)", "True clean",
                  "Bleed  mixed−clean", "Residual  corrected−clean"]
    fig, axes = plt.subplots(k, 6, figsize=(15.5, 2.65 * k))
    axes = np.atleast_2d(axes)
    for i in range(k):
        vmax = max(float(view(a).max())
                   for a in (sources[i], mixeds[i], cleans[i], corrected[i]))
        for j, img in enumerate(
            (sources[i], mixeds[i], corrected[i], cleans[i])
        ):
            ax = axes[i, j]
            ax.imshow(view(img), cmap="gray", vmin=0.0, vmax=vmax,
                      interpolation="nearest")
            ax.set_xticks([])
            ax.set_yticks([])
            if i == 0:
                ax.set_title(col_titles[j], fontsize=10)
        # the two difference panels share one scale so "near-black residual"
        # is a statement, not an artifact of per-panel autoscaling
        bleed = view(np.abs(mixeds[i] - cleans[i]))
        resid = view(np.abs(corrected[i] - cleans[i]))
        dmax = float(bleed.max())
        for j, img in ((4, bleed), (5, resid)):
            ax = axes[i, j]
            ax.imshow(img, cmap="magma", vmin=0.0, vmax=dmax,
                      interpolation="nearest")
            ax.set_xticks([])
            ax.set_yticks([])
            if i == 0:
                ax.set_title(col_titles[j], fontsize=10)
        axes[i, 0].set_ylabel(
            f"α true {alphas[i]:.2f}\npredicted {preds[i]:.4f}",
            fontsize=9,
        )
    crop_note = f"; {c}px crop shown" if c < args.size else ""
    fig.suptitle(
        f"Crosstalk correction: {np.mean(removed_pct):.1f}% of bleed energy "
        f"removed (mean over {k} pairs); "
        f"mean |α error| {np.mean(alpha_err):.4f}{crop_note}",
        fontsize=11,
    )
    fig.tight_layout(rect=(0, 0, 1, 0.97))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    fig.savefig(args.out, dpi=110)
    plt.close(fig)
    return args.out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from crosstalk_tpu_torch.cli.predict import main as predict_main

    k = args.pairs
    if k <= 0:
        print("Error: --pairs must be positive.")
        return 1

    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="unmix_demo.") as tmp:
        mixed_dir = os.path.join(tmp, "Mixed")
        source_dir = os.path.join(tmp, "Source")
        os.makedirs(mixed_dir)
        os.makedirs(source_dir)

        mixeds, sources, cleans, alphas = [], [], [], []
        for i in range(k):
            mixed, source, alpha = generate_pair(rng, args.size)
            # exact inverse of the generator's mixing model
            clean = mixed - alpha * source
            mixeds.append(mixed)
            sources.append(source)
            cleans.append(clean)
            alphas.append(alpha)
            # identical stems in both dirs — the unlabeled pairing schema
            write_tile(os.path.join(mixed_dir, f"demo{i}.tif"), mixed)
            write_tile(os.path.join(source_dir, f"demo{i}.tif"), source)

        predict_argv = [
            "-m", mixed_dir, "-s", source_dir, "-p", args.model_path,
            "--fast", "--unmix", "--output_base", tmp,
            "--model_options", args.model_options, "--device", args.device,
        ]
        if args.initial_filters is not None:
            predict_argv += ["--initial_filters", str(args.initial_filters)]
        if args.num_conv_blocks is not None:
            predict_argv += ["--num_conv_blocks", str(args.num_conv_blocks)]
        rc = predict_main(predict_argv)
        if rc != 0:
            print("Error: predict CLI failed; see output above.")
            return rc

        (run_dir,) = glob.glob(os.path.join(tmp, "predict_run_*"))
        (csv_path,) = glob.glob(os.path.join(run_dir, "predictions_*.csv"))
        with open(csv_path, newline="") as fh:
            pred_by_key = {
                row["Image_Key"]: float(row["Predicted_Alpha"])
                for row in csv.DictReader(fh)
            }
        preds = [pred_by_key[f"demo{i}"] for i in range(k)]
        corrected = [
            read_tile(os.path.join(run_dir, "unmixed", f"demo{i}_unmixed.tif"))
            for i in range(k)
        ]

    removed_pct, alpha_err = [], []
    for i in range(k):
        before = float(np.mean((mixeds[i] - cleans[i]) ** 2))
        after = float(np.mean((corrected[i] - cleans[i]) ** 2))
        removed_pct.append(100.0 * (1.0 - after / before))
        alpha_err.append(abs(preds[i] - alphas[i]))

    png = _montage(args, k, sources, mixeds, cleans, corrected, alphas, preds,
                   removed_pct, alpha_err)
    print(json.dumps({
        "pairs": k,
        "mean_abs_alpha_err": round(float(np.mean(alpha_err)), 6),
        "mean_bleed_removed_pct": round(float(np.mean(removed_pct)), 2),
        "png": png,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
