"""Hyperparameter sweep runner (port of tools/sweep.py): the producer side
of the reference's analysis workflow.

The reference ships a sweep ANALYZER (analyse_training_results.py) but no
sweep RUNNER. This tool runs the batch-size x learning-rate grid through the
port's train CLI, writing one ``training_run_{ts}_B{bs}_LR{lr}/`` per
combination under --output_base, then (with --analyse) consolidates them
into training_analysis_results.csv with ``cli/analyse.py``.

    python -m crosstalk_tpu_torch.tools.sweep -m MIXED -s SOURCE \\
        --batch_sizes 128 256 --learning_rates 1e-4 5e-4 \\
        -n 50 -o single -r aggressive_plateau --analyse [--device cuda|cpu]

Runs are sequential: on one card, parallel training runs would contend.
Each combination reuses the shared decoded-tile cache.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--mixed_channel_data_dir", required=True)
    ap.add_argument("-s", "--pure_source_data_dir", required=True)
    ap.add_argument("--batch_sizes", type=int, nargs="+", default=[256])
    ap.add_argument("--learning_rates", type=float, nargs="+", default=[1e-4])
    ap.add_argument("-n", "--num_epochs", type=int, default=50)
    ap.add_argument("-o", "--model_options", default="single",
                    choices=["single", "double"])
    ap.add_argument("-r", "--learning_scheduler", default="aggressive_plateau",
                    choices=["aggressive_plateau", "onecycle", "cosine_warmup"])
    ap.add_argument("-j", "--cpu_jobs", type=int, default=1)
    ap.add_argument("--compute_dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--initial_filters", type=int, default=None,
                    help="Model width override (passed through to the "
                         "train CLI)")
    ap.add_argument("--num_conv_blocks", type=int, default=None,
                    help="Single-branch depth override (passed through)")
    ap.add_argument("--output_base", default=".")
    ap.add_argument("--cache_dir", default=None,
                    help="Shared decoded-tile cache across combinations "
                         "(default: <output_base>/.tile_cache)")
    ap.add_argument("--analyse", action="store_true",
                    help="Run the sweep analyzer over the results afterwards")
    ap.add_argument("--keep_going", action="store_true",
                    help="Continue the grid when a combination fails")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="Train on the CUDA card (default) or the CPU")
    args = ap.parse_args(argv)

    from crosstalk_tpu_torch.cli.train import main as train_main

    cache_dir = args.cache_dir or os.path.join(args.output_base, ".tile_cache")
    combos = [(b, lr) for b in args.batch_sizes for lr in args.learning_rates]
    print(f"Sweep: {len(combos)} combinations "
          f"(B in {args.batch_sizes}, LR in {args.learning_rates})")
    failures = []
    for i, (bs, lr) in enumerate(combos):
        print(f"\n=== [{i + 1}/{len(combos)}] B={bs} LR={lr} ===")
        t0 = time.monotonic()
        rc = train_main([
            "-m", args.mixed_channel_data_dir,
            "-s", args.pure_source_data_dir,
            "-b", str(bs), "-l", repr(lr), "-n", str(args.num_epochs),
            "-j", str(args.cpu_jobs), "-o", args.model_options,
            "-r", args.learning_scheduler,
            "--compute_dtype", args.compute_dtype,
            "--output_base", args.output_base,
            "--cache_dir", cache_dir, "--device", args.device,
        ] + (["--initial_filters", str(args.initial_filters)]
             if args.initial_filters is not None else [])
          + (["--num_conv_blocks", str(args.num_conv_blocks)]
             if args.num_conv_blocks is not None else []))
        print(f"=== B={bs} LR={lr}: rc={rc} "
              f"({time.monotonic() - t0:.0f}s) ===")
        if rc != 0:
            failures.append((bs, lr, rc))
            if not args.keep_going:
                print("Stopping (use --keep_going to continue past failures).")
                break

    if failures:
        print(f"\n{len(failures)} combination(s) failed: {failures}")
    if args.analyse:
        from crosstalk_tpu_torch.cli.analyse import main as analyse_main

        print("\n=== Analysing sweep results ===")
        analyse_main([
            "-d", args.output_base,
            "-o", os.path.join(args.output_base,
                               "training_analysis_results.csv"),
        ])
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
