"""Regenerate the reference's missing pretrained-model artifact (port of
tools/make_pretrained.py).

The reference README points to
``PreTrained_Model/crosstalk_regression_model_trained_{ts}_{bs}_{lr}.pth``
(README.md:52), but that file is not in the snapshot. This tool trains a
stand-in with the same architecture on a given paired-tile dataset through
the port's train CLI and writes it under the reference's exact
directory/file naming, so downstream workflows (the eval CLI's ``-p``, the
README quickstart) have a real artifact to point at. The checkpoint is in
the reference ``.pth`` key schema (io/torch_convert.py).

Usage:
  python -m crosstalk_tpu_torch.tools.make_pretrained -m MIXED_DIR -s SOURCE_DIR \\
      [-o single|double] [-b 256] [-l 5e-4] [-n 50] [--out PreTrained_Model] \\
      [--device cuda|cpu]

Defaults mirror the naming of the reference's published artifact
(batch 256, lr 5e-4 — README.md:52 / train_model.py:645-646).
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys
import tempfile


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Train and export a PreTrained_Model artifact."
    )
    parser.add_argument("-m", "--mixed_channel_data_dir", required=True)
    parser.add_argument("-s", "--pure_source_data_dir", required=True)
    parser.add_argument("-o", "--model_options", default="single",
                        choices=["single", "double"])
    parser.add_argument("-b", "--batch_size", type=int, default=256)
    parser.add_argument("-l", "--learning_rate", type=float, default=5e-4)
    parser.add_argument("-n", "--num_epochs", type=int, default=50)
    parser.add_argument("-r", "--learning_scheduler", default="aggressive_plateau")
    parser.add_argument("-j", "--cpu_jobs", type=int, default=4)
    parser.add_argument("--initial_filters", type=int, default=None,
                        help="Model width override (passed through to the "
                             "train CLI; reference artifact: default width)")
    parser.add_argument("--num_conv_blocks", type=int, default=None,
                        help="Single-branch depth override (passed through)")
    parser.add_argument("--out", default="PreTrained_Model",
                        help="Output directory (reference: PreTrained_Model/)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="Train on the CUDA card (default) or the CPU")
    args = parser.parse_args(argv)

    from crosstalk_tpu_torch.cli.train import main as train_main

    workdir = tempfile.mkdtemp(prefix="crosstalk_pretrain_")
    try:
        rc = train_main([
            "-m", args.mixed_channel_data_dir,
            "-s", args.pure_source_data_dir,
            "-b", str(args.batch_size), "-l", str(args.learning_rate),
            "-n", str(args.num_epochs), "-j", str(args.cpu_jobs),
            "-o", args.model_options, "-r", args.learning_scheduler,
            "--output_base", workdir, "--device", args.device,
        ] + (["--initial_filters", str(args.initial_filters)]
             if args.initial_filters is not None else [])
          + (["--num_conv_blocks", str(args.num_conv_blocks)]
             if args.num_conv_blocks is not None else []))
        if rc != 0:
            return rc

        (final,) = glob.glob(os.path.join(
            workdir, "training_run_*",
            "crosstalk_regression_model_trained_*.pth"))
        os.makedirs(args.out, exist_ok=True)
        dest = os.path.join(args.out, os.path.basename(final))
        shutil.copy2(final, dest)
        print(f"Pretrained model written to {dest}")
        return 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
