"""Teacher -> student distillation onto a smaller serving config (port of
tools/distill.py).

The reference hardcodes one model size per family (train_model.py:534-537);
``--initial_filters`` exposes the width axis. Distillation trains a small
student against a trained teacher's predictions instead of (or blended
with, ``--blend``) the raw labels. On corpora with exact labels (synthetic
drawn alphas) the teacher's own error is noise added to the target and
plain training (``--blend 1``) wins (TRAINING_RESULTS "Distillation onto
the width-32 serving config"); distillation's value case is noisy-label
corpora, where the teacher is a denoised target.

Protocol (mirrors the train CLI so every artifact lands in the standard
run-dir contract and the student .pth serves through the standard stack):

  * the corpus splits 70/15/15 with the reference's seed-43 permutation;
  * the TEACHER (-p, any trained checkpoint) labels the train split through
    the eval engine (``eval/engine.py``): distill target = blend*true +
    (1-blend)*teacher (the MSE-equivalent of the blended two-term
    distillation loss, since w*(s-y)^2 + (1-w)*(s-t)^2 =
    (s - (w*y+(1-w)*t))^2 + const);
  * validation/best-model selection and the final test evaluation use the
    TRUE labels (the deployment objective — teacher labels steer training,
    never the scoreboard);
  * the student trains with the standard loop (``train/loop.py``; onecycle
    defaults) and the run dir gets the full artifact set (params.txt,
    training log CSV, best/final .pth, loss plot, per-split prediction
    CSVs), so analyse/eval/serve tooling works unchanged.

Usage:
  python -m crosstalk_tpu_torch.tools.distill -m DATA/Mixed -s DATA/Source \\
      -p teacher.pth [--initial_filters 32] [-b 256 -l 5e-4 -n 50 \\
      -r onecycle] [--blend 0.1] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Distill a trained teacher into a smaller student")
    p.add_argument("-m", "--mixed_channel_data_dir", required=True)
    p.add_argument("-s", "--pure_source_data_dir", required=True)
    p.add_argument("-p", "--teacher_path", required=True,
                   help="trained teacher checkpoint (.pth)")
    p.add_argument("-o", "--model_options", default="single",
                   choices=["single", "double"],
                   help="teacher/student family (the student is the same "
                        "family at a smaller width)")
    p.add_argument("--initial_filters", type=int, default=32,
                   help="student width (teacher's width comes from -p)")
    p.add_argument("--num_conv_blocks", type=int, default=None,
                   help="student depth (default: the family's standard)")
    p.add_argument("-b", "--batch_size", type=int, default=256)
    p.add_argument("-l", "--learning_rate", type=float, default=5e-4)
    p.add_argument("-n", "--num_epochs", type=int, default=50)
    p.add_argument("-r", "--learning_scheduler", default="onecycle")
    p.add_argument("-j", "--cpu_jobs", type=int, default=4)
    p.add_argument("--blend", type=float, default=0.0,
                   help="weight on the TRUE labels in the distill target "
                        "(0 = pure teacher, 1 = plain training)")
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--output_base", default=".")
    p.add_argument("--cache_dir", default=None)
    p.add_argument("--resume", default=None, metavar="RUN_DIR",
                   help="existing distillation training_run_* directory to "
                        "resume from its last checkpoint (identity "
                        "hyperparameters are re-adopted from its params.txt; "
                        "-n stays from this invocation as the extendable "
                        "total-epoch target, like the train CLI)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Run on the CUDA card (default) or the CPU")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (0.0 <= args.blend <= 1.0):
        print("Error: --blend must be in [0, 1].")
        return 1

    import torch

    from crosstalk_tpu_torch.config import ModelConfig, OptimConfig, TrainConfig
    from crosstalk_tpu_torch.data.index import PairIndex, split_samples
    from crosstalk_tpu_torch.data.pipeline import TileStore
    from crosstalk_tpu_torch.device import (
        device_label,
        resolve_device,
        set_parity_numerics,
    )
    from crosstalk_tpu_torch.eval.engine import evaluate, model_forward
    from crosstalk_tpu_torch.io import artifacts
    from crosstalk_tpu_torch.io.torch_convert import (
        load_pth,
        model_config_for_checkpoint,
    )
    from crosstalk_tpu_torch.models.registry import (
        build_model,
        init_model,
        torch_style_repr,
    )
    from crosstalk_tpu_torch.train.loop import finish_training_run, train_model
    from crosstalk_tpu_torch.train.steps import init_train_state

    device = resolve_device(args.device)  # raises when CUDA is missing
    set_parity_numerics()
    print(f"Using device: {device_label(device)}")

    if args.resume:
        # A resumed distillation continues the SAME run: the hyperparameters
        # that define its identity (teacher, student shape, distill target,
        # split seed, schedule, artifact naming) come from the original
        # params.txt, not this invocation's flags/defaults — the same
        # contract as the train CLI's --resume. -n stays from the
        # invocation: it is the (extendable) total-epoch target. The
        # -m/-s/-p PATHS are NOT adopted (they may legitimately move) — the
        # invocation's paths are used, with a note when they differ.
        original = artifacts.read_params_txt(args.resume)
        if not original or "distilled_from" not in original:
            print(f"Error: {args.resume} is not a distillation run "
                  "directory (no params.txt with a distilled_from record) — "
                  "--resume needs the directory the distill tool created.")
            return 1
        if not glob.glob(os.path.join(args.resume, "checkpoints", "*")):
            print(f"Error: no checkpoints under {args.resume}/checkpoints — "
                  "nothing to resume (cleaned directory or partial copy). "
                  "Start a fresh run instead.")
            return 1
        adopted = artifacts.adopt_run_identity(original, args, (
            ("model_options", str),
            ("initial_filters", artifacts.opt_int),
            ("num_conv_blocks", artifacts.opt_int),
            ("blend", float),
            ("batch_size", int),
            ("learning_rate", float),
            ("learning_scheduler", str),
            ("seed", int),
        ))
        if adopted:
            print("Resume: adopting the original run's hyperparameters: "
                  + ", ".join(adopted))
        for key in ("mixed_channel_data_dir", "pure_source_data_dir",
                    "teacher_path"):
            if key in original and getattr(args, key) != original[key]:
                print(f"Resume: note — {key} differs from the original "
                      f"record ({original[key]}); using this invocation's "
                      f"{getattr(args, key)}")

    # ---- data: reference split protocol ------------------------------
    try:
        index = PairIndex(args.mixed_channel_data_dir,
                          args.pure_source_data_dir)
    except (ValueError, FileNotFoundError) as e:
        print(f"Error: {e}")
        return 1
    train_samples, val_samples, test_samples = split_samples(
        index.samples, 0.7, 0.15, seed=args.seed)
    print(f"Split sizes: Train = {len(train_samples)}, "
          f"Validation = {len(val_samples)}, Test = {len(test_samples)}")
    stores = {
        name: TileStore(samples, jobs=args.cpu_jobs,
                        cache_dir=args.cache_dir)
        for name, samples in (("train", train_samples), ("val", val_samples),
                              ("test", test_samples))
    }
    image_size = int(stores["train"].tiles.shape[1])

    # ---- teacher: label the train split ------------------------------
    try:
        teacher_sd = load_pth(args.teacher_path)
        teacher_cfg = model_config_for_checkpoint(args.model_options, teacher_sd)
        teacher = build_model(teacher_cfg, image_size=image_size, device=device)
        teacher.load_state_dict(teacher_sd)
    except Exception as e:
        print(f"Error loading teacher checkpoint: {e}")
        return 1
    print(f"Teacher: {args.teacher_path} ({teacher_cfg})")
    teacher_forward = model_forward(teacher, teacher_cfg.compute_dtype)

    def teacher_predict(store):
        rows, _ = evaluate(teacher_forward, store, device,
                           batch_size=min(args.batch_size, 256),
                           with_metrics=False, desc="teacher labels")
        return np.array([[r["Predicted_Label"]] for r in rows],
                        dtype=np.float32)

    t_train = teacher_predict(stores["train"])
    teacher_test = teacher_predict(stores["test"])
    teacher_test_mse = float(
        np.mean((teacher_test - stores["test"].labels) ** 2))
    true_train = stores["train"].labels.copy()
    stores["train"].labels = (
        args.blend * true_train + (1.0 - args.blend) * t_train)
    print(f"Distill target: {args.blend:.2f}*true + "
          f"{1 - args.blend:.2f}*teacher "
          f"(teacher-vs-true train MAE "
          f"{float(np.abs(t_train - true_train).mean()):.4f})")
    del teacher

    # ---- student: standard training loop, standard artifacts ---------
    model_kw = {}
    if args.model_options == "single":
        model_kw["initial_filters"] = args.initial_filters
    else:
        model_kw["initial_filters_per_branch"] = args.initial_filters
    if args.num_conv_blocks is not None:
        model_kw["num_conv_blocks"] = args.num_conv_blocks
    student_cfg = ModelConfig(variant=args.model_options, **model_kw)

    if args.resume:
        run_dir = args.resume
        m = re.search(r"training_run_(.*)_B\d+_LR", run_dir)
        ts = m.group(1) if m else artifacts.timestamp()
        print(f"Resuming distillation run in: {run_dir}")
        # params.txt stays the ORIGINAL run's record; log this invocation
        # separately (same convention as the train CLI).
        artifacts.write_params_txt(run_dir, dict(vars(args)),
                                   filename="params_resume.txt")
    else:
        ts = artifacts.timestamp()
        run_dir = artifacts.make_training_run_dir(
            args.output_base, ts, args.batch_size, args.learning_rate)
        print(f"Saving all outputs to: {run_dir}")
        params = dict(vars(args))
        params["distilled_from"] = args.teacher_path
        artifacts.write_params_txt(run_dir, params)
        artifacts.write_architecture_txt(
            run_dir, torch_style_repr(student_cfg, image_size=image_size))

    optim_cfg = OptimConfig(learning_rate=args.learning_rate,
                            scheduler=args.learning_scheduler)
    batch_size = min(args.batch_size, len(train_samples))
    train_cfg = TrainConfig(batch_size=batch_size,
                            num_epochs=args.num_epochs,
                            output_base=args.output_base)

    def model_for(state_dict=None):
        # initialized on the CPU from the seed, as the train CLI does
        model = build_model(student_cfg, image_size=image_size)
        if state_dict is None:
            init_model(model, torch.Generator().manual_seed(args.seed))
        else:
            model.load_state_dict(state_dict)
        return model.to(device)

    state = init_train_state(model_for(), optim_cfg)
    state, train_losses, val_losses = train_model(
        state, stores["train"], stores["val"], optim_cfg, train_cfg,
        run_dir, ts, compute_dtype=student_cfg.compute_dtype, seed=args.seed,
        resume=args.resume is not None, naming_batch_size=args.batch_size)
    print("Distillation training finished!")

    # ---- scoreboard: TRUE labels, the shared finishing path ----------
    stores["train"].labels = true_train
    final_path, split_mse = finish_training_run(
        model_for, state, run_dir, args.batch_size, args.learning_rate,
        lambda split: stores[split], eval_batch_size=min(batch_size, 256),
        train_losses=train_losses, val_losses=val_losses,
        compute_dtype=student_cfg.compute_dtype)
    print(f"\nDistillation summary: student test MSE {split_mse['test']:.6f}"
          f" vs teacher test MSE {teacher_test_mse:.6f} "
          f"(ratio {split_mse['test'] / max(teacher_test_mse, 1e-12):.3f}; "
          f"student width {args.initial_filters}; student .pth {final_path})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
