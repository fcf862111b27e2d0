"""Run-directory artifact contract (port of crosstalk_tpu/io/artifacts.py;
same file names and CSV schema). The reference's analysis tool parses run
directory and file names back (analyse_training_results.py:28, 102, 106).

  training_run_{ts}_B{bs}_LR{lr}/          (train_model.py:541-545)
    params.txt                             (547-553; params_resume.txt on --resume)
    model_architecture.txt                 (556-559)
    training_log_{ts}_{bs}_{lr}_{schedtype}.csv   4 metadata rows + header
                                           (395-405)
    best_model_{schedtype}.pth             (456-461)
    lr_schedule_{schedtype}.png            (479-489)
    crosstalk_regression_model_trained_{ts}_{bs}_{lr}.pth  (644-648)
    training_validation_loss_{ts}_{bs}_{lr}.png  (651-664, y in [0, 0.02])
    {split}_predictions_{ts}_{bs}_{lr}.csv + scatter plot  (64-93)
    checkpoints/                           (resume state, io/checkpoint.py)

  eval_run_{ts}/                           (test-cross-talk-model.py:260-264)
    params.txt, model_architecture.txt
    {split}_predictions_{ts}.csv           (92-98; 8-column schema)
    {split}_{metric}_plot_{ts}.png         (103-121; one per metric)
  predict_run_{ts}/                        (cli/predict.py)
    params.txt, predictions_{ts}.csv, unmixed/

Timestamps use the reference's '%Y-%m-%d_%H-%M-%S' format. Where
matplotlib is missing the PNG plots are skipped with a notice; the CSVs hold
every number they show.
"""

from __future__ import annotations

import csv
import importlib.util
import os
from datetime import datetime
from typing import Dict, List, Optional, Sequence

TS_FORMAT = "%Y-%m-%d_%H-%M-%S"

EVAL_FIELDNAMES = [
    "Image_ID",
    "Actual_Label",
    "Predicted_Label",
    "Root Mean Squared Error",
    "Structural Similarity Index",
    "Histogram Correlation",
    "Normalized Mutual Information",
    "Pearsons Correlation",
]

TRAIN_FIELDNAMES = ["Actual_Label", "Predicted_Label"]


def timestamp() -> str:
    return datetime.now().strftime(TS_FORMAT)


def make_training_run_dir(base: str, ts: str, batch_size: int, learning_rate: float) -> str:
    path = os.path.join(base, f"training_run_{ts}_B{batch_size}_LR{learning_rate}")
    os.makedirs(path, exist_ok=True)
    return path


def make_eval_run_dir(base: str, ts: str) -> str:
    path = os.path.join(base, f"eval_run_{ts}")
    os.makedirs(path, exist_ok=True)
    return path


def make_predict_run_dir(base: str, ts: str) -> str:
    path = os.path.join(base, f"predict_run_{ts}")
    os.makedirs(path, exist_ok=True)
    return path


def write_params_txt(run_dir: str, args_dict: Dict,
                     filename: str = "params.txt") -> str:
    """'{arg}: {value}' per line (train_model.py:547-553)."""
    path = os.path.join(run_dir, filename)
    with open(path, "w") as f:
        for arg, value in args_dict.items():
            f.write(f"{arg}: {value}\n")
    return path


def read_params_txt(run_dir: str, filename: str = "params.txt") -> Dict[str, str]:
    """Parse a params.txt back into {arg: value-string}; {} if absent."""
    path = os.path.join(run_dir, filename)
    if not os.path.exists(path):
        return {}
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            if ": " in line:
                key, _, value = line.rstrip("\n").partition(": ")
                out[key] = value
    return out


def opt_int(v):
    """Cast a params.txt value to int, mapping the recorded ``None`` of an
    unset optional flag (and absence) back to None."""
    return None if v in (None, "None", "") else int(v)


def adopt_run_identity(original, args, table):
    """Overwrite ``args``' identity hyperparameters with the values a
    previous run recorded in its params.txt: a resumed run must not silently
    switch the hyperparameters that define it (naming, split, schedule,
    model shape) because the resume invocation used other flags/defaults.

    ``original`` is ``read_params_txt``'s dict; ``table`` is
    ``((key, cast), ...)``. Keys absent from ``original`` are left as the
    invocation gave them. -> the list of ``"key=value"`` adoptions applied.
    """
    adopted = []
    for key, cast in table:
        if key in original:
            orig_val = cast(original[key])
            if getattr(args, key) != orig_val:
                adopted.append(f"{key}={orig_val}")
                setattr(args, key, orig_val)
    return adopted


def write_architecture_txt(run_dir: str, summary: str) -> str:
    path = os.path.join(run_dir, "model_architecture.txt")
    with open(path, "w") as f:
        f.write(summary)
    return path


class TrainingLog:
    """training_log_*.csv writer: 4 metadata rows, then the epoch header,
    then one row per epoch (train_model.py:395-405, 470). Rows are flushed
    per epoch so a killed run keeps its history.

    ``resume_from_epoch`` keeps an existing log's rows up to (and including)
    that epoch and continues after them; rows past it (logged after the last
    durable checkpoint by a crashed run) are dropped, since those epochs are
    about to be trained again."""

    def __init__(self, run_dir: str, ts: str, batch_size: int,
                 learning_rate: float, scheduler_type: str,
                 scheduler_params: Dict, resume_from_epoch: Optional[int] = None):
        self.path = os.path.join(
            run_dir,
            f"training_log_{ts}_{batch_size}_{learning_rate}_{scheduler_type}.csv",
        )
        kept_rows: List[List[str]] = []
        if resume_from_epoch is not None and os.path.exists(self.path):
            with open(self.path, newline="") as f:
                reader = list(csv.reader(f))
            for row in reader[5:]:  # past the 4 metadata rows + header
                try:
                    if row and int(row[0]) <= resume_from_epoch:
                        kept_rows.append(row)
                except ValueError:
                    continue
        self._file = open(self.path, "w", newline="")
        self._writer = csv.writer(self._file)
        self._writer.writerow(["Learning Rate", learning_rate])
        self._writer.writerow(["Batch Size", batch_size])
        self._writer.writerow(["Scheduler Type", scheduler_type])
        self._writer.writerow(["Scheduler Params", str(scheduler_params)])
        self._writer.writerow(["epoch", "train_loss", "val_loss", "learning_rate"])
        self._writer.writerows(kept_rows)
        self._file.flush()

    def log_epoch(self, epoch: int, train_loss: float, val_loss: float, lr: float):
        self._writer.writerow([epoch, train_loss, val_loss, lr])
        self._file.flush()

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NullTrainingLog:
    """No-op ``TrainingLog`` for the ranks other than 0 of a multi-process
    run, where rank 0 owns the CSV (the data-parallel slice)."""

    def log_epoch(self, *args, **kwargs):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def write_predictions_csv(path: str, rows: Sequence[Dict], fieldnames: List[str]) -> str:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        writer.writeheader()
        writer.writerows(rows)
    return path


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where it is missing."""
    if importlib.util.find_spec("matplotlib") is None:
        return None
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_predictions_scatter(run_dir: str, rows: Sequence[Dict], dataset_name: str,
                             filename: str) -> Optional[str]:
    """The actual-vs-predicted scatter (train_model.py:80-93), written for
    each split after training and by the remote eval CLI. -> its path, or
    None where matplotlib is missing (skipped with a notice)."""
    plt = _pyplot()
    if plt is None:
        print(f"matplotlib is not installed: skipped {filename}")
        return None
    actual = [r["Actual_Label"] for r in rows]
    predicted = [r["Predicted_Label"] for r in rows]
    plt.figure(figsize=(8, 8))
    plt.scatter(actual, predicted, alpha=0.6, s=10)
    plt.plot([min(actual), max(actual)], [min(actual), max(actual)],
             "--r", label="Ideal Prediction (y=x)")
    plt.xlabel("Actual Label")
    plt.ylabel("Predicted Label")
    plt.title(f"{dataset_name.capitalize()} Set: Actual vs. Predicted Labels")
    plt.legend()
    path = os.path.join(run_dir, filename)
    plt.savefig(path)
    plt.close()
    return path


def plot_metric_scatters(run_dir: str, rows: Sequence[Dict], dataset_name: str,
                         ts: str) -> List[str]:
    """The eval-side per-metric scatters — one PNG per column from
    Predicted_Label onward (test-cross-talk-model.py:103-121). On a host
    without matplotlib the plots are skipped with a notice; the CSV holds
    every number they show."""
    plt = _pyplot()
    if plt is None:
        print(f"matplotlib is not installed: skipped the "
              f"{len(EVAL_FIELDNAMES) - 2} per-metric plots")
        return []

    actual = [r["Actual_Label"] for r in rows]
    paths = []
    for field in EVAL_FIELDNAMES[2:]:
        metric = [r[field] for r in rows]
        plt.figure(figsize=(10, 10))
        plt.scatter(actual, metric, alpha=0.05, s=5)
        plt.plot([min(actual), max(actual)], [min(actual), max(actual)],
                 "--r", label="Ideal Prediction (y=x)")
        plt.xlabel("Actual Label")
        plt.ylabel(field)
        plt.title(f"{dataset_name.capitalize()} Set: Actual Labels vs. {field}")
        plt.legend()
        path = os.path.join(run_dir, f"{dataset_name}_{field}_plot_{ts}.png")
        plt.savefig(path)
        plt.close()
        paths.append(path)
    return paths


def plot_loss_curves(run_dir: str, train_losses: Sequence[float],
                     val_losses: Sequence[float], ts: str, batch_size: int,
                     learning_rate: float) -> Optional[str]:
    """Loss-over-epochs plot, y clamped to [0, 0.02] (train_model.py:651-664)."""
    filename = f"training_validation_loss_{ts}_{batch_size}_{learning_rate}.png"
    plt = _pyplot()
    if plt is None:
        print(f"matplotlib is not installed: skipped {filename}")
        return None
    plt.figure(figsize=(10, 6))
    epochs = range(1, len(train_losses) + 1)
    plt.plot(epochs, train_losses, label="Train Loss")
    plt.plot(epochs, val_losses, label="Val Loss")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.ylim(bottom=0, top=0.02)
    plt.title("Training and Validation Loss Over Epochs")
    plt.legend()
    plt.grid(True)
    path = os.path.join(run_dir, filename)
    plt.savefig(path)
    plt.close()
    return path


def plot_lr_schedule(run_dir: str, lr_history: Sequence[float],
                     scheduler_type: str) -> Optional[str]:
    """Per-epoch LR plot, log y (train_model.py:479-489)."""
    filename = f"lr_schedule_{scheduler_type}.png"
    plt = _pyplot()
    if plt is None:
        print(f"matplotlib is not installed: skipped {filename}")
        return None
    plt.figure(figsize=(10, 6))
    plt.plot(list(lr_history))
    plt.xlabel("Epoch")
    plt.ylabel("Learning Rate")
    plt.title(f"Learning Rate Schedule ({scheduler_type})")
    plt.yscale("log")
    plt.grid(True)
    path = os.path.join(run_dir, filename)
    plt.savefig(path)
    plt.close()
    return path
