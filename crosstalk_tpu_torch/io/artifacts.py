"""Eval- and predict-side run-directory artifacts (port of that subset of
crosstalk_tpu/io/artifacts.py; same file names and CSV schema).

  eval_run_{ts}/                           (test-cross-talk-model.py:260-264)
    params.txt, model_architecture.txt
    {split}_predictions_{ts}.csv           (92-98; 8-column schema)
    {split}_{metric}_plot_{ts}.png         (103-121; one per metric)
  predict_run_{ts}/                        (cli/predict.py)
    params.txt, predictions_{ts}.csv, unmixed/

Timestamps use the reference's '%Y-%m-%d_%H-%M-%S' format.
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


def timestamp() -> str:
    return datetime.now().strftime(TS_FORMAT)


def make_eval_run_dir(base: str, ts: str) -> str:
    path = os.path.join(base, f"eval_run_{ts}")
    os.makedirs(path, exist_ok=True)
    return path


def make_predict_run_dir(base: str, ts: str) -> str:
    path = os.path.join(base, f"predict_run_{ts}")
    os.makedirs(path, exist_ok=True)
    return path


def write_params_txt(run_dir: str, args_dict: Dict) -> str:
    """params.txt, '{arg}: {value}' per line (train_model.py:547-553)."""
    path = os.path.join(run_dir, "params.txt")
    with open(path, "w") as f:
        for arg, value in args_dict.items():
            f.write(f"{arg}: {value}\n")
    return path


def write_architecture_txt(run_dir: str, summary: str) -> str:
    path = os.path.join(run_dir, "model_architecture.txt")
    with open(path, "w") as f:
        f.write(summary)
    return path


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
    """The actual-vs-predicted scatter (train_model.py:80-93), written by
    the remote eval CLI. -> its path, or None where matplotlib is missing
    (skipped with a notice; the CSV holds every number it shows)."""
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
