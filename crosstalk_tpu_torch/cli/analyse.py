"""Training-sweep analysis CLI (port of crosstalk_tpu/cli/analyse.py): the
reference's ``analyse_training_results.py`` rebuilt.

Scans a base directory for ``training_run_*`` run dirs, extracts batch size /
learning rate from the directory name (the reference's regex contract,
analyse_training_results.py:28), reads each training log by brute-forcing the
header offset exactly like the reference's ``skip_rows`` (lines 9-22, so logs
with a variable number of metadata rows keep working), recomputes the test
MSE from the predictions CSV (lines 71-83), writes a consolidated
``training_analysis_results.csv`` and prints the summary.

    python -m crosstalk_tpu_torch analyse -d RUNS_DIR [-o out.csv]

The card's host has no pandas, so this reads and writes CSV with the ``csv``
module and numpy, spelling values as pandas does (``pandas.read_csv`` and
``DataFrame.to_csv`` in the JAX package): a missing value is an empty cell,
an integer column that holds a missing value is written as floats
(``128.0``), and floats are written in their shortest round-trip form.

Divergence (shared with the JAX package): the reference hardcodes a Windows
share as the base directory (line 166); here it is the ``-d/--base_directory``
flag, default ".".
"""

from __future__ import annotations

import argparse
import csv
import glob
import math
import os
import re
import sys
from typing import Dict, List, Optional

import numpy as np

RUN_DIR_PATTERN = re.compile(r"training_run_.*_B(\d+)_LR([\d\.e\-]+)")

COLUMN_ORDER = [
    "directory",
    "batch_size",
    "learning_rate",
    "min_train_loss",
    "min_train_epoch",
    "min_val_loss",
    "min_val_epoch",
    "test_mse",
]

# the cells pandas.read_csv reads as missing (its default na_values)
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
       "nan", "null"}


def extract_run_info_from_dirname(dirname: str):
    match = RUN_DIR_PATTERN.search(dirname)
    if match:
        return int(match.group(1)), float(match.group(2))
    return None, None


def _read_rows(file_path: str) -> List[List[str]]:
    with open(file_path, newline="") as f:
        return list(csv.reader(f))


def _table_at(rows: List[List[str]], skip: int, nrows: Optional[int] = None):
    """(header, data rows) of the CSV after ``skip`` lines, blank lines
    left out, as ``pandas.read_csv(skiprows=skip, nrows=nrows)`` reads it.
    Raises ValueError where pandas raises a parse error: no header, or a
    data row read with more fields than the header takes."""
    body = [r for r in rows[skip:] if r]
    if not body:
        raise ValueError("no columns to parse")
    header, data = body[0], body[1:] if nrows is None else body[1:1 + nrows]
    for r in data:
        if len(r) > len(header):
            raise ValueError(f"expected {len(header)} fields, saw {len(r)}")
    return header, data


def skip_rows(file_path: str, colname: str, max_tries: int = 50) -> int:
    """Find the first skiprows value at which ``colname`` is a CSV header."""
    try:
        rows = _read_rows(file_path)
    except (OSError, UnicodeDecodeError, csv.Error):
        return -1
    for skip in range(max_tries):
        try:
            header, _ = _table_at(rows, skip, nrows=1)
        except ValueError:
            continue
        if colname in header:
            return skip
    return -1


_POW10 = [float(f"1e{k}") for k in range(309)]
_INF = {"inf": math.inf, "+inf": math.inf, "infinity": math.inf,
        "+infinity": math.inf, "-inf": -math.inf, "-infinity": -math.inf}


def _pandas_float(cell: str) -> float:
    """A float as ``pandas.read_csv`` parses it by default: its C parser's
    ``precise_xstrtod`` (pandas/_libs/src/parser/tokenizer.c), which sums
    up to 17 digits in a double and scales by a power of ten. It differs
    from Python's correctly rounded ``float()`` by a few ulps on about a
    third of 17-digit strings, and the JAX analyser writes what it parsed.
    Raises ValueError for a cell that is not a number."""
    s = cell.strip()
    if s.lower() in _INF:
        return _INF[s.lower()]
    i, n = 0, len(s)
    negative = i < n and s[i] == "-"
    if i < n and s[i] in "+-":
        i += 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while i < n and s[i].isdigit():
        if digits < 17:
            number = number * 10.0 + (ord(s[i]) - 48)
            digits += 1
        else:
            exponent += 1
        i += 1
    if i < n and s[i] == ".":
        i += 1
        while digits < 17 and i < n and s[i].isdigit():
            number = number * 10.0 + (ord(s[i]) - 48)
            digits += 1
            decimals += 1
            i += 1
        while i < n and s[i].isdigit():
            i += 1
        exponent -= decimals
    if digits == 0:
        raise ValueError(f"not a number: {cell!r}")
    if negative:
        number = -number
    if i < n and s[i] in "eE":
        i += 1
        exp_negative = i < n and s[i] == "-"
        if i < n and s[i] in "+-":
            i += 1
        value, exp_digits = 0, 0
        while exp_digits < 17 and i < n and s[i].isdigit():
            value = value * 10 + (ord(s[i]) - 48)
            exp_digits += 1
            i += 1
        if exp_digits == 0:
            raise ValueError(f"not a number: {cell!r}")
        exponent += -value if exp_negative else value
    if i != n:
        raise ValueError(f"not a number: {cell!r}")
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _column(header: List[str], data: List[List[str]], name: str) -> list:
    """One column as pandas types it: int when every cell is an integer,
    float (NaN for a missing cell) when every cell is a number or missing,
    else the strings."""
    i = header.index(name)  # ValueError when the column is absent
    cells = [r[i] if i < len(r) else "" for r in data]
    try:
        return [int(c) for c in cells]
    except ValueError:
        pass
    try:
        return [math.nan if c in _NA else _pandas_float(c) for c in cells]
    except ValueError:
        return cells


def _argmin(values: list) -> int:
    """pandas' idxmin: the first minimum, missing values left out."""
    arr = np.asarray(values, dtype=np.float64)  # ValueError for strings
    if np.isnan(arr).all():
        raise ValueError("attempt to get argmin of an empty sequence")
    return int(np.nanargmin(arr))


def analyze_training_log(log_file_path: str) -> Optional[dict]:
    try:
        skip = skip_rows(log_file_path, "epoch")
        if skip < 0:
            raise ValueError("no header row found")
        header, data = _table_at(_read_rows(log_file_path), skip)
        epoch = _column(header, data, "epoch")
        train = _column(header, data, "train_loss")
        val = _column(header, data, "val_loss")
        i_train = _argmin(train)
        i_val = _argmin(val)
        return {
            "min_train_loss": train[i_train],
            "min_train_epoch": epoch[i_train],
            "min_val_loss": val[i_val],
            "min_val_epoch": epoch[i_val],
        }
    except Exception as e:
        print(f"Error reading training log {log_file_path}: {e}")
        return None


def analyze_test_predictions(test_file_path: str) -> Optional[float]:
    try:
        skip = skip_rows(test_file_path, "Actual_Label")
        if skip < 0:
            raise ValueError("no header row found")
        header, data = _table_at(_read_rows(test_file_path), skip)
        actual = np.asarray(_column(header, data, "Actual_Label"), np.float64)
        predicted = np.asarray(_column(header, data, "Predicted_Label"), np.float64)
        return float(np.mean((actual - predicted) ** 2))
    except Exception as e:
        print(f"Error reading test predictions {test_file_path}: {e}")
        return None


def analyze_training_directory(base_directory: str) -> list:
    results = []
    for training_dir in sorted(glob.glob(os.path.join(base_directory, "training_run_*"))):
        dir_name = os.path.basename(training_dir)
        print(f"Analyzing directory: {dir_name}")
        batch_size, learning_rate = extract_run_info_from_dirname(dir_name)
        result = {
            "directory": dir_name,
            "batch_size": batch_size,
            "learning_rate": learning_rate,
            "min_train_loss": None,
            "min_train_epoch": None,
            "min_val_loss": None,
            "min_val_epoch": None,
            "test_mse": None,
        }
        logs = glob.glob(os.path.join(training_dir, "training_log_*.csv"))
        if logs:
            analysis = analyze_training_log(logs[0])
            if analysis:
                result.update(analysis)
        else:
            print(f"  Warning: No training log found in {dir_name}")
        preds = glob.glob(os.path.join(training_dir, "test_predictions_*.csv"))
        if preds:
            mse = analyze_test_predictions(preds[0])
            if mse is not None:
                result["test_mse"] = mse
        else:
            print(f"  Warning: No test predictions found in {dir_name}")
        results.append(result)
    return results


def _cells(values: list) -> List[str]:
    """A column's cells as ``DataFrame.to_csv`` writes them."""
    present = [v for v in values if v is not None]
    numeric = all(isinstance(v, (int, float, np.integer, np.floating))
                  and not isinstance(v, bool) for v in present)
    if present and numeric:
        if len(present) == len(values) and all(
                isinstance(v, (int, np.integer)) for v in present):
            return [str(int(v)) for v in values]
        return ["" if v is None or math.isnan(v) else repr(float(v)) for v in values]
    return ["" if v is None else str(v) for v in values]


def save_results_to_csv(results: list, output_file: str) -> None:
    columns = [_cells([r[k] for r in results]) for k in COLUMN_ORDER]
    with open(output_file, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(COLUMN_ORDER)
        writer.writerows(zip(*columns))
    print(f"Results saved to: {output_file}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Consolidate training_run_* sweep results."
    )
    parser.add_argument("-d", "--base_directory", type=str, default=".",
                        help="Directory containing training_run_* subdirectories")
    parser.add_argument("-o", "--output_file", type=str,
                        default="training_analysis_results.csv")
    args = parser.parse_args(argv)

    print("Starting training analysis...")
    print(f"Looking for training directories in: {os.path.abspath(args.base_directory)}")
    results = analyze_training_directory(args.base_directory)
    if not results:
        print("No training directories found!")
        return 1
    print(f"\nFound {len(results)} training directories")
    save_results_to_csv(results, args.output_file)

    print("\nAnalysis Summary:")
    print("=" * 50)
    for r in results:
        print(f"Directory: {r['directory']}")
        print(f"  Batch Size: {r['batch_size']}, Learning Rate: {r['learning_rate']}")
        if r["min_train_loss"] is not None:
            print(f"  Min Train Loss: {r['min_train_loss']:.6f} (Epoch {r['min_train_epoch']})")
            print(f"  Min Val Loss: {r['min_val_loss']:.6f} (Epoch {r['min_val_epoch']})")
        if r["test_mse"] is not None:
            print(f"  Test MSE: {r['test_mse']:.6f}")
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
