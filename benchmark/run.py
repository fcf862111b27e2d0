"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program
(``crosstalk_tpu_torch``). It needs as many NVIDIA cards as the cell asks
for and exits with code 2, printing no result, where there are fewer: it
never falls back to the CPU. With ``--trace 0`` the result line carries the
cell's end-to-end metrics; with ``--trace 1`` the window is recorded by
``torch.profiler`` and the line carries the per-layer metrics, the device's
busy time and a breakdown. The last lines on standard error, and the
``checks`` entry of the result line, give each number compared with the
reference beside its limit. The kernels the program builds go under the
checkout's ``.cache/``.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} NVIDIA card(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    harness.execute(run)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package were loaded: {loaded}", file=sys.stderr)
        return 3
    line = harness.result_line(run)
    for name, (value, limit) in run.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
