"""Readings for the limits of a cell's comparisons, in one process: the
program on many seeds, the control and the planted faults (see the
drivers' ``Variants``) on a few, each through a whole run at the cell's own
size with a short window. Prints one JSON line per run and writes them to
``--out`` as well.

    python3 benchmark/readings.py --workload single.score-b64 \\
        --seeds 11,12,13 --variants program,control --seconds 3 --out readings.jsonl

Needs the cell's cards, as ``run.py`` does. The benchmark's own runs never
run a control or a fault.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            run = harness.Run(cell, seed, args.seconds, False, torch.device("cuda", 0),
                              time.monotonic(), variant=variant)
            try:
                harness.execute(run)
                rec = {"workload": cell.name, "variant": variant, "seed": seed,
                       "correct": run.correct,
                       "checks": {k: v[0] for k, v in run.checks.items()},
                       "e2e": run.e2e, "readings": run.readings,
                       "attempted": run.attempted, "failed": run.failed,
                       "memory_peak_bytes": run.memory_peak_bytes}
            except Exception as e:  # noqa: BLE001 - a control may crash; recorded
                rec = {"workload": cell.name, "variant": variant, "seed": seed,
                       "error": f"{type(e).__name__}: {e}"}
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            del run
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
