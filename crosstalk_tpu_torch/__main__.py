"""Command dispatcher: ``python -m crosstalk_tpu_torch <command> [...]``
(port of crosstalk_tpu/__main__.py).

One entry point over the port's CLIs (each also runs as
``python -m crosstalk_tpu_torch.cli.<module>``):

    python -m crosstalk_tpu_torch train -m Mixed -s Source -b 256 -l 5e-4
    python -m crosstalk_tpu_torch evaluate -p model.pth -m Mixed -s Source --fast
    python -m crosstalk_tpu_torch predict -m Mixed -s Source -p model.pth --unmix
    python -m crosstalk_tpu_torch serve -p model.pth --port 8000
    python -m crosstalk_tpu_torch remote-eval -m Mixed -s Source --url http://h:8000
    python -m crosstalk_tpu_torch analyse -d runs/
    python -m crosstalk_tpu_torch export -p model.pth --out model.ctkt
    python -m crosstalk_tpu_torch doctor -p model.pth

Every command runs on the CUDA card unless given ``--device cpu``.
``export`` is ``crosstalk_tpu_torch.tools.export_model``, part of the
package, so it needs no repo checkout (the JAX dispatcher loads it from the
checkout's ``tools/`` and says so when that is missing).
"""

from __future__ import annotations

import sys


def _load(command: str):
    if command == "train":
        from crosstalk_tpu_torch.cli.train import main
    elif command in ("evaluate", "eval", "test"):
        from crosstalk_tpu_torch.cli.evaluate import main
    elif command == "predict":
        from crosstalk_tpu_torch.cli.predict import main
    elif command == "serve":
        from crosstalk_tpu_torch.cli.serve import main
    elif command in ("remote-eval", "remote_eval"):
        from crosstalk_tpu_torch.cli.remote_eval import main
    elif command in ("analyse", "analyze"):
        from crosstalk_tpu_torch.cli.analyse import main
    elif command == "doctor":
        from crosstalk_tpu_torch.cli.doctor import main
    elif command == "export":
        from crosstalk_tpu_torch.tools.export_model import main
    else:
        return None
    return main


_USAGE = """usage: python -m crosstalk_tpu_torch <command> [args...]

commands:
  train        train a model (reference train_model.py surface)
  evaluate     score a labeled directory + classical metrics (test-cross-talk-model.py)
  predict      score unlabeled pairs; --unmix writes corrected tiles
  serve        HTTP serving with dynamic batching
  remote-eval  reference eval workflow against a running server
  analyse      consolidate training_run_* sweeps (analyse_training_results.py)
  export       AOT serving artifact (a torch.export program, its weights and
               metadata)
  doctor       verify this machine's deployment health (card, kernel build
               cache, native decoder, forward smoke test, checkpoint/server
               probes)

Commands run on the CUDA card; pass --device cpu to run on the CPU.
`python -m crosstalk_tpu_torch <command> --help` shows each command's flags."""


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(_USAGE)
        return 0 if argv else 1
    command, rest = argv[0], argv[1:]
    entry = _load(command)
    if entry is None:
        print(f"Error: unknown command '{command}'.\n\n{_USAGE}")
        return 1
    return entry(rest)


if __name__ == "__main__":
    sys.exit(main())
