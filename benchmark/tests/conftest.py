"""The benchmark's own tests. Those that need an NVIDIA card carry the
``cuda`` marker and skip elsewhere:

    python -m pytest -p no:cacheprovider benchmark/tests          # CPU
    python -m pytest -p no:cacheprovider benchmark/tests -m cuda  # on the card
"""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the cells at a size a CPU test holds: every width cut, the same code
TINY = {"single": dict(initial_filters=8, num_conv_blocks=3, image_size=32),
        "double": dict(initial_filters_per_branch=4, image_size=32)}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def tiny_run(name, variant="program", seconds=0.5, compute_dtype="f32", **params):
    """A run of the cell ``name`` on the CPU at a tiny size."""
    import torch

    from benchmark import harness

    cell = harness.load_cell(name)
    cell.config = {**cell.config, **TINY[cell.config["variant"]],
                   "compute_dtype": compute_dtype}
    cell.params = {**cell.params, **params}
    return harness.Run(cell, 2**31 + 12345, seconds, False, torch.device("cpu"),
                       time.monotonic(), variant=variant)


SMALL = {
    "single.score-b64": dict(tiles=32, batch_size=16, calibration_tiles=16, metric_sample=4),
    "double.train-b256": dict(tiles=32, batch_size=8),
    "single.train-b256": dict(tiles=32, batch_size=8),
}
