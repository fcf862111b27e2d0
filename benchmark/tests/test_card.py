"""On the card, at each cell's own size with a short window: a sound run
is correct, and a run whose timed path computes below its stated precision
is not: the scoring cell against the program's int8 tier, the train cells
against the reference in fp8 in the step's place. ``benchmark/readings.py``
takes the readings behind the limits."""

import time

import pytest

from benchmark import harness
from benchmark.tests.conftest import SMALL

CASES = ([(name, "program", True) for name in sorted(SMALL)]
         + [("single.score-b64", "control", False),
            ("single.train-b256", "control", False),
            ("double.train-b256", "control", False)])


@pytest.mark.cuda
@pytest.mark.parametrize("name,variant,correct", CASES)
def test_cell_on_the_card(card, name, variant, correct):
    run = harness.Run(harness.load_cell(name), 2**31 + 101, 2.0, False, card,
                      time.monotonic(), variant=variant)
    assert harness.execute(run).correct is correct, run.checks
