"""The per-layer metrics read from the program's spans (``metrics/host_*``):
a traced run of the score cell reports each of them, each a share of the
window; the spans share one thread, so together they fill at most all of
it. A program without spans (``span_self_seconds`` missing) gives none and
raises nothing."""

import sys
import types

from benchmark import harness
from benchmark.tests.conftest import SMALL, tiny_run

SPAN_METRICS = ("host_assemble.score", "host_stage.score", "host_launch.score",
                "host_rows.score")


def _traced_score_run():
    run = tiny_run("single.score-b64", **SMALL["single.score-b64"])
    run.trace = True
    return harness.execute(run)


def test_a_traced_score_run_reports_the_span_shares():
    run = _traced_score_run()
    got = harness.result_line(run)["metrics"]
    values = [got[name]["value"] for name in SPAN_METRICS]
    assert all(0.0 <= v <= 100.0 for v in values), values
    assert sum(values) <= 100.0
    assert all(got[name]["unit"] == "%" for name in SPAN_METRICS)
    assert not [k for k, _ in run.trace_summary.top_ops(1000) if k.startswith("crosstalk.")]


def test_a_program_without_spans_gives_no_share(monkeypatch):
    run = _traced_score_run()
    monkeypatch.setitem(sys.modules, "crosstalk_tpu_torch.utils.profiling",
                        types.ModuleType("crosstalk_tpu_torch.utils.profiling"))
    assert all(harness.reader(name)(run) is None for name in SPAN_METRICS)


def test_an_untraced_run_gives_no_share():
    run = harness.execute(tiny_run("single.score-b64", **SMALL["single.score-b64"]))
    assert all(harness.reader(name)(run) is None for name in SPAN_METRICS)
