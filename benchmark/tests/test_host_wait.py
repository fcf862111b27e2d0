"""``host_wait.score``: a traced run of the score cell reports the engine's
wait for assembled batches as a share of the window; a program whose
pipeline records no ``crosstalk.pipeline.wait`` span gives none and raises
nothing."""

from benchmark import harness
from benchmark.tests.conftest import SMALL, tiny_run


def _traced_score_run():
    run = tiny_run("single.score-b64", **SMALL["single.score-b64"])
    run.trace = True
    return harness.execute(run)


def test_a_traced_score_run_reports_the_wait_share():
    run = _traced_score_run()
    got = harness.result_line(run)["metrics"]["host_wait.score"]
    assert 0.0 <= got["value"] <= 100.0 and got["unit"] == "%"


def test_a_program_without_the_wait_span_gives_no_share(monkeypatch):
    run = _traced_score_run()
    from crosstalk_tpu_torch.utils import profiling

    selfs = profiling.span_self_seconds()
    monkeypatch.setattr(profiling, "span_self_seconds", lambda: {
        k: v for k, v in selfs.items() if k != "crosstalk.pipeline.wait"})
    assert harness.reader("host_wait.score")(run) is None
