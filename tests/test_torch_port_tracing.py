"""The program's spans (``utils/profiling.span``) on the CPU: they record
only while a ``torch.profiler`` session runs and call nothing of torch
otherwise; ``evaluate`` over an in-RAM ``TileStore`` records, per batch,
the pipeline's ``assemble`` and ``stage`` on its producer thread (no
children of the pass, which they name by its ``pass``), and the pipeline's
``wait`` and the engine's ``launch`` and ``rows`` as children of the pass,
joined by their ``batch`` and ``pass`` attributes; the twinned ones
(``rows`` and ``wait``, on the pass's thread) are events of the profiler's
timeline (and of ``maybe_trace``'s chrome trace) on the spans' clock; each
session starts from an empty buffer; and tracing changes no result."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crosstalk_tpu_torch.config import ModelConfig
from crosstalk_tpu_torch.data.index import Sample
from crosstalk_tpu_torch.data.pipeline import TileStore
from crosstalk_tpu_torch.eval.engine import evaluate
from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward
from crosstalk_tpu_torch.models.registry import build_model
from crosstalk_tpu_torch.utils import profiling
from crosstalk_tpu_torch.utils.profiling import (
    maybe_trace,
    span,
    span_records,
    span_self_seconds,
)

CPU = torch.device("cpu")
SIZE, N, BATCH = 32, 20, 8  # three batches, the last one padded
PRODUCER_SPANS = ("crosstalk.pipeline.assemble", "crosstalk.pipeline.stage")
CHILD_SPANS = ("crosstalk.pipeline.wait", "crosstalk.engine.launch",
               "crosstalk.engine.rows")
BATCH_SPANS = PRODUCER_SPANS + CHILD_SPANS
TWINNED = {"crosstalk.pipeline.wait", "crosstalk.engine.rows"}


def _store() -> TileStore:
    rng = np.random.default_rng(0)
    store = TileStore.__new__(TileStore)
    alphas = rng.uniform(0.01, 0.5, N)
    store.samples = [Sample(str(i), float(a), "", "") for i, a in enumerate(alphas)]
    store.labels = alphas.astype(np.float32).reshape(-1, 1)
    store.ids = np.arange(N, dtype=np.int64)
    store.tiles = rng.random((N, SIZE, SIZE, 2), dtype=np.float32)
    return store


@pytest.fixture(scope="module")
def scoring():
    cfg = ModelConfig(initial_filters=8, num_conv_blocks=3)
    torch.manual_seed(0)
    model = build_model(cfg, image_size=SIZE).eval()
    return make_fast_forward(cfg, model.state_dict()), _store()


def _traced(fn):
    """-> (fn's result, the profiler, session start and end in ns)."""
    with span("crosstalk.test.idle", host_only=False):
        pass  # finds no session: the session's first span empties the buffer
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof, t0, time.time_ns()


def test_without_a_profiler_a_span_records_nothing_and_calls_no_torch(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = len(span_records())
    torch_calls = []

    def watch(frame, event, arg):
        mod = (getattr(arg, "__module__", None) or "" if event == "c_call"
               else frame.f_globals.get("__name__", ""))
        if mod.startswith("torch"):
            torch_calls.append((event, mod))

    sys.setprofile(watch)
    try:
        with span("crosstalk.test.off", host_only=True, batch=0) as got:
            pass
        with span("crosstalk.test.off", host_only=False) as again:
            pass
    finally:
        sys.setprofile(None)
    assert torch_calls == []
    assert got is None and again is None
    assert span("a", host_only=True) is span("b", host_only=False)  # one shared no-op
    assert len(span_records()) == before


def test_evaluate_records_the_four_spans_of_every_batch(scoring):
    forward, store = scoring
    (rows, _), _, t0, t1 = _traced(lambda: evaluate(forward, store, CPU, batch_size=BATCH))
    assert len(rows) == N
    recs = span_records()
    (whole,) = [r for r in recs if r.name == "crosstalk.engine.pass"]
    batches = -(-N // BATCH)
    for name in BATCH_SPANS:
        mine = [r for r in recs if r.name == name]
        assert sorted(r.attrs["batch"] for r in mine) == list(range(batches)), name
        assert {r.attrs["pass"] for r in mine} == {whole.attrs["pass"]}
        # the producer thread's spans carry the pass's attribute, no parent
        assert all(r.parent is (None if name in PRODUCER_SPANS else whole)
                   for r in mine), name
    for r in recs:
        assert r.name.startswith("crosstalk.") and "fused_input_block" not in r.name
        assert t0 <= r.start_ns <= r.end_ns <= t1
    assert all(isinstance(r.attrs["ready"], bool)
               for r in recs if r.name == "crosstalk.pipeline.wait")
    assert [r.attrs["rows"] for r in recs if r.name == BATCH_SPANS[0]] == [BATCH] * batches
    assert {r.attrs["bytes"] for r in recs if r.name == BATCH_SPANS[0]} == {
        BATCH * SIZE * SIZE * 2 * 4}
    selfs = span_self_seconds()
    assert set(selfs) == set(BATCH_SPANS) | {"crosstalk.engine.pass"}
    for name, seconds in selfs.items():
        total = sum(r.end_ns - r.start_ns for r in recs if r.name == name) / 1e9
        assert 0 <= seconds <= total
    inner = sum(selfs[n] for n in CHILD_SPANS)  # its own thread's children only
    assert selfs["crosstalk.engine.pass"] == pytest.approx(
        (whole.end_ns - whole.start_ns) / 1e9 - inner, abs=1e-6)


def _first_twin():
    # a process's first record_function takes 0.5-2 ms (profiler set-up)
    with torch.profiler.record_function("crosstalk.test.warm-up"):
        pass


def test_twinned_spans_are_events_of_the_profiler_on_the_spans_clock(scoring):
    forward, store = scoring
    _traced(_first_twin)
    _, prof, _, _ = _traced(lambda: evaluate(forward, store, CPU, batch_size=BATCH))
    events = [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()
              if e.name().startswith("crosstalk.")]
    # not launch, not pass, and not the producer thread's assemble and stage
    assert {name for name, _ in events} == TWINNED
    recs = span_records()
    assert len(events) == sum(r.name in TWINNED for r in recs)
    for name, start in events:
        nearest = min(abs(start - r.start_ns) for r in recs if r.name == name)
        assert nearest < 1_000_000, (name, nearest)


def test_each_session_starts_from_an_empty_buffer(scoring, tmp_path):
    forward, store = scoring
    _traced(lambda: evaluate(forward, store, CPU, batch_size=BATCH))
    first = {r.attrs["pass"] for r in span_records()}
    evaluate(forward, store, CPU, batch_size=BATCH)  # its spans find no session
    _, _, t0, _ = _traced(lambda: evaluate(forward, store, CPU, batch_size=BATCH))
    second = {r.attrs["pass"] for r in span_records()}
    assert len(second) == 1 and not first & second
    assert all(r.start_ns >= t0 for r in span_records())
    # maybe_trace's entry drops them too, with no span in between
    t0 = time.time_ns()
    with maybe_trace(str(tmp_path)):
        with span("crosstalk.test.only", host_only=False):
            pass
    assert [r.name for r in span_records()] == ["crosstalk.test.only"]
    assert span_records()[0].start_ns >= t0


def test_tracing_changes_no_result(scoring):
    forward, store = scoring
    off_rows, off_loss = evaluate(forward, store, CPU, batch_size=BATCH)
    (on_rows, on_loss), _, _, _ = _traced(
        lambda: evaluate(forward, store, CPU, batch_size=BATCH))
    assert on_loss == off_loss
    assert [list(r) for r in on_rows] == [list(r) for r in off_rows]
    for a, b in zip(on_rows, off_rows):
        for k in a:
            assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k


def test_maybe_trace_writes_the_twinned_spans(scoring, tmp_path, capsys):
    forward, store = scoring
    with maybe_trace(str(tmp_path)):
        evaluate(forward, store, CPU, batch_size=BATCH)
    (path,) = tmp_path.glob("trace_*.json")
    text = path.read_text()
    for name in TWINNED:
        assert f'"{name}"' in text, name
    for name in ("crosstalk.engine.launch",) + PRODUCER_SPANS:
        assert f'"{name}"' not in text, name
    assert "Profiler trace written" in capsys.readouterr().out


def test_self_time_leaves_out_children_on_the_same_thread():
    def nested():
        with span("crosstalk.test.outer", host_only=False, job=7):
            time.sleep(0.01)
            with span("crosstalk.test.inner", host_only=True):
                time.sleep(0.02)
            seen = {}
            worker = threading.Thread(target=lambda: seen.update(
                rec=span("crosstalk.test.other", host_only=False).__enter__()))
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
        return seen["rec"]

    other, _, _, _ = _traced(nested)
    by_name = {r.name: r for r in span_records()}
    outer, inner = by_name["crosstalk.test.outer"], by_name["crosstalk.test.inner"]
    assert inner.parent is outer and inner.attrs == {"job": 7}
    assert other.parent is None  # another thread's span is no child
    selfs = span_self_seconds()
    assert selfs["crosstalk.test.outer"] == pytest.approx(
        (outer.end_ns - outer.start_ns - (inner.end_ns - inner.start_ns)) / 1e9)
    assert selfs["crosstalk.test.inner"] == pytest.approx(
        (inner.end_ns - inner.start_ns) / 1e9)
    assert "crosstalk.test.other" not in selfs  # never ended
    assert profiling._spans.open.stack == []
