"""The host batch pipeline's producer thread on the CPU: ``device_batches``
over ``iterate_batches`` assembles the batches on a producer thread and
hands over the same bytes, in the same order, as a plain serial assembly
(shuffled or not, a padded tail, ``drop_last``, a rank's ``assemble_rows``);
an error in assembly reaches the consumer; a pass, whole, cut short or
failed, leaves no thread behind; and the consumer's ``crosstalk.pipeline.wait``
spans number one per batch, each with a boolean ``ready``, while the
producer's spans carry the ``pass`` they are given, with no parent."""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crosstalk_tpu_torch.config import ModelConfig
from crosstalk_tpu_torch.data.index import Sample
from crosstalk_tpu_torch.data.pipeline import (
    Batch,
    TileStore,
    device_batches,
    iterate_batches,
)
from crosstalk_tpu_torch.eval.engine import evaluate
from crosstalk_tpu_torch.eval.fast_forward import make_fast_forward
from crosstalk_tpu_torch.models.registry import build_model
from crosstalk_tpu_torch.utils.profiling import span, span_records

CPU = torch.device("cpu")
SIZE, N = 16, 21


def _store(n: int = N, size: int = SIZE) -> TileStore:
    rng = np.random.default_rng(5)
    store = TileStore.__new__(TileStore)
    alphas = rng.uniform(0.01, 0.5, n)
    store.samples = [Sample(str(i), float(a), "", "") for i, a in enumerate(alphas)]
    store.labels = alphas.astype(np.float32).reshape(-1, 1)
    store.ids = np.arange(100, 100 + n, dtype=np.int64)
    store.tiles = rng.random((n, size, size, 2), dtype=np.float32)
    return store


def _serial(store, batch_size, shuffle=False, drop_last=False, seed=0, epoch=0,
            assemble_rows=None, **_):
    """The batches as a plain row loop assembles them, one after another."""
    n = len(store)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(np.random.SeedSequence([seed, epoch])).shuffle(order)
    rows = slice(None) if assemble_rows is None else assemble_rows
    end = (n // batch_size) * batch_size if drop_last else n
    out = []
    for start in range(0, end, batch_size):
        idx = list(order[start:start + batch_size])
        mask = [1.0] * len(idx) + [0.0] * (batch_size - len(idx))
        idx = np.array(idx + [0] * (batch_size - len(idx)))[rows]
        out.append(Batch(np.stack([store.tiles[i] for i in idx]), store.labels[idx],
                         store.ids[idx], np.array(mask, np.float32)[rows]))
    return out


def _same_bytes(got: Batch, want: Batch) -> None:
    for field in Batch._fields:
        a = getattr(got, field)
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        b = getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


@pytest.mark.parametrize("batch_size,kw", [
    (8, {}),                                                  # padded tail
    (7, dict(shuffle=True, seed=3, epoch=2)),                  # exact, shuffled
    (5, dict(shuffle=True, seed=3, epoch=1)),                  # shuffled, padded
    (5, dict(shuffle=True, drop_last=True, seed=9, epoch=0)),  # tail dropped
    (8, dict(shuffle=True, seed=1, epoch=4, assemble_rows=slice(2, 6))),
    (8, dict(assemble_rows=slice(4, 8))),                      # the tail's padding rows
    (6, dict(shuffle=True, assembly_threads=1)),               # no assembly pool
    (32, {}),                                                  # one batch, padded
])
def test_threaded_batches_are_byte_identical_to_a_serial_assembly(batch_size, kw):
    store = _store()
    want = _serial(store, batch_size, **kw)
    threaded = list(device_batches(iterate_batches(store, batch_size, **kw), CPU))
    plain = list(iterate_batches(store, batch_size, **kw))
    assert len(threaded) == len(plain) == len(want) > 0
    for got, host, ref in zip(threaded, plain, want):
        _same_bytes(got, ref)
        _same_bytes(host, ref)


def test_no_batch_the_consumer_holds_is_written_again():
    store = _store()
    held = list(device_batches(iterate_batches(store, 4, shuffle=True, seed=2), CPU))
    pointers = {b.inputs.data_ptr() for b in held}
    assert len(pointers) == len(held)
    for got, ref in zip(held, _serial(store, 4, shuffle=True, seed=2)):
        _same_bytes(got, ref)


class _FaultyTiles:
    """Tiles whose row ``bad`` cannot be read (``np.take`` calls ``take``)."""

    def __init__(self, tiles, bad):
        self.tiles, self.bad, self.shape = tiles, bad, tiles.shape

    def take(self, indices, **kw):
        if self.bad in indices:
            raise OSError(f"cannot read row {self.bad}")
        return self.tiles.take(indices, **kw)


def test_an_error_in_assembly_reaches_the_consumer_and_leaves_no_thread():
    store = _store()
    store.tiles = _FaultyTiles(store.tiles, bad=13)
    before = threading.active_count()
    got = []
    with pytest.raises(OSError, match="cannot read row 13"):
        for b in device_batches(iterate_batches(store, 4), CPU):
            got.append(b.ids.tolist())
    assert [i - 100 for ids in got for i in ids] == list(range(len(got) * 4))
    assert len(got) < 13 // 4 + 1
    assert threading.active_count() == before


def test_closing_after_the_first_batch_leaves_no_thread():
    store = _store()
    before = threading.active_count()
    batches = device_batches(iterate_batches(store, 4, shuffle=True), CPU)
    first = next(batches)
    assert threading.active_count() > before  # the producer and its pool
    batches.close()
    assert threading.active_count() == before
    _same_bytes(first, _serial(store, 4, shuffle=True)[0])


def test_an_error_in_evaluate_stops_the_producer():
    cfg = ModelConfig(initial_filters=8, num_conv_blocks=3)
    torch.manual_seed(0)
    forward = make_fast_forward(cfg, build_model(cfg, image_size=SIZE).eval().state_dict())
    calls = []

    def failing(x):
        calls.append(len(x))
        if len(calls) == 2:
            raise RuntimeError("the step failed")
        return forward(x)

    store = _store()
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="the step failed"):
        evaluate(failing, store, CPU, batch_size=4)
    assert threading.active_count() == before
    rows, _ = evaluate(forward, store, CPU, batch_size=4)  # a pass after it is whole
    assert [r["Image_ID"] for r in rows] == list(range(100, 100 + N))
    assert threading.active_count() == before


def test_the_wait_spans_number_one_per_batch_and_say_whether_it_was_ready():
    store = _store()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("crosstalk.test.pass", host_only=False, **{"pass": 41}) as outer:
            got = list(device_batches(iterate_batches(store, 4), CPU, tags={"pass": 41}))
    recs = span_records()
    waits = [r for r in recs if r.name == "crosstalk.pipeline.wait"]
    assert sorted(r.attrs["batch"] for r in waits) == list(range(len(got)))
    assert all(type(r.attrs["ready"]) is bool for r in waits)
    assert all(r.parent is outer for r in waits)
    for name in ("crosstalk.pipeline.assemble", "crosstalk.pipeline.stage"):
        mine = [r for r in recs if r.name == name]
        assert sorted(r.attrs["batch"] for r in mine) == list(range(len(got))), name
        assert all(r.parent is None and r.attrs["pass"] == 41 for r in mine), name


def test_a_stressed_producer_hands_over_every_pass_whole_or_cut():
    """Passes cut after every possible batch, with the interpreter switching
    threads every microsecond: each hands over a prefix of the serial
    batches and leaves no thread behind."""
    store = _store()
    want = _serial(store, 3, shuffle=True, seed=7)
    before = threading.active_count()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for cut in range(len(want) + 1):
            batches = device_batches(iterate_batches(store, 3, shuffle=True, seed=7), CPU)
            got = [b for _, b in zip(range(cut), batches)]
            batches.close()
            assert threading.active_count() == before, cut
            for g, w in zip(got, want):
                _same_bytes(g, w)
            assert len(got) == cut
    finally:
        sys.setswitchinterval(interval)


@pytest.mark.parametrize("wrap", [list, iter])
def test_any_iterable_of_host_batches_goes_through_the_producer(wrap):
    """Batches handed over ready-made are copied into the producer's
    destinations under the same spans; one of no length costs one more
    wait, for its end."""
    store = _store()
    host = list(iterate_batches(store, 5, shuffle=True, seed=4))
    with profile(activities=[ProfilerActivity.CPU]):
        got = list(device_batches(wrap(host), CPU, tags={"pass": 7}))
    assert len(got) == len(host)
    for g, h in zip(got, host):
        _same_bytes(g, h)
        assert not np.shares_memory(g.inputs.numpy(), h.inputs)
    recs = span_records()
    waits = [r.attrs["batch"] for r in recs if r.name == "crosstalk.pipeline.wait"]
    assert sorted(waits) == list(range(len(host) + (wrap is iter)))
    for name in ("crosstalk.pipeline.assemble", "crosstalk.pipeline.stage"):
        mine = [r for r in recs if r.name == name]
        assert sorted(r.attrs["batch"] for r in mine) == list(range(len(host))), name
        assert all(r.parent is None and r.attrs["pass"] == 7 for r in mine), name
