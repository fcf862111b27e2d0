"""Tracing and debug switches (port of crosstalk_tpu/utils/profiling.py).

  * :func:`maybe_trace` records a ``torch.profiler`` trace (host and, on a
    card, CUDA activity) of a code region behind a flag, written as a
    Chrome trace JSON (view it in Perfetto or chrome://tracing);
  * :func:`span` marks a host phase of the program (``crosstalk.*``) while
    a ``torch.profiler`` session runs, whoever started it (``--profile``,
    the benchmark's traced window); :func:`span_self_seconds` reads them;
  * :func:`enable_debug_checks` is the counterpart of the JAX package's
    ``jax_debug_nans`` / ``jax_debug_infs``: autograd's anomaly mode (a
    backward that makes a NaN raises and names the forward op) and a
    forward hook on every module that raises on the first non-finite
    output. Paths that run no ``nn.Module`` (the folded ``--fast`` forward,
    the eval metrics) call :func:`check_finite` on their results.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_debug_checks = False


class SpanRecord:
    """One span: ``time.time_ns()`` at its start and end (the clock the
    profiler's events carry), the span that enclosed it on its thread
    (``parent``) and its attributes, those of its enclosing spans included."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "attrs")

    def __init__(self, name: str, parent: Optional["SpanRecord"], attrs: dict):
        self.name = name
        self.parent = parent
        self.attrs = {**parent.attrs, **attrs} if parent is not None else attrs
        self.start_ns = time.time_ns()
        self.end_ns: Optional[int] = None


class _SpanBuffer:
    """The spans of one profiler session, in the order they opened."""

    def __init__(self):
        self.records: List[SpanRecord] = []
        self.live = False  # the last span to look found a session running
        self.open = threading.local()  # .stack: this thread's open spans

    def reset(self) -> None:
        self.records = []


_spans = _SpanBuffer()


class _Span:
    def __init__(self, name: str, host_only: bool, attrs: dict):
        self.name, self.host_only, self.attrs = name, host_only, attrs

    def __enter__(self) -> SpanRecord:
        if not _spans.live:  # a new session: drop the spans of the last one
            _spans.reset()
            _spans.live = True
        stack = getattr(_spans.open, "stack", None)
        if stack is None:
            stack = _spans.open.stack = []
        self.record = SpanRecord(self.name, stack[-1] if stack else None, self.attrs)
        _spans.records.append(self.record)
        stack.append(self.record)
        self.twin = None
        if self.host_only:
            self.twin = torch.profiler.record_function(self.name)
            self.twin.__enter__()
        return self.record

    def __exit__(self, *exc) -> bool:
        if self.twin is not None:
            self.twin.__exit__(*exc)
        self.record.end_ns = time.time_ns()
        _spans.open.stack.pop()
        return False


_NO_SPAN = contextlib.nullcontext()


def span(name: str, *, host_only: bool, **attrs):
    """A context that records the enclosed host phase while a profiler
    session runs, and does nothing (a shared no-op context, no torch call)
    while none does.

    The record (:class:`SpanRecord`) goes to an in-memory buffer that holds
    one session's spans. ``host_only=True`` also enters the phase as
    ``torch.profiler.record_function(name)``, so the profiler's timeline
    (and ``maybe_trace``'s chrome trace) carries it as a host event; give it
    only to a phase that launches no kernel and no copy, since the profiler
    files a range that does as device activity. Names start with
    ``crosstalk.``.

    The buffer is emptied by ``maybe_trace``'s entry and by the first span
    to find a session running after a span found none; so two sessions
    with no span between them share it."""
    if not _autograd_profiler._is_profiler_enabled:
        _spans.live = False
        return _NO_SPAN
    return _Span(name, host_only, attrs)


def span_records() -> List[SpanRecord]:
    """The ended spans of the current (or last) profiler session."""
    return [r for r in _spans.records if r.end_ns is not None]


def span_self_seconds() -> Dict[str, float]:
    """Self time by span name over the current (or last) session, in
    seconds: each span's duration less what its child spans cover."""
    done = span_records()
    covered: Dict[int, int] = {}
    for r in done:
        p = r.parent
        if p is not None and p.end_ns is not None:
            inside = min(r.end_ns, p.end_ns) - max(r.start_ns, p.start_ns)
            covered[id(p)] = covered.get(id(p), 0) + max(inside, 0)
    out: Dict[str, int] = {}
    for r in done:
        out[r.name] = out.get(r.name, 0) + r.end_ns - r.start_ns - covered.get(id(r), 0)
    return {name: ns / 1e9 for name, ns in out.items()}


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]):
    """Record a profiler trace of the enclosed region when a dir is given:
    ``<trace_dir>/trace_<pid>.json`` (one file per process, so every rank
    of a multi-process run writes its own). The trace carries the
    ``host_only`` spans; :func:`span_self_seconds` reads all of them."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    _spans.reset()

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))
    print(f"Profiler trace written to {trace_dir}")


def _finite_hook(module, inputs, output) -> None:
    # every module of the two regressors returns one tensor
    if isinstance(output, torch.Tensor) and output.is_floating_point() and not bool(
            torch.isfinite(output).all()):
        raise FloatingPointError(
            f"non-finite value in the output of {module._get_name()} (--debug_nans)")


def enable_debug_checks() -> None:
    """Fail fast on NaN/Inf: anomaly mode for every backward, and a check
    of every module's forward output (each one syncs with the device)."""
    global _debug_checks
    if _debug_checks:
        return
    _debug_checks = True
    torch.autograd.set_detect_anomaly(True)
    torch.nn.modules.module.register_module_forward_hook(_finite_hook)


def check_finite(what: str, tensors) -> None:
    """Under ``enable_debug_checks``: raise FloatingPointError when any of
    ``tensors`` (a tensor or a dict of them) holds a NaN or an Inf."""
    if not _debug_checks:
        return
    items = tensors.items() if isinstance(tensors, dict) else [(what, tensors)]
    for name, t in items:
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite value in {what}: {name} (--debug_nans)")
