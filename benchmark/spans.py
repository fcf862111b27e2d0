"""What the per-layer metrics of the program's spans share: a span's self
time over the traced window (``crosstalk_tpu_torch.utils.profiling``'s
``span_self_seconds``, which holds the spans of the last profiler session,
the window's)."""


def window_share(run, name: str):
    """100 x the self seconds of span ``name`` / the traced window's seconds;
    None without a trace, or where the program recorded no such span (a
    program without spans included)."""
    t = run.trace_summary
    if t is None or t.window_s <= 0:
        return None
    try:
        from crosstalk_tpu_torch.utils.profiling import span_self_seconds
    except ImportError:
        return None
    seconds = span_self_seconds().get(name)
    return None if seconds is None else 100.0 * seconds / t.window_s
