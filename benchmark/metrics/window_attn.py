"""``window_attn.<cell>``: the device seconds of the program's
``record_function`` range ``crosstalk.swin.window_attention`` (each Swin
block's attention forward, which the profiler files as device activity
from its first kernel to its last) over the traced window, in %. Nothing
to read where the program has no such range."""

RANGE = "crosstalk.swin.window_attention"


def read(run):
    t = run.trace_summary
    if t is None or t.window_s <= 0 or RANGE not in t.kernels:
        return None
    return 100.0 * t.kernels[RANGE][0] / t.window_s
