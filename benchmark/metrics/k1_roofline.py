"""``k1_roofline.<cell kind>``: kernel K1's least time per call on the
window's rows (``benchmark/flops.py``: its bytes at the HBM bandwidth, or its
FLOPs at the bf16 peak, whichever is longer) over its measured device time
per call in the trace, in %. Nothing to read where no K1 call ran."""

from benchmark.flops import k1_least_seconds

KERNEL = "fused_input_block"


def read(run):
    t, rows = run.trace_summary, run.work.get("k1_rows")
    if t is None or not rows:
        return None
    calls = [v for k, v in t.kernels.items() if KERNEL in k]
    seconds, count = sum(v[0] for v in calls), sum(v[1] for v in calls)
    if not count or seconds <= 0:
        return None
    return 100.0 * k1_least_seconds(run.config, rows) / (seconds / count)
