"""``mfu.<cell kind>``: the model FLOPs of the work the window completed
(``benchmark/flops.py``: forward per tile scored; 3 x forward per tile
trained), over the traced window, as a share of the card's bf16 dense peak
(989 TFLOP/s at 700 W), in %."""

from benchmark.flops import PEAK_BF16_FLOPS


def read(run):
    t, done = run.trace_summary, run.work.get("model_flops")
    if t is None or not done or t.window_s <= 0:
        return None
    return 100.0 * done / t.window_s / PEAK_BF16_FLOPS
