"""``device_idle.<cell kind>``: the share of the traced window in which no
operation (kernel, copy or fill) ran on the card, in %."""


def read(run):
    t = run.trace_summary
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
