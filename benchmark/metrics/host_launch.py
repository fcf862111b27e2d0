"""``host_launch.<cell kind>``: the self time of the program's span
``crosstalk.engine.launch`` (the host's enqueue of each batch's normalize,
forward and metrics) over the traced window, in %."""

from benchmark.spans import window_share


def read(run):
    return window_share(run, "crosstalk.engine.launch")
