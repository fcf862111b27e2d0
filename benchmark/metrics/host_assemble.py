"""``host_assemble.<cell kind>``: the self time of the program's span
``crosstalk.pipeline.assemble`` (the host's assembly of each batch: the
index cut, the buffer and the row copies) over the traced window, in %."""

from benchmark.spans import window_share


def read(run):
    return window_share(run, "crosstalk.pipeline.assemble")
