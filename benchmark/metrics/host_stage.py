"""``host_stage.<cell kind>``: the self time of the program's span
``crosstalk.pipeline.stage`` (the host's copy of each batch into pinned
memory) over the traced window, in %."""

from benchmark.spans import window_share


def read(run):
    return window_share(run, "crosstalk.pipeline.stage")
