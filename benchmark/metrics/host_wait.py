"""``host_wait.<cell kind>``: the self time of the program's span
``crosstalk.pipeline.wait`` (the engine's wait for the next batch that the
pipeline's producer thread assembles) over the traced window, in %. A
program whose pipeline has no producer records no such span and gives
none."""

from benchmark.spans import window_share


def read(run):
    return window_share(run, "crosstalk.pipeline.wait")
