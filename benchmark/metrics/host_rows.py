"""``host_rows.<cell kind>``: the self time of the program's span
``crosstalk.engine.rows`` (the host's loss sum and result rows of each
batch, after the read-back) over the traced window, in %."""

from benchmark.spans import window_share


def read(run):
    return window_share(run, "crosstalk.engine.rows")
