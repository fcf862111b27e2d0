"""``host_forward.<cell>``: the self time of the program's span
``crosstalk.train.forward`` (the host's enqueue of the train step's
forward, and any wait inside it) over the traced window, in %."""

from benchmark.spans import window_share


def read(run):
    return window_share(run, "crosstalk.train.forward")
