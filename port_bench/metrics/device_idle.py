"""Device: the share of the traced window in which no kernel, copy or set
ran on the card, in %, mean over ranks."""

from port_bench.trace import mean, traces


def read(run):
    return mean(100 * (1 - t.busy_s / t.window_s) for t in traces(run.ranks))
