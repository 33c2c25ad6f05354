"""Models: device ms a step in elementwise kernels (``trace.group`` "other")
of ``gpt.ln`` (every layer norm: ln1, ln2, lnf), forward, recompute and
backward, from the host-traced window, mean over ranks."""

from port_bench.regions import ms


def read(run):
    return ms(run, lambda region, phase, group: group == "other" and region == "gpt.ln")
