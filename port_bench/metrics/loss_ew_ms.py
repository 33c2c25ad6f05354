"""Models: device ms a step in elementwise kernels (``trace.group`` "other")
of ``gpt.head_loss`` (the tied head and the cross entropy), forward and
backward, from the host-traced window, mean over ranks."""

from port_bench.regions import ms


def read(run):
    return ms(run, lambda region, phase, group: group == "other" and region == "gpt.head_loss")
