"""Train step: device ms a step in elementwise kernels (``trace.group``
"other") that no program region launched, in its forward or through its
backward (the stacking of per-layer gradients, the batch's casts, the
backward's seed), from the host-traced window, mean over ranks."""

from port_bench.regions import ms


def read(run):
    return ms(run, lambda region, phase, group: group == "other" and region is None)
