"""Train step: device ms a step in elementwise kernels (``trace.group``
"other") launched inside ``train.optimizer`` (all of ``AdamW.update_``:
the global norm, the clip, the moments, the update), from the host-traced
window, mean over ranks."""

from port_bench.regions import ms


def read(run):
    return ms(run, lambda region, phase, group: group == "other" and region == "train.optimizer")
