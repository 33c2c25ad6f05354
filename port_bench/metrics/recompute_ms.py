"""Train step: device ms a step in every kernel, copy and set that a
checkpoint's recompute launched (a program region run again inside an
autograd node of the backward), from the host-traced window, mean over
ranks."""

from port_bench.regions import ms


def read(run):
    return ms(run, lambda region, phase, group: phase == "recompute")
