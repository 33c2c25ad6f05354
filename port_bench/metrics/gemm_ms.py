"""Models: device ms a step in cuBLAS products, mean over ranks."""

from port_bench.trace import group, mean, traces


def read(run):
    return mean(t.ms_per_step(lambda n: group(n) == "gemm") for t in traces(run.ranks))
