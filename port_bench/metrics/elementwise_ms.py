"""Train step and models: device ms a step in every kernel that is neither a
cuBLAS product, nor the attention kernels, nor NCCL (the optimizer, the loss,
casts, layer norms, MoE dispatch and combine), mean over ranks."""

from port_bench.trace import group, mean, traces


def read(run):
    return mean(t.ms_per_step(lambda n: group(n) == "other") for t in traces(run.ranks))
