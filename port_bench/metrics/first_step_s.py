"""Train step: seconds from the weights made to the end of the first step
(cuBLAS, the kernel library's load, the caching allocator's first blocks),
on the slowest rank."""


def read(run):
    return max(r["stamps"]["first_step"] - r["stamps"]["weights"] for r in run.ranks)
