"""Kernels: the causal forward's least time at the call's shape
(``flops.attention_bounds``) over the mean device ms of one
``flash_fwd_wgmma_kernel`` call, in %, mean over ranks."""

from port_bench.flops import attention_bounds
from port_bench.trace import mean, traces


def read(run):
    m = run.model
    bh = run.traffic["rows_per_gpu"] * m["n_head"]
    least = attention_bounds(bh, run.traffic["seq"], m["n_embd"] // m["n_head"])["fwd"]["ms"]
    shares = []
    for t in traces(run.ranks):
        calls = t.count(lambda n: "flash_fwd_wgmma" in n)
        if calls:
            shares.append(100 * least / (t.ms_per_step(lambda n: "flash_fwd_wgmma" in n)
                                         * t.steps / calls))
    return mean(shares)
