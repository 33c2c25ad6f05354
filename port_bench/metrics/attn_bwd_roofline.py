"""Kernels: the causal backward's least time at the call's shape
(``flops.attention_bounds``) over the mean device ms of one backward call,
``flash_bwd_wgmma_kernel`` and its ``flash_bwd_dq_convert_kernel``
together, in %, mean over ranks."""

from port_bench.flops import attention_bounds
from port_bench.trace import mean, traces


def _bwd(name):
    return "flash_bwd_wgmma" in name or "flash_bwd_dq_convert" in name


def read(run):
    m = run.model
    bh = run.traffic["rows_per_gpu"] * m["n_head"]
    least = attention_bounds(bh, run.traffic["seq"], m["n_embd"] // m["n_head"])["bwd"]["ms"]
    shares = []
    for t in traces(run.ranks):
        calls = t.count(lambda n: "flash_bwd_wgmma" in n)
        if calls:
            shares.append(100 * least / (t.ms_per_step(_bwd) * t.steps / calls))
    return mean(shares)
