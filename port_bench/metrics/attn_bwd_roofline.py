"""Kernels: the least time of one step's causal backward calls
(``flops.attention_step_ms``: each shape the architecture's
``attention_calls`` gives, at ``flops.attention_bounds``) over the device
ms a step in ``flash_bwd_wgmma_kernel`` and its
``flash_bwd_dq_convert_kernel`` together, in %, mean over ranks."""

from port_bench.flops import attention_step_ms
from port_bench.trace import mean, traces


def _bwd(name):
    return "flash_bwd_wgmma" in name or "flash_bwd_dq_convert" in name


def read(run):
    least = attention_step_ms(run.model, run.traffic)["bwd"]
    return mean(100 * least / t.ms_per_step(_bwd) for t in traces(run.ranks)
                if t.count(lambda n: "flash_bwd_wgmma" in n))
