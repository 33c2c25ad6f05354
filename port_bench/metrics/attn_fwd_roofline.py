"""Kernels: the least time of one step's causal forward calls
(``flops.attention_step_ms``: each shape the architecture's
``attention_calls`` gives, at ``flops.attention_bounds``) over the device
ms a step in ``flash_fwd_wgmma_kernel``, in %, mean over ranks."""

from port_bench.flops import attention_step_ms
from port_bench.trace import mean, traces


def _fwd(name):
    return "flash_fwd_wgmma" in name


def read(run):
    least = attention_step_ms(run.model, run.traffic)["fwd"]
    return mean(100 * least / t.ms_per_step(_fwd) for t in traces(run.ranks) if t.count(_fwd))
