"""Train step: the model FLOPs of the window's tokens (``port_bench/flops.py``:
active parameters, causal attention) over the window's seconds times the
bf16 peak of every GPU used, in %."""

from port_bench.flops import PEAK_BF16_FLOPS, train_flops_per_token


def read(run):
    if run.ranks[0]["window"]["peak_bytes"] is None:  # not on a card
        return None
    flops = train_flops_per_token(run.model, run.traffic["seq"]) * run.window_tokens
    return 100 * flops / (run.window_s * PEAK_BF16_FLOPS * run.gpus)
