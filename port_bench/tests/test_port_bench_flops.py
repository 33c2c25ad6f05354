"""The frozen FLOP counts and bounds."""

from port_bench import flops
from port_bench.cells import resolve


def test_moe_counts_active_parameters():
    dense = resolve("gpt2_small.pretrain")["model"]
    moe = resolve("gpt2_small_moe8.pretrain")["model"]
    seq = 1024
    d, L, E = moe["n_embd"], moe["n_layer"], moe["num_experts"]
    router = 3 * L * 2 * d * E  # the router's products, forward and backward
    gap = flops.train_flops_per_token(moe, seq) - flops.train_flops_per_token(dense, seq)
    assert gap == router
    # Dense GPT-2 small: 6 x (85.0M weight-product params + the 38.6M tied head)
    # plus causal attention, about 0.80 GFLOP a token.
    assert 0.79e9 < flops.train_flops_per_token(dense, seq) < 0.81e9


def test_attention_bounds_at_the_main_path_shape():
    b = flops.attention_bounds(16 * 12, 1024, 64)
    assert abs(b["fwd"]["flops"] / 1e9 - 25.8) < 0.1
    assert abs(b["bwd"]["flops"] / 1e9 - 64.4) < 0.1
    assert b["fwd"]["bound"] == "bytes" and b["bwd"]["bound"] == "operations"
    assert abs(b["fwd"]["ms"] - 0.0303) < 5e-4 and abs(b["bwd"]["ms"] - 0.0652) < 5e-4
