"""The yardstick's arithmetic: the H100's peaks, a GPT-2 step's model FLOPs
and the attention kernels' least time.

Frozen: later changes to the program never edit this file. ``bound`` and
``attention_bounds`` are copies of ``chip_smoke.py``'s functions of the same
names (with the operation and byte counts returned beside the time).
``train_flops_per_token`` replaces ``ray_tpu_torch.models.gpt.
train_flops_per_token``, which counts every expert of a MoE layer where
top-1 routing computes one.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet, 700 W)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def bound(flops, nbytes):
    """The least time in ms of ``flops`` operations and ``nbytes`` bytes, and
    which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bounds(bh, seq, hd, elt=2):
    """The causal forward and backward kernels on (bh, seq, hd): for each, a
    dict of its operations, bytes, least ms and what bounds it. Products over
    the (query, key) pairs the causal mask keeps (forward 2, backward 5, each
    2 * hd operations a pair) at the bf16 peak, against each input read once
    and each output written once (forward q, k, v -> o and an f32 lse;
    backward q, k, v, do and f32 lse, delta -> dq, dk, dv) at the memory
    rate."""
    pairs = bh * seq * (seq + 1) / 2
    out = {}
    for name, products, tensors, f32_rows in (("fwd", 2, 4, 1), ("bwd", 5, 7, 2)):
        flops = products * 2 * hd * pairs
        nbytes = tensors * bh * seq * hd * elt + f32_rows * bh * seq * 4
        ms, what = bound(flops, nbytes)
        out[name] = {"flops": flops, "bytes": nbytes, "ms": ms, "bound": what}
    return out


def forward_flops_per_token(model, seq):
    """Multiply-add operations (2 each) of one token's forward pass, averaged
    over the positions of a causal sequence of ``seq``: the weight products
    of the active parameters (q, k, v, out, the MLP or the router and the one
    expert top-1 routing picks, the tied head), and attention's two products
    over the (i + 1) keys position i sees. Layer norms, biases, the softmax and
    the optimizer are not counted, as model FLOPs leave them out."""
    d, L, V = model["n_embd"], model["n_layer"], model["vocab_size"]
    ff = model.get("n_inner") or 4 * d
    experts = model.get("num_experts") or 0
    per_expert = model.get("num_experts_per_tok") or 1
    mlp = 2 * 2 * d * ff * (per_expert if experts else 1)
    if experts:
        mlp += 2 * d * experts  # the router
    weights = L * (2 * d * 3 * d + 2 * d * d + mlp) + 2 * d * V
    attention = L * 2 * 2 * d * (seq + 1) / 2
    return weights + attention


def train_flops_per_token(model, seq):
    """Forward and backward: three times the forward's products."""
    return 3 * forward_flops_per_token(model, seq)
