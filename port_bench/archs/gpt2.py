"""GPT-2, dense or with a Switch top-1 MoE in every block
(``configs/gpt2_small.json``, ``configs/gpt2_small_moe8.json``): the port's
``GPTConfig``, the benchmark's seeded tree, the check's units, the model
FLOPs and the attention shapes.

The tree has the port's leaf names and shapes (``ray_tpu_torch/models/
gpt.py``: per-layer leaves stacked on a leading ``(L, ...)`` dim under
``"blocks"``, a Switch MoE's under ``"blocks"]["moe"]``). Drawn on ``device``
with one ``torch.Generator`` there, one call a leaf, in GPT-2's convention:
normal(0.02), the two residual products at 0.02 / sqrt(2 L), biases 0 and
layer-norm scales 1. The same seed gives the same tree on the same device
type.
"""

from __future__ import annotations

import math

import torch

from port_bench.weights import leaves

HALF_BATCH = ("ray_tpu_torch.models.gpt", "loss_fn")


def port_config(model):
    """The port's ``GPTConfig`` for a configuration file's sizes."""
    from ray_tpu_torch.models import GPTConfig

    assumed = model["assumed"]
    return GPTConfig(
        vocab_size=model["vocab_size"], n_layer=model["n_layer"], n_head=model["n_head"],
        d_model=model["n_embd"], d_ff=model.get("n_inner") or 0,
        max_seq_len=model["n_positions"], dtype=getattr(torch, assumed["compute_dtype"]),
        param_dtype=getattr(torch, assumed["param_dtype"]), remat=True,
        remat_policy=assumed["remat_policy"], attention="auto", dropout=model["resid_pdrop"],
        moe_experts=model.get("num_experts") or 0,
        moe_capacity_factor=model.get("expert_capacity_factor", 1.25),
        moe_aux_weight=model.get("router_aux_loss_coef", 0.01))


def dims(model):
    d, nh = model["n_embd"], model["n_head"]
    return {"d": d, "L": model["n_layer"], "V": model["vocab_size"], "nh": nh, "hd": d // nh,
            "F": model.get("n_inner") or 4 * d, "E": model.get("num_experts") or 0,
            "P": model["n_positions"]}


def init_params(model, seed, device, dtype=torch.float32):
    n = dims(model)
    d, L, V, nh, hd, F, E = n["d"], n["L"], n["V"], n["nh"], n["hd"], n["F"], n["E"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    std, proj_std = 0.02, 0.02 / math.sqrt(2 * L)

    def normal(shape, s):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(s)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    blocks = {
        "ln1_scale": ones(L, d), "ln1_bias": zeros(L, d),
        "qkv_w": normal((L, d, 3, nh, hd), std), "qkv_b": zeros(L, 3, nh, hd),
        "out_w": normal((L, nh, hd, d), proj_std), "out_b": zeros(L, d),
        "ln2_scale": ones(L, d), "ln2_bias": zeros(L, d),
    }
    if E:
        blocks["moe"] = {
            "router_w": normal((L, d, E), std),
            "fc_w": normal((L, E, d, F), std), "fc_b": zeros(L, E, F),
            "proj_w": normal((L, E, F, d), proj_std), "proj_b": zeros(L, E, d),
        }
    else:
        blocks.update({"fc_w": normal((L, d, F), std), "fc_b": zeros(L, F),
                       "proj_w": normal((L, F, d), proj_std), "proj_b": zeros(L, d)})
    return {"wte": normal((V, d), std), "wpe": normal((n["P"], d), std), "blocks": blocks,
            "lnf_scale": ones(d), "lnf_bias": zeros(d)}


def units(tree):
    """Every leaf, except that the fused q, k, v leaves (``qkv_w`` (L, d, 3,
    nh, hd) and ``qkv_b`` (L, 3, nh, hd)) are split into their three parts,
    as GPT-2's c_attn is three products in one matrix. A DTensor contributes
    its local shard, which is the whole leaf on a data axis."""
    out = {}
    for name, t in leaves(tree):
        t = t.to_local() if hasattr(t, "to_local") else t
        if name.endswith(("qkv_w", "qkv_b")):
            axis = 2 if name.endswith("qkv_w") else 1
            for part, piece in zip("qkv", t.unbind(axis)):
                out[f"{name}.{part}"] = piece
        else:
            out[name] = t
    return out


def forward_flops_per_token(model, seq):
    """Multiply-add operations (2 each) of one token's forward pass, averaged
    over the positions of a causal sequence of ``seq``: the weight products
    of the active parameters (q, k, v, out, the MLP or the router and the one
    expert top-1 routing picks, the tied head), and attention's two products
    over the (i + 1) keys position i sees. Layer norms, biases, the softmax and
    the optimizer are not counted, as model FLOPs leave them out. It replaces
    ``ray_tpu_torch.models.gpt.train_flops_per_token``, which counts every
    expert of a MoE layer where top-1 routing computes one."""
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


def attention_calls(model, traffic):
    """One causal call a layer on (rows * heads, seq, d / heads) for q, k
    and v alike."""
    nh = model["n_head"]
    hd = model["n_embd"] // nh
    return [(traffic["rows_per_gpu"] * nh, traffic["seq"], hd, hd, model["n_layer"])]
