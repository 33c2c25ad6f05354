"""The benchmark's own model parameters, made from the seed.

The tree has the port's leaf names and shapes (``ray_tpu_torch/models/
gpt.py``: per-layer leaves stacked on a leading ``(L, ...)`` dim under
``"blocks"``, a Switch MoE's under ``"blocks"]["moe"]``), so the port takes
it as its ``TrainState.params`` and the reference reads the same values.
Drawn on ``device`` with one ``torch.Generator`` there, one call a leaf, in
GPT-2's convention: normal(0.02), the two residual products at 0.02 /
sqrt(2 L), biases 0 and layer-norm scales 1. The same seed gives the same
tree on the same device type.
"""

from __future__ import annotations

import math

import torch


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


def leaves(tree, prefix=""):
    """(dotted name, tensor) of every leaf of nested dicts, in order."""
    out = []
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out += leaves(v, name + ".") if isinstance(v, dict) else [(name, v)]
    return out


def units(tree):
    """The pieces of a params-shaped tree that the check compares, by dotted
    name: every leaf, except that the fused q, k, v leaves (``qkv_w`` (L, d,
    3, nh, hd) and ``qkv_b`` (L, 3, nh, hd)) are split into their three
    parts, as GPT-2's c_attn is three products in one matrix. A DTensor
    contributes its local shard, which is the whole leaf on a data axis."""
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


def unit_norms(tree, scale=1.0):
    """The f32 Frobenius norm of each unit of ``tree``, times ``scale``."""
    u = units(tree)
    with torch.no_grad():
        norms = torch.stack([p.detach().float().norm() for p in u.values()]) * scale
    return dict(zip(u, norms.tolist()))


def delta_norms(after, before):
    """The norm of each unit of ``after - before``."""
    a, b = units(after), units(before)
    with torch.no_grad():
        norms = torch.stack([(a[k].detach().float() - b[k].float()).norm() for k in a])
    return dict(zip(a, norms.tolist()))
