"""Transformer-stack scaffolding: the counterpart of ``ray_tpu/models/stack.py``.

A model supplies ``block_fn(x, layer_params, idx) -> x``; this module runs it
over the stacked per-layer params as a Python loop (the counterpart of
``lax.scan``), on one device. Pipeline and context parallelism are not ported
yet (ROADMAP.md Queue 1 item 3).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ray_tpu_torch.ops.flash_attention import flash_attention, xla_attention


def check_single_device(mesh) -> None:
    """The port runs on one device: a mesh (a torch ``DeviceMesh``) of more
    than one raises."""
    if mesh is not None and mesh.size() > 1:
        raise NotImplementedError(
            "multi-device meshes (data/FSDP/tensor/pipeline/context parallelism) are "
            "not ported yet: ROADMAP.md Queue 1 item 3"
        )


def unstack_layers(blocks: Dict[str, Any], n_layer: int) -> list:
    """Stacked (L, ...) leaves -> a list of L per-layer dicts of views. One
    ``unbind`` per leaf, so the backward stacks each leaf's gradient once."""
    per_leaf = {}
    for name, leaf in blocks.items():
        if leaf.shape[0] != n_layer:
            raise ValueError(f"{name}: leading dim {leaf.shape[0]} != n_layer {n_layer}")
        per_leaf[name] = leaf.unbind(0)
    return [{name: views[i] for name, views in per_leaf.items()} for i in range(n_layer)]


def apply_stack(
    blocks: Dict[str, Any],  # stacked per-layer params, leading dim n_layer
    x,  # (B, S, D)
    block_fn: Callable,  # (x, layer_params, idx) -> x, remat already applied
    *,
    n_layer: int,
    mesh=None,
):
    """Run ``block_fn`` over the layers in order; returns the activations."""
    check_single_device(mesh)
    for idx, layer in enumerate(unstack_layers(blocks, n_layer)):
        x = block_fn(x, layer, idx)
    return x


def resolve_attention(q, k, v, attention_mode: str, attention_fn: Optional[Callable]):
    """One attention dispatch for every model family: a caller-injected fn
    wins, else the flash kernels ("auto" and "flash") or plain attention ("xla")."""
    if attention_fn is not None:
        return attention_fn(q, k, v)
    if attention_mode in ("auto", "flash"):
        return flash_attention(q, k, v, causal=True)
    if attention_mode == "xla":
        return xla_attention(q, k, v, causal=True)
    raise ValueError(f"unknown attention mode {attention_mode!r}")


def causal_lm_loss(logits, targets):
    """Cross entropy as logsumexp - logit[target], mean over tokens."""
    lse = torch.logsumexp(logits, dim=-1)
    at_target = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (lse - at_target).mean()
