"""Transformer-stack scaffolding: the counterpart of ``ray_tpu/models/stack.py``.

A model supplies ``block_fn(x, layer_params, idx) -> (x, aux)``; this module
runs it over the stacked per-layer params as a Python loop (the counterpart of
``lax.scan``) and sums the blocks' ``aux`` (MoE's load-balancing loss; None
from a block that has none) as the JAX stack does. ``remat`` wraps a block in
activation checkpointing under one of the JAX package's remat policies. On a
mesh the blocks run on this rank's shards (``parallel/spmd.py``); a mesh with
pipeline, context or expert parallelism raises (ROADMAP.md Queue 1 item 3).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch.ops.flash_attention import flash_attention, xla_attention
from ray_tpu_torch.parallel.mesh import check_mesh


def unstack_layers(blocks: Dict[str, Any], n_layer: int) -> list:
    """Stacked (L, ...) leaves, nested dicts included (MoE's ``blocks["moe"]``)
    -> a list of L per-layer trees of views. One ``unbind`` per leaf, so the
    backward stacks each leaf's gradient once."""

    def unbind(name, leaf):
        if isinstance(leaf, dict):
            return {k: unbind(f"{name}.{k}", v) for k, v in leaf.items()}
        if leaf.shape[0] != n_layer:
            raise ValueError(f"{name}: leading dim {leaf.shape[0]} != n_layer {n_layer}")
        return leaf.unbind(0)

    def pick(views, i):
        if isinstance(views, dict):
            return {k: pick(v, i) for k, v in views.items()}
        return views[i]

    per_leaf = {name: unbind(name, leaf) for name, leaf in blocks.items()}
    return [pick(per_leaf, i) for i in range(n_layer)]


def apply_stack(
    blocks: Dict[str, Any],  # stacked per-layer params, leading dim n_layer
    x,  # (B, S, D)
    block_fn: Callable,  # (x, layer_params, idx) -> (x, aux), remat already applied
    *,
    n_layer: int,
    mesh=None,
):
    """Run ``block_fn`` over the layers in order; returns ``(x, aux_sum)``,
    ``aux_sum`` an f32 scalar. On a mesh, ``blocks`` and ``x`` are this rank's
    shards."""
    check_mesh(mesh)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for idx, layer in enumerate(unstack_layers(blocks, n_layer)):
        x, aux = block_fn(x, layer, idx)
        if aux is not None:
            aux_sum = aux_sum + aux
    return x, aux_sum


# The weight products: a matmul with no batch dimension lowers to these.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep the
    outputs of products without batch dims (the weight products; the batched
    ones lower to ``bmm``), recompute everything else, the attention kernel
    included."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn: Callable, policy: Optional[str] = None) -> Callable:
    """``fn`` under activation checkpointing: ``policy=None`` recomputes all of
    it in the backward, ``"dots"`` saves its weight products' outputs."""
    if policy not in (None, "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)

    @functools.wraps(fn)
    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


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

