"""Transformer-stack scaffolding: the counterpart of ``ray_tpu/models/stack.py``.

A model supplies ``make_block_fn(attention_fn, mb_idx, seq_streams)``, which
returns ``block_fn(x, layer_params, idx) -> (x, aux)`` (``idx`` the global
layer index; remat already applied); this module runs it over the stacked
per-layer params as a Python loop (the counterpart of ``lax.scan``) and sums
the blocks' ``aux`` (MoE's load-balancing loss; None from a block that has
none) as the JAX stack does. ``remat`` wraps a block in activation
checkpointing under one of the JAX package's remat policies. On a mesh the
blocks run on this rank's shards (``parallel/spmd.py``): with ``pipeline >
1`` as a GPipe over microbatches (``parallel/pipeline.py``), and with
``context > 1`` with the ring (``parallel/ring_attention.py``) as their
attention unless the caller passes its own, which is what XLA's partitioner
gives the JAX package's stack on a context-sharded sequence.
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

from ray_tpu_torch.ops.basic import causal_lm_loss  # noqa: F401  (the reference's path)
from ray_tpu_torch.ops.flash_attention import flash_attention, xla_attention


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
    blocks: Dict[str, Any],  # stacked per-layer params, leading dim n_layer (L/P on a stage)
    x,  # (B, S, D)
    make_block_fn: Callable,  # (attention_fn, mb_idx, seq_streams) -> block_fn
    *,
    n_layer: int,
    attention_fn: Optional[Callable] = None,
    spmd=None,
    num_microbatches: Optional[int] = None,
    seq_streams: tuple = (),
):
    """Run the blocks over the layers in order; returns ``(x, aux_sum)``,
    ``aux_sum`` an f32 scalar. On a mesh (``spmd``), ``blocks`` and ``x`` are
    this rank's shards; with a pipeline, ``x`` and the result are those of
    ``pipeline_apply`` (the stage's input, and the last stage's output or a
    0-dim zero), and ``aux_sum`` is already averaged over the microbatches.
    ``seq_streams`` are per-position tensors (leading dim S, RoPE's tables)
    handed to every block, already sliced to this rank's positions."""
    attn = attention_fn
    if attn is None and spmd is not None and spmd.cp > 1:
        from ray_tpu_torch.parallel.ring_attention import ring_attention

        attn = functools.partial(ring_attention, group=spmd.cp_group)
    if spmd is not None and spmd.pp > 1:
        from ray_tpu_torch.parallel.pipeline import pipeline_apply

        n_local = n_layer // spmd.pp
        if n_local * spmd.pp != n_layer:
            raise ValueError(f"n_layer={n_layer} not divisible by pipeline={spmd.pp}")
        first = spmd.pp_rank * n_local

        def stack_fn(stage, xm, mb_idx, streams):
            block_fn = make_block_fn(attn, mb_idx, streams)
            return _run_layers(stage, xm, block_fn, n_local, first)

        return pipeline_apply(spmd, blocks, x, stack_fn, num_microbatches, seq_streams)
    return _run_layers(blocks, x, make_block_fn(attn, None, seq_streams), n_layer, 0)


def _run_layers(blocks, x, block_fn, n_layer: int, first: int):
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(unstack_layers(blocks, n_layer)):
        x, aux = block_fn(x, layer, first + i)
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

