"""GPipe over the ``pipeline`` mesh axis: the counterpart of
``ray_tpu/parallel/pipeline.py``.

- Layer stacks are sharded over ``pipeline`` on their leading dim, so each
  stage holds only L/P layers (``ShardingRules``: "layers" -> pipeline).
- The schedule is written out, as ``spmd.py`` writes out the collectives: M
  microbatches through P stages in M + P - 1 ticks. At tick t stage p runs
  microbatch t - p where 0 <= t - p < M; stage 0 injects its microbatches
  and every stage passes its output on by ``ppermute`` to the next. A tick
  without a microbatch (the bubble, (P - 1) / (M + P - 1) of the ticks) skips
  its compute and its send: eager PyTorch needs no uniform control flow, and
  the result is the one the reference's masked garbage gives.
- The backward is explicit: the ticks in reverse, each stage's gradient of
  its input sent back by ``ppermute`` along the inverse pairs, each
  microbatch differentiated by ``torch.autograd.grad`` on the graph its
  forward kept. Every rank runs the same sequence of exchanges, so the sends
  always meet their receives.
- The stage's aux (MoE's load-balancing loss) counts real ticks only, is
  summed over stages (and batch shards) and divided by M.
- A batch shard splits its rows into M / (batch shards) microbatches, so a
  microbatch is the reference's: the rows [m B / M, (m + 1) B / M) of the
  global batch.
- Under context parallelism the stage runs on this rank's slice of every
  sequence, its attention the ring over the context group (``apply_stack``
  picks it), and ``seq_streams`` (Llama's RoPE tables) arrive already sliced
  to this rank's positions. Eager ranks always hold their own slice, so the
  reference's ``context_manual`` has no counterpart.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.spmd import _ReduceFromGroups, _permute


def default_microbatches(batch: int, num_stages: int) -> int:
    """The reference's M (``ray_tpu/models/stack.py:63``): 2P if it divides
    the batch, else P."""
    return 2 * num_stages if batch % (2 * num_stages) == 0 else num_stages


def microbatches(spmd, rows: int, num_microbatches: Optional[int] = None):
    """(M, microbatches per batch shard) for a batch shard of ``rows`` rows:
    M the caller's, else the default over the global batch. Raises
    ``ValueError`` where M does not split over the batch shards or a shard's
    rows over its microbatches."""
    m = num_microbatches or default_microbatches(rows * spmd.batch_shards, spmd.pp)
    if m % spmd.batch_shards:
        raise ValueError(f"num_microbatches={m} does not split over {spmd.batch_shards} "
                         "batch shards")
    local = m // spmd.batch_shards
    if rows % local:
        raise ValueError(f"{local} microbatches per batch shard do not divide its {rows} rows")
    return m, local


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flatten(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _unflatten(pairs) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for name, leaf in pairs:
        node = root
        *parents, last = name.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return root


def _pairs(t: int, num_stages: int, m: int):
    """The (stage, stage + 1) sends of tick t: those of a real microbatch."""
    return [(i, i + 1) for i in range(num_stages - 1) if 0 <= t - i < m]


def _exchange(x: Optional[torch.Tensor], like: torch.Tensor, pairs, group):
    """``ppermute`` of one tick: ``x`` (None where this rank sends nothing)
    along ``pairs``; what this rank receives, or None."""
    me = dist.get_rank(group)
    if not any(me in p for p in pairs):
        return None
    got = _permute(like if x is None else x, pairs, group)
    return got if any(d == me for _, d in pairs) else None


class _GPipe(torch.autograd.Function):
    """The schedule: forward over the ticks, backward over them in reverse.
    Outputs the last stage's activations ((B, S, D); a 0-dim zero on other
    stages, through which their backward is reached) and the stage's aux
    summed over its microbatches."""

    @staticmethod
    def forward(ctx, sched, x, *leaves):
        p, n, m, group = sched.stage, sched.num_stages, sched.m, sched.group
        params = [leaf.detach().requires_grad_(leaf.requires_grad) for leaf in leaves]
        tree = _unflatten(zip(sched.names, params))
        inject = x.chunk(m) if p == 0 else None
        like = x.new_empty((x.shape[0] // m, *x.shape[1:]))
        kept: List = [None] * m
        buf = None
        for t in range(m + n - 1):
            mb = t - p
            y = None
            if 0 <= mb < m:
                x_in = (inject[mb] if p == 0 else buf).detach()
                x_in.requires_grad_(p > 0 or x.requires_grad)
                with torch.set_grad_enabled(sched.grad):  # each microbatch keeps its graph
                    y, aux = sched.stack_fn(tree, x_in, mb, sched.seq_streams)
                kept[mb] = (x_in, y, aux)
            buf = _exchange(None if y is None else y.detach(), like, _pairs(t, n, m), group)
        ctx.sched, ctx.kept, ctx.params, ctx.like = sched, kept, params, like
        ctx.x_grad = x.requires_grad
        aux_sum = torch.stack([a.detach().float() for _, _, a in kept]).sum()
        if p == n - 1:
            out = torch.cat([y.detach() for _, y, _ in kept])
        else:
            out = torch.zeros((), dtype=torch.float32, device=x.device)  # the loss's dtype
        return out, aux_sum

    @staticmethod
    def backward(ctx, g_out, g_aux):
        sched, kept, params = ctx.sched, ctx.kept, ctx.params
        p, n, m, group = sched.stage, sched.num_stages, sched.m, sched.group
        g_mbs = g_out.chunk(m) if p == n - 1 else None
        grads: List[Optional[torch.Tensor]] = [None] * len(params)
        gx: List = [None] * m
        back = None
        for t in reversed(range(m + n - 1)):
            inverse = [(d, s) for s, d in _pairs(t, n, m)]
            g_recv = _exchange(back, ctx.like, inverse, group)
            back = None
            mb = t - p
            if not 0 <= mb < m:
                continue
            x_in, y, aux = kept[mb]
            kept[mb] = None
            outs, gouts = [y], [g_mbs[mb] if p == n - 1 else g_recv]
            if aux.requires_grad:
                outs.append(aux)
                gouts.append(g_aux)
            inputs = [x_in] if x_in.requires_grad else []
            wanted = [i for i, w in enumerate(params) if w.requires_grad]
            res = torch.autograd.grad(outs, inputs + [params[i] for i in wanted], gouts,
                                      allow_unused=True)
            if inputs:
                if p > 0:
                    back = res[0]
                else:
                    gx[mb] = res[0]
            for i, g in zip(wanted, res[len(inputs):]):
                if g is not None:  # summed in place: one stage's gradients at a time
                    grads[i] = g if grads[i] is None else grads[i].add_(g)
        g_x = torch.cat(gx) if p == 0 and ctx.x_grad else None
        return (None, g_x, *grads)


class _Schedule:
    def __init__(self, spmd, names, stack_fn, m, seq_streams):
        self.group, self.stage, self.num_stages = spmd.pp_group, spmd.pp_rank, spmd.pp
        self.names, self.stack_fn, self.m, self.seq_streams = names, stack_fn, m, seq_streams
        self.grad = torch.is_grad_enabled()  # off: an evaluation forward keeps no graphs


def pipeline_apply(spmd, stage_params: Dict[str, Any], x, block_stack_fn: Callable,
                   num_microbatches: Optional[int] = None, seq_streams: tuple = ()):
    """Run ``block_stack_fn(stage_params, x_mb, mb_idx, seq_streams) -> (y_mb,
    aux)`` as a ``spmd.pp``-stage GPipe over microbatches of ``x``.

    Args:
      spmd: the forward's ``SPMD`` (its pipeline group and this rank's stage).
      stage_params: this stage's layer stack (leading dim L/P), local shards.
      x: (B_local, S_local, D) activations: the embedded tokens on stage 0;
        on other stages only its shape and dtype are read.
      num_microbatches: M over the global batch (None: 2P if it divides the
        batch, else P); the batch shards (``spmd.batch_shards``) must divide
        it, and each shard's rows must split into M / batch_shards
        microbatches.
      seq_streams: per-position tensors (leading dim S_local) passed to every
        microbatch.

    Returns (y, aux): y the (B_local, S_local, D) activations after all L
    layers on the last stage, a 0-dim f32 zero on the other stages (feed it
    to ``spmd.stage_sum`` with the loss, so their backward runs); aux the
    microbatches' aux summed over stages and batch shards, divided by M, the
    same on every rank.
    """
    num_microbatches, m = microbatches(spmd, x.shape[0], num_microbatches)
    # NCCL wants a group's first call to involve all its ranks; tick 0's
    # send involves two. One all-reduce opens the group.
    dist.all_reduce(torch.zeros(1, device=x.device), group=spmd.pp_group)
    names, leaves = zip(*_flatten(stage_params))
    sched = _Schedule(spmd, names, block_stack_fn, m, seq_streams)
    y, aux = _GPipe.apply(sched, x, *leaves)
    aux = _ReduceFromGroups.apply(aux, spmd.pp_group, *spmd.batch_groups) / num_microbatches
    return y, aux


def to_stages(blocks, num_stages: int):
    """Stacked layer params (L, ...) -> (num_stages, L // num_stages, ...)."""
    if isinstance(blocks, dict):
        return {k: to_stages(v, num_stages) for k, v in blocks.items()}
    layers = blocks.shape[0]
    if layers % num_stages:
        raise ValueError(f"n_layer={layers} not divisible by pipeline={num_stages}")
    return blocks.reshape(num_stages, layers // num_stages, *blocks.shape[1:])


__all__ = ["default_microbatches", "microbatches", "pipeline_apply", "to_stages"]
