"""The local side of a mesh: what a model's forward needs to run on this
rank's shards.

The port keeps params, gradients, optimizer state and batches as DTensors
placed by ``ShardingRules`` (the counterpart of the JAX package's
``NamedSharding``s), and runs the forward and backward on their local
shards, with the collectives XLA's SPMD partitioner inserts in the JAX
package written out:

- FSDP: a weight sharded on ``fsdp`` is all-gathered where it is used, inside
  the remat region, so the backward gathers it again instead of keeping a
  replica per layer; the gather's backward is a reduce-scatter of its
  gradient (``gather``).
- Tensor parallelism, Megatron style: a column-parallel product (q, k, v; the
  MLP's first products; the LM head over a vocab shard) takes its input
  through ``copy_to_tp`` (identity forward, all-reduce of the gradient); a
  row-parallel product (the attention output and MLP down projections) sums
  its f32 partial products across the tensor group (``row_parallel``) before
  rounding, as one product over the whole contraction would. The embedding
  over a vocab shard looks up the tokens in its range and sums across the
  group; the loss takes the logsumexp across vocab shards (``lm_loss``).
- Data and FSDP: each rank's loss covers its batch shard; ``lm_loss``
  returns the global mean (an all-reduce whose backward is the identity), and
  the gradients of weights replicated over a batch axis come back as
  ``Partial`` DTensors, which the train step reduces (``to_local``'s
  ``grad_placements``).

DTensor's own sharding propagation is not used for the forward: on nano
GPT over ``{data 2, tensor 2}`` it raises while redistributing the
vocab-sharded embedding's ``MaskPartial`` output (torch 2.11), and an eager
op on DTensors pays its dispatch on the host per op
(``tools/port_dtensor_probe.py`` measures both).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.basic import HeadF32, causal_lm_loss, fold_seed
from ray_tpu_torch.parallel.mesh import AXIS_ORDER, axis_sizes, check_mesh

BATCH_AXES = ("data", "fsdp")


class _GatherFSDP(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``; backward: reduce-scatter."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        buf = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(buf, x.contiguous(), group=group)
        if dim == 0:
            return buf
        return torch.cat(buf.chunk(n), dim=dim)

    @staticmethod
    def backward(ctx, g):
        parts = torch.cat(g.chunk(ctx.n, dim=ctx.dim)) if ctx.dim else g.contiguous()
        out = parts.new_empty((parts.shape[0] // ctx.n, *parts.shape[1:]))
        dist.reduce_scatter_tensor(out, parts, group=ctx.group)
        return out, None, None, None


class _CopyToGroup(torch.autograd.Function):
    """Identity; backward: all-reduce of the gradient over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroups(torch.autograd.Function):
    """All-reduce (sum) over each of ``groups``; backward: identity."""

    @staticmethod
    def forward(ctx, x, *groups):
        y = x.clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g, *(None for _ in ctx.needs_input_grad[1:]))


class _VocabParallelCE(torch.autograd.Function):
    """Per-token cross entropy of logits (N, V_local) f32 whose vocab is split
    over ``group`` (this rank's ids start at ``start``), against global target
    ids (N,): logsumexp - logit[target], each summed across the group."""

    @staticmethod
    def forward(ctx, logits, targets, start, group):
        m = logits.amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[:, None])
        s = e.sum(-1)
        dist.all_reduce(s, group=group)
        local = targets.long() - start
        inside = (local >= 0) & (local < logits.shape[-1])
        idx = torch.where(inside, local, 0)
        at_target = torch.gather(logits, -1, idx[:, None])[:, 0] * inside
        dist.all_reduce(at_target, group=group)
        ctx.save_for_backward(e, s, idx, inside)
        return torch.log(s) + m - at_target

    @staticmethod
    def backward(ctx, g):
        e, s, idx, inside = ctx.saved_tensors
        grad = e / s[:, None]
        grad.scatter_add_(-1, idx[:, None], -inside[:, None].to(grad.dtype))
        return grad * g[:, None], None, None, None


class SPMD:
    """One forward's view of its mesh: axis sizes, this rank's coordinates,
    the process groups, and which dim of each param is sharded on ``fsdp``."""

    def __init__(self, mesh):
        check_mesh(mesh)
        self.mesh = mesh
        self.sizes = axis_sizes(mesh)
        self.tp = self.sizes["tensor"]
        self.fsdp = self.sizes["fsdp"]
        self.tp_rank = mesh.get_local_rank("tensor") if self.tp > 1 else 0
        self.tp_group = mesh.get_group("tensor") if self.tp > 1 else None
        self.fsdp_group = mesh.get_group("fsdp") if self.fsdp > 1 else None
        self.batch_groups = [mesh.get_group(a) for a in BATCH_AXES if self.sizes[a] > 1]
        self.batch_shards = self.sizes["data"] * self.fsdp
        self.batch_index = (mesh.get_local_rank("data") * self.fsdp
                            + (mesh.get_local_rank("fsdp") if self.fsdp > 1 else 0))
        self.fsdp_dims: Dict[str, Optional[int]] = {}

    # ------------------------------------------------------------------ DTensor <-> local
    def local(self, tree, prefix: str = "", layered: bool = False):
        """The local shards of a tree of DTensors (plain tensors pass through),
        differentiable: each gradient returns as a DTensor with the param's
        placements, ``Partial`` over a batch axis the param is replicated on.
        Records each leaf's ``fsdp`` dim under its name (a ``blocks`` leaf's
        per layer, after its leading layer dim)."""
        from torch.distributed.tensor import DTensor, Partial

        if isinstance(tree, dict):
            return {k: self.local(v, f"{prefix}{k}.", layered or k == "blocks")
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [self.local(v, f"{prefix}{i}.", layered) for i, v in enumerate(tree)]
        name = prefix[:-1].rsplit(".", 1)[-1] if layered else prefix[:-1]
        if not isinstance(tree, DTensor):
            self.fsdp_dims[name] = None
            return tree
        fsdp_mdim = AXIS_ORDER.index("fsdp")
        p = tree.placements[fsdp_mdim]
        self.fsdp_dims[name] = (p.dim - (1 if layered else 0)) if p.is_shard() else None
        grad_placements = [
            Partial() if (AXIS_ORDER[i] in BATCH_AXES and pl.is_replicate()
                          and self.sizes[AXIS_ORDER[i]] > 1) else pl
            for i, pl in enumerate(tree.placements)
        ]
        return tree.to_local(grad_placements=grad_placements)

    def batch_local(self, t):
        from torch.distributed.tensor import DTensor

        return t.to_local() if isinstance(t, DTensor) else t

    # ------------------------------------------------------------------ collectives in the forward
    def gather(self, w, name: str):
        """Weight ``name`` (a local shard) whole over ``fsdp``."""
        dim = self.fsdp_dims.get(name)
        if dim is None or self.fsdp == 1:
            return w
        return _GatherFSDP.apply(w, dim, self.fsdp_group, self.fsdp)

    def copy_to_tp(self, x, sharded: bool):
        return _CopyToGroup.apply(x, self.tp_group) if sharded else x

    def row_parallel(self, a, w, cdt):
        """``a @ w`` over a contraction split across the tensor group: f32
        partial products, summed across the group, rounded to ``cdt``."""
        lead = a.shape[:-1]
        a2 = a.reshape(-1, a.shape[-1])
        part = a2 @ w if a2.dtype == torch.float32 else HeadF32.apply(a2, w.t())
        return _ReduceFromGroups.apply(part, self.tp_group).to(cdt).view(*lead, w.shape[-1])

    def embed(self, tokens, table, vocab: int):
        """Rows of ``table`` (V_local, d) for ``tokens``; over a vocab shard,
        the rows in this rank's range summed across the tensor group."""
        import torch.nn.functional as F

        if table.shape[0] == vocab:
            return F.embedding(tokens, table)
        start = self.tp_rank * table.shape[0]
        local = tokens.long() - start
        inside = (local >= 0) & (local < table.shape[0])
        rows = F.embedding(torch.where(inside, local, 0), table) * inside[..., None].to(table.dtype)
        return _ReduceFromGroups.apply(rows, self.tp_group)

    def lm_loss(self, logits, targets, vocab: int):
        """The global mean cross entropy from this rank's logits (B_local, S,
        V_local) f32: each rank's mean over its tokens, summed across the
        batch axes' groups over the number of batch shards."""
        if logits.shape[-1] == vocab:
            loss = causal_lm_loss(logits, targets)
        else:
            start = self.tp_rank * logits.shape[-1]
            per_token = _VocabParallelCE.apply(logits.reshape(-1, logits.shape[-1]),
                                               targets.reshape(-1), start, self.tp_group)
            loss = per_token.mean()
        return self.batch_mean(loss)

    def batch_mean(self, x):
        """The mean over batch shards of a per-shard mean (an all-reduce whose
        backward is the identity: each rank differentiates its own term)."""
        if self.batch_shards == 1:
            return x
        return _ReduceFromGroups.apply(x / self.batch_shards, *self.batch_groups)

    def global_batch(self, x, vocab: Optional[int] = None):
        """This rank's output (batch first) as a DTensor over the mesh: batch
        over (data, fsdp), and the last dim over tensor where it is a vocab
        split (``x.shape[-1] < vocab``)."""
        from torch.distributed.tensor import DTensor

        from ray_tpu_torch.parallel.mesh import spec_placements

        split = vocab is not None and x.shape[-1] < vocab
        spec = [("data", "fsdp"), *[None] * (x.dim() - 2), "tensor" if split else None]
        shape = torch.Size([x.shape[0] * self.batch_shards, *x.shape[1:-1],
                            vocab if split else x.shape[-1]])
        return DTensor.from_local(x, self.mesh, spec_placements(spec), run_check=False,
                                  shape=shape, stride=torch.empty(shape, device="meta").stride())


def spmd_for(mesh) -> Optional[SPMD]:
    return None if mesh is None else SPMD(mesh)


def fold_batch_index(seed: Optional[int], spmd: Optional[SPMD]) -> Optional[int]:
    """A dropout seed of its own for each batch shard (equal across the
    tensor group, whose activations are replicated where dropout applies)."""
    if seed is None or spmd is None or spmd.batch_shards == 1:
        return seed
    return fold_seed(seed, spmd.batch_index)


__all__ = ["SPMD", "spmd_for", "fold_batch_index"]
