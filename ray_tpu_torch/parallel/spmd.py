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
- Context: each rank holds a contiguous slice of every sequence (its
  ``seq_offset``); attention crosses the slices (``ring_attention.py``), and
  the context axis joins the batch axes in the loss mean and the ``Partial``
  gradients.
- Pipeline: each rank holds its stage's layers and runs them on microbatches
  (``pipeline.py``); activations and their gradients move between stages by
  ``ppermute``. A weight replicated over ``pipeline`` (embedding, head, final
  norm) is used by one stage, and its gradient is ``Partial`` over
  ``pipeline``: zero on the stages that do not use it.

DTensor's own sharding propagation is not used for the forward: on nano
GPT over ``{data 2, tensor 2}`` it raises while redistributing the
vocab-sharded embedding's ``MaskPartial`` output (torch 2.11), and an eager
op on DTensors pays its dispatch on the host per op
(``tools/port_dtensor_probe.py`` measures both).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.basic import HeadF32, causal_lm_loss, fold_seed
from ray_tpu_torch.parallel.mesh import AXIS_ORDER, axis_sizes, check_mesh

BATCH_AXES = ("data", "fsdp")
# Axes whose ranks hold different tokens: a weight replicated over one of them
# takes the sum of the ranks' gradients.
TOKEN_AXES = BATCH_AXES + ("context",)


# --------------------------------------------------------------------------- point to point
def _staged(group, t) -> bool:
    """gloo takes CUDA tensors in all-reduce but not in send/recv or
    all-to-all: over gloo those stage through the host."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


class P2P:
    """One batch of matched sends and receives over ``group`` (peers as group
    ranks), started at once through ``batch_isend_irecv``. ``wait()``
    returns the received tensors, shaped and typed like their templates.
    Over gloo the exchange completes before the constructor returns."""

    def __init__(self, sends: Sequence[Tuple[torch.Tensor, int]],
                 recvs: Sequence[Tuple[torch.Tensor, int]], group):
        self.device = next((t.device for t, _ in [*sends, *recvs]), None)
        staged = bool(sends or recvs) and _staged(group, [*sends, *recvs][0][0])
        move = (lambda t: t.detach().cpu()) if staged else (lambda t: t.detach().contiguous())
        self.bufs = [torch.empty(t.shape, dtype=t.dtype, device="cpu" if staged else t.device)
                     for t, _ in recvs]
        self.sent = [move(t) for t, _ in sends]  # alive until the sends complete
        ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer), group)
               for t, (_, peer) in zip(self.sent, sends)]
        ops += [dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer), group)
                for buf, (_, peer) in zip(self.bufs, recvs)]
        self.works = dist.batch_isend_irecv(ops) if ops else []
        self.staged = staged
        if staged:
            self._finish()

    def _finish(self):
        for w in self.works:
            w.wait()
        self.works, self.sent = [], []

    def wait(self) -> List[torch.Tensor]:
        self._finish()
        if self.staged:
            return [b.to(self.device) for b in self.bufs]
        return self.bufs


def _permute(x, perm, group):
    """``x`` sent along ``perm`` ((source, destination) group ranks): what
    this rank receives, zeros where no source sends to it."""
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    got = P2P([(x, dst[0])] if dst else [], [(x, src[0])] if src else [], group).wait()
    return got[0] if src else torch.zeros_like(x)


class _PPermute(torch.autograd.Function):
    """``lax.ppermute``: forward sends along ``perm``; backward sends the
    gradient along the inverse permutation."""

    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _permute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        return _permute(g.contiguous(), [(d, s) for s, d in ctx.perm], ctx.group), None, None


def ppermute(x, perm, group):
    """Each rank's ``x`` sent to its destination in ``perm``, a list of
    (source, destination) ranks of ``group``; a rank no source sends to gets
    zeros. Differentiable: the gradient goes back along the inverse
    permutation. Works over NCCL and gloo (CUDA tensors through the host)."""
    return _PPermute.apply(x, list(perm), group)


def _all_to_all(x, split_dim, concat_dim, group):
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, split_dim)).contiguous()
    if _staged(group, x):
        recv = torch.empty_like(send, device="cpu")
        dist.all_to_all_single(recv, send.cpu(), group=group)
        recv = recv.to(x.device)
    else:
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, concat_dim, split_dim, ctx.group), None, None, None


def all_to_all(x, split_dim: int, concat_dim: int, group):
    """``lax.all_to_all(..., tiled=True)``: ``x`` split in n along
    ``split_dim``, piece i to rank i of ``group``, the pieces received
    concatenated along ``concat_dim`` in rank order. Differentiable."""
    return _AllToAll.apply(x, split_dim, concat_dim, group)


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
        self.pp = self.sizes["pipeline"]
        self.cp = self.sizes["context"]
        self.tp_rank, self.tp_group = self._coord("tensor")
        self.pp_rank, self.pp_group = self._coord("pipeline")
        self.cp_rank, self.cp_group = self._coord("context")
        self.fsdp_group = self._coord("fsdp")[1]
        self.batch_groups = [mesh.get_group(a) for a in BATCH_AXES if self.sizes[a] > 1]
        self.batch_shards = self.sizes["data"] * self.fsdp
        self.batch_index = (mesh.get_local_rank("data") * self.fsdp
                            + (mesh.get_local_rank("fsdp") if self.fsdp > 1 else 0))
        # The loss is a mean over every token: over the batch shards and the
        # context slices of each sequence.
        self.token_groups = self.batch_groups + ([self.cp_group] if self.cp > 1 else [])
        self.token_shards = self.batch_shards * self.cp
        self.fsdp_dims: Dict[str, Optional[int]] = {}

    def _coord(self, axis):
        """This rank's index on ``axis`` and its group (0 and None on an axis of 1)."""
        if self.sizes[axis] == 1:
            return 0, None
        return self.mesh.get_local_rank(axis), self.mesh.get_group(axis)

    @property
    def first_stage(self) -> bool:
        return self.pp_rank == 0

    @property
    def last_stage(self) -> bool:
        return self.pp_rank == self.pp - 1

    def seq_offset(self, s_local: int) -> int:
        """The global position of this rank's first token (its context slice)."""
        return self.cp_rank * s_local

    # ------------------------------------------------------------------ DTensor <-> local
    def local(self, tree, prefix: str = "", layered: bool = False):
        """The local shards of a tree of DTensors (plain tensors pass through),
        differentiable: each gradient returns as a DTensor with
        ``grad_placements``. Records each leaf's ``fsdp`` dim under its name
        (a ``blocks`` leaf's per layer, after its leading layer dim)."""
        from torch.distributed.tensor import DTensor

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
        return tree.to_local(grad_placements=self.grad_placements(tree))

    def grad_placements(self, param) -> List:
        """The placements of ``param``'s gradient as this rank computes it:
        ``Partial`` over each axis of ranks that hold other tokens (batch,
        context) or run another stage (pipeline) where ``param`` is
        replicated, the param's own placement elsewhere."""
        from torch.distributed.tensor import Partial

        return [Partial() if (AXIS_ORDER[i] in TOKEN_AXES + ("pipeline",) and pl.is_replicate()
                              and self.sizes[AXIS_ORDER[i]] > 1) else pl
                for i, pl in enumerate(param.placements)]

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

    def token_ce(self, logits, targets, vocab: int):
        """The mean cross entropy of this rank's tokens from its logits
        (B_local, S, V_local) f32, the vocab split across the tensor group."""
        if logits.shape[-1] == vocab:
            return causal_lm_loss(logits, targets)
        start = self.tp_rank * logits.shape[-1]
        per_token = _VocabParallelCE.apply(logits.reshape(-1, logits.shape[-1]),
                                           targets.reshape(-1), start, self.tp_group)
        return per_token.mean()

    def lm_loss(self, logits, targets, vocab: int):
        """The global mean cross entropy from this rank's logits: each rank's
        mean over its tokens, summed across the batch and context groups over
        the number of those shards."""
        return self.batch_mean(self.token_ce(logits, targets, vocab))

    def batch_mean(self, x):
        """The mean over token shards (batch shards and context slices) of a
        per-shard mean (an all-reduce whose backward is the identity: each
        rank differentiates its own term)."""
        if self.token_shards == 1:
            return x
        return _ReduceFromGroups.apply(x / self.token_shards, *self.token_groups)

    def stage_sum(self, x):
        """The sum over the pipeline group (the last stage's value where the
        other stages pass zeros); backward: the identity on every stage."""
        return x if self.pp == 1 else _ReduceFromGroups.apply(x, self.pp_group)

    def global_batch(self, x, vocab: Optional[int] = None):
        """This rank's output (batch first) as a DTensor over the mesh: batch
        over (data, fsdp), the sequence (dim 1 of a 3-D output) over context,
        and the last dim over tensor where it is a vocab split
        (``x.shape[-1] < vocab``)."""
        from torch.distributed.tensor import DTensor

        from ray_tpu_torch.parallel.mesh import spec_placements

        split = vocab is not None and x.shape[-1] < vocab
        spec = [("data", "fsdp"), *[None] * (x.dim() - 2), "tensor" if split else None]
        shape = [x.shape[0] * self.batch_shards, *x.shape[1:-1], vocab if split else x.shape[-1]]
        if x.dim() == 3 and self.cp > 1:
            spec[1] = "context"
            shape[1] *= self.cp
        shape = torch.Size(shape)
        return DTensor.from_local(x, self.mesh, spec_placements(spec), run_check=False,
                                  shape=shape, stride=torch.empty(shape, device="meta").stride())


def spmd_for(mesh) -> Optional[SPMD]:
    return None if mesh is None else SPMD(mesh)


def fold_batch_index(seed: Optional[int], spmd: Optional[SPMD]) -> Optional[int]:
    """A dropout seed of its own for each token shard (batch shard and
    context slice; equal across the tensor group, whose activations are
    replicated where dropout applies)."""
    if seed is None or spmd is None or spmd.token_shards == 1:
        return seed
    return fold_seed(seed, spmd.batch_index * spmd.cp + spmd.cp_rank)


__all__ = ["P2P", "SPMD", "all_to_all", "fold_batch_index", "ppermute", "spmd_for"]
