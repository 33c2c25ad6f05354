"""Train state and train step: the counterpart of ``ray_tpu/models/training.py``.

Eager PyTorch, on one device or over a mesh. Where the JAX step is a pure
function with donated state, this step updates the state's tensors in place
(params, Adam moments) and returns the same ``TrainState``: the memory the
JAX package saves by donation is saved here by never copying. The optimizer
is AdamW with global-norm clipping and an optional warmup-cosine schedule,
written out to match ``optax.chain(clip_by_global_norm, adamw)`` update for
update.

On a mesh (a ``DeviceMesh`` from ``MeshSpec.build``), params and Adam moments
are DTensors placed by ``ShardingRules`` (``param_shardings``), initialized
leaf by leaf so a model never exists whole on a rank (a pipeline stage holds
its L/P layers); the batch is a DTensor over (data, fsdp), its sequence over
context (``shard_batch``); the step runs the model on local shards
(``parallel/spmd.py``), reduces each gradient to its param's placements, and
updates each rank's shards, with the clipping norm taken over every shard.
A param a pipeline stage does not use (the embedding past stage 0, the head
before the last) gets a zero gradient there, ``Partial`` over ``pipeline``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.accelerators.gpu import resolve_device
from ray_tpu_torch.models import gpt, llama, resnet
from ray_tpu_torch.ops.basic import fold_seed
from ray_tpu_torch.parallel.mesh import ShardingRules, axis_sizes, batch_sharding, distribute
from ray_tpu_torch.parallel.spmd import spmd_for

_DROPOUT_BASE_SEED = 0x5EED


def model_for(config):
    """The model module of a config (gpt, llama, resnet), so one TrainState
    and step factory serves the whole zoo; a config of no known family is
    taken as GPT, as the JAX package does."""
    if isinstance(config, llama.LlamaConfig):
        return llama
    if isinstance(config, resnet.ResNetConfig):
        return resnet
    return gpt


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, list):
        return [tree]
    return [leaf for sub in tree for leaf in tree_leaves(sub)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``, which
    have its structure, as ``jax.tree.map`` does."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, *vs) for vs in zip(tree, *rest)]
    return fn(tree, *rest)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int


# --------------------------------------------------------------------------- optimizer
def warmup_cosine_lr(peak: float, warmup_steps: int, total_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps, total_steps)."""

    def lr(count: int) -> float:
        if count < warmup_steps:
            return peak * count / warmup_steps
        t = min(count - warmup_steps, total_steps - warmup_steps)
        return peak * 0.5 * (1 + math.cos(math.pi * t / (total_steps - warmup_steps)))

    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Global-norm clipping then AdamW with decay on every leaf, as
    ``optax.chain(clip_by_global_norm(grad_clip), adamw(lr, b1, b2,
    weight_decay=weight_decay))``. ``learning_rate`` is a float or a function
    of the update count, evaluated before the count is incremented. With
    ``grad_clip=None`` nothing is clipped, and with ``weight_decay=0`` it is
    ``optax.adam``."""

    learning_rate: Any = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    eps = 1e-8  # optax's default, as the JAX package leaves it

    def init(self, params) -> Dict[str, Any]:
        """Zero moments shaped (and, for DTensors, placed) like ``params``."""
        zeros = lambda p: torch.zeros_like(p, memory_format=torch.contiguous_format)  # noqa: E731
        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    @torch.no_grad()
    def update_(self, params, grads: List[torch.Tensor], opt_state) -> torch.Tensor:
        """Apply one update in place to ``params`` and ``opt_state``; ``grads``
        follow ``tree_leaves(params)``. Returns the global norm of ``grads``,
        taken before clipping. DTensors are updated through their local
        shards; their gradients must have the params' placements."""
        g_norm = global_norm(grads)
        leaves = [_local(p) for p in tree_leaves(params)]
        mus = [_local(m) for m in tree_leaves(opt_state["mu"])]
        nus = [_local(n) for n in tree_leaves(opt_state["nu"])]
        grads = [_local(g) for g in grads]
        if self.grad_clip is not None:
            keep = g_norm < self.grad_clip
            grads = [torch.where(keep, g, (g / g_norm) * self.grad_clip) for g in grads]
        count = opt_state["count"] + 1
        bc1, bc2 = 1 - self.b1 ** count, 1 - self.b2 ** count
        step_size = -self.lr(opt_state["count"])
        for p, g, mu, nu in zip(leaves, grads, mus, nus):
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u * step_size)
        opt_state["count"] = count
        return g_norm


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _replication(t) -> int:
    """How many ranks hold the same values of a DTensor's local shard."""
    n = 1
    for size, p in zip(t.device_mesh.mesh.shape, t.placements):
        if p.is_replicate():
            n *= int(size)
    return n


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of ``grads``. For
    DTensors, the sum over every shard: each rank's local sums over the number
    of ranks that hold the same shard, summed across the world in one
    all-reduce."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(g, DTensor) for g in grads):
        return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    total = sum(torch.sum(_local(g).float() ** 2) / _replication(g) for g in grads)
    torch.distributed.all_reduce(total)
    return torch.sqrt(total)


def default_optimizer(
    learning_rate: float = 3e-4,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
    warmup_steps: int = 0,
    total_steps: int = 0,
) -> AdamW:
    """AdamW with cosine schedule + global-norm clipping (GPT-2 recipe)."""
    lr = (
        warmup_cosine_lr(learning_rate, max(warmup_steps, 1), total_steps)
        if total_steps
        else learning_rate
    )
    return AdamW(learning_rate=lr, weight_decay=weight_decay, b1=b1, b2=b2, grad_clip=grad_clip)


# --------------------------------------------------------------------------- state and step
def param_shardings(config, mesh, rules: Optional[ShardingRules] = None):
    """The DTensor placements of each param (a tree of lists, one placement
    per mesh dim) under ``rules`` (default ``ShardingRules()``), from the
    params' shapes alone: nothing is allocated."""
    rules = rules or ShardingRules()
    model = model_for(config)
    shapes = model.init_params(config, 0, "meta")
    return tree_map(lambda t, ax: rules.placements(ax, mesh, t.shape), shapes,
                    model.param_logical_axes(config))


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _leaf_paths(v, prefix + (k,))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _leaf_paths(v, prefix + (i,))]
    return [prefix]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _init_sharded(config, seed, mesh, rules: ShardingRules, device):
    """Params drawn leaf by leaf, as on one device (the same values from the
    same seed), each kept only as this rank's shard: a model never exists
    whole on a rank. A dry run on the meta device gives the order in which
    ``init_params`` draws its leaves, so each drawn leaf is placed by its
    own logical axes."""
    model = model_for(config)
    drawn: List[torch.Tensor] = []
    meta = model.init_params(config, 0, "meta", place=lambda t: drawn.append(t) or t)
    path_of = {id(_at(meta, p)): p for p in _leaf_paths(meta)}
    order = iter([path_of[id(t)] for t in drawn])
    axes = model.param_logical_axes(config)

    def place(t):
        ax = _at(axes, next(order))
        return distribute(t, mesh, rules.placements(ax, mesh, t.shape))

    return model.init_params(config, seed, device, place=place)


def mesh_device(mesh):
    """The device a mesh's local shards live on: this process's current GPU
    for a CUDA mesh, the CPU for a CPU mesh."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def create_train_state(config, seed, optimizer: AdamW, mesh=None, device=None,
                       rules: Optional[ShardingRules] = None) -> TrainState:
    """Initialize params from ``seed`` on ``device`` (``None``: the GPU; raises
    when there is none) and the optimizer state. With a ``mesh``, params and
    moments are DTensors placed by ``rules`` (default ``ShardingRules()``) on
    the mesh's device."""
    if mesh is None:
        params = model_for(config).init_params(config, seed, resolve_device(device))
    else:
        params = _init_sharded(config, seed, mesh, rules or ShardingRules(), mesh_device(mesh))
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def _zero_if_unused(g, param, spmd):
    """A zero gradient, placed as the used ones are, for a param this rank's
    stage did not use."""
    if g is not None:
        return g
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(torch.zeros_like(param.to_local()), param.device_mesh,
                              spmd.grad_placements(param), run_check=False,
                              shape=param.shape, stride=param.stride())


def _reduce_grad(g, param):
    """A gradient with its param's placements: the sum of its ``Partial``
    parts over the batch axes (the data-parallel all-reduce)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(g, DTensor) or tuple(g.placements) == tuple(param.placements):
        return g
    return g.redistribute(param.device_mesh, param.placements)


def make_train_step(
    config,
    optimizer: AdamW,
    mesh=None,
    attention_fn: Optional[Callable] = None,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict[str, Any]]]:
    """One update: loss -> grads -> optimizer, in place. The returned metrics
    are tensors on the device (``loss``, ``grad_norm``; the same on every rank
    of a mesh) and the new ``step``."""
    model = model_for(config)

    def step_fn(state: TrainState, batch):
        dropout_seed = (
            fold_seed(_DROPOUT_BASE_SEED, state.step)
            if getattr(config, "dropout", 0) > 0
            else None
        )
        leaves = tree_leaves(state.params)
        loss = model.loss_fn(state.params, batch, config, attention_fn, dropout_seed, mesh=mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=mesh is not None)
        if mesh is not None:
            spmd = spmd_for(mesh)
            grads = [_reduce_grad(_zero_if_unused(g, p, spmd), p) for g, p in zip(grads, leaves)]
        gnorm = optimizer.update_(state.params, list(grads), state.opt_state)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm, "step": state.step}

    return step_fn


def shard_batch(batch: Dict[str, Any], mesh=None, device=None) -> Dict[str, torch.Tensor]:
    """Place a host batch (numpy arrays) on ``device`` (``None``: the GPU;
    raises when there is none). With a ``mesh``, every rank passes the whole
    batch and keeps its shard, as a DTensor: a 2-D token batch by
    ``batch_spec`` (batch over (data, fsdp), sequence over context), any
    other by its batch dim alone. Over a context axis a ``tokens`` batch (B,
    S+1) is split into ``inputs`` and ``targets`` (B, S) first, so the
    sequence divides."""
    if mesh is None:
        device = resolve_device(device)
        return {k: torch.as_tensor(np.asarray(x), device=device) for k, x in batch.items()}
    sizes = axis_sizes(mesh)
    n = sizes["data"] * sizes["fsdp"]
    if sizes["context"] > 1 and "tokens" in batch:
        tokens = np.asarray(batch["tokens"])
        batch = {**{k: v for k, v in batch.items() if k != "tokens"},
                 "inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    out = {}
    for k, x in batch.items():
        x = torch.as_tensor(np.asarray(x), device=mesh_device(mesh))
        if x.shape[0] % n:
            raise ValueError(f"batch '{k}' of {x.shape[0]} rows does not split over {n} shards")
        if x.dim() == 2 and x.shape[1] % sizes["context"]:
            raise ValueError(f"batch '{k}' of {x.shape[1]} positions does not split over "
                             f"{sizes['context']} context ranks")
        out[k] = distribute(x, mesh, batch_sharding(mesh, x.dim()))
    return out
