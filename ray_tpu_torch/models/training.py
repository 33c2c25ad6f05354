"""Train state and train step: the counterpart of ``ray_tpu/models/training.py``.

One device, eager PyTorch. Where the JAX step is a pure function with donated
state, this step updates the state's tensors in place (params, Adam moments)
and returns the same ``TrainState``: the memory the JAX package saves by
donation is saved here by never copying. The optimizer is AdamW with
global-norm clipping and an optional warmup-cosine schedule, written out to
match ``optax.chain(clip_by_global_norm, adamw)`` update for update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.accelerators.gpu import resolve_device
from ray_tpu_torch.models import gpt, llama, resnet
from ray_tpu_torch.models.stack import check_single_device

_DROPOUT_BASE_SEED = 0x5EED


def model_for(config):
    """The model module of a config (gpt, llama, resnet), so one TrainState
    and step factory serves the whole zoo."""
    if isinstance(config, llama.LlamaConfig):
        return llama
    if isinstance(config, resnet.ResNetConfig):
        return resnet
    if isinstance(config, gpt.GPTConfig):
        return gpt
    raise TypeError(f"no model for a {type(config).__name__}")


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
        zeros = lambda p: torch.zeros_like(p, memory_format=torch.contiguous_format)  # noqa: E731
        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    @torch.no_grad()
    def update_(self, params, grads: List[torch.Tensor], opt_state) -> torch.Tensor:
        """Apply one update in place to ``params`` and ``opt_state``; ``grads``
        follow ``tree_leaves(params)``. Returns the global norm of ``grads``,
        taken before clipping."""
        leaves = tree_leaves(params)
        mus, nus = tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])
        g_norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
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
def create_train_state(config, seed, optimizer: AdamW, mesh=None, device=None) -> TrainState:
    """Initialize params from ``seed`` on ``device`` (``None``: the GPU; raises
    when there is none) and the optimizer state."""
    check_single_device(mesh)
    params = model_for(config).init_params(config, seed, resolve_device(device))
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def make_train_step(
    config,
    optimizer: AdamW,
    mesh=None,
    attention_fn: Optional[Callable] = None,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict[str, Any]]]:
    """One update: loss -> grads -> optimizer, in place. The returned metrics
    are tensors on the device (``loss``, ``grad_norm``) and the new ``step``."""
    check_single_device(mesh)
    model = model_for(config)

    def step_fn(state: TrainState, batch):
        dropout_seed = (
            gpt.fold_seed(_DROPOUT_BASE_SEED, state.step)
            if getattr(config, "dropout", 0) > 0
            else None
        )
        leaves = tree_leaves(state.params)
        loss = model.loss_fn(state.params, batch, config, attention_fn, dropout_seed)
        grads = torch.autograd.grad(loss, leaves)
        gnorm = optimizer.update_(state.params, list(grads), state.opt_state)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm, "step": state.step}

    return step_fn


def shard_batch(batch: Dict[str, Any], mesh=None, device=None) -> Dict[str, torch.Tensor]:
    """Place a host batch (numpy arrays) on ``device`` (``None``: the GPU;
    raises when there is none). One device only: the counterpart of placing
    the batch on a mesh of one."""
    check_single_device(mesh)
    device = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(x), device=device) for k, x in batch.items()}
