"""TorchLearner: gradient updates on one device or over a mesh's data axis,
the ``JaxLearner`` counterpart.

The counterpart of ``ray_tpu/rllib/core/learner.py``. Where the JAX learner's
update is one jitted function with donated state, this one updates its
tensors in place: params, the optimizer's moments and the loss's ``extra``
state (DQN's target network) live on one device, which is the GPU unless the
caller names another, and ``update`` copies each host batch there once and
reads every aux value back in one transfer.

With a ``mesh`` (a ``DeviceMesh`` over an initialized process group), each
rank is one learner of a data-parallel gang, as the JAX learner's jitted step
is with its batch sharded on ``"data"`` and the rest replicated: every rank
passes the whole batch and keeps its contiguous rows, the gradients are
averaged across the ``data`` group before the optimizer (one all-reduce), so
the params stay the same on every rank, and the aux comes back global (the
scalars averaged over the ranks' equal shards, the per-row vectors gathered
in row order). A loss's means over rows need nothing more: the mean of the
equal shards' means is the whole batch's. A sum that normalizes another (DQN's
``sum(w * huber) / sum(w)``) is taken with ``batch_sum``, which is the whole
batch's sum on every rank, so the gang's gradient is the jitted step's.
"""

from __future__ import annotations

import contextvars
import inspect
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._private.accelerators.gpu import resolve_device
from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.models.training import AdamW, tree_leaves, tree_map
from ray_tpu_torch.rllib.core.rl_module import RLModule


def adam(learning_rate: float, grad_clip: Optional[float] = None) -> AdamW:
    """``optax.adam(learning_rate)`` (b1 0.9, b2 0.999, eps 1e-8, bias
    corrected), after ``optax.clip_by_global_norm(grad_clip)`` when it is
    given: the chain PPO and DQN build, and the learner's default without
    clipping."""
    return AdamW(learning_rate=learning_rate, weight_decay=0.0, b1=0.9, b2=0.999,
                 grad_clip=grad_clip)


# The data group and its size while a mesh learner's loss runs; None else.
_DATA_GROUP: contextvars.ContextVar = contextvars.ContextVar("learner_data_group", default=None)


class _SumOverData(torch.autograd.Function):
    """All-reduce (sum) over the learner's data group. Backward: the gradient
    times the group's size, since the learner averages the ranks' gradients
    and each rank differentiates its own rows' terms."""

    @staticmethod
    def forward(ctx, x, group, n):
        import torch.distributed as dist

        ctx.n = n
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None, None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the whole batch: this rank's rows' sum, summed
    across the data group when a mesh learner's loss calls it."""
    total = torch.sum(x)
    group = _DATA_GROUP.get()
    return total if group is None else _SumOverData.apply(total, *group)


def to_device(tree, device):
    """A tree of arrays or tensors as tensors on ``device``, copied."""
    return tree_map(
        lambda x: x.detach().to(device, copy=True) if isinstance(x, torch.Tensor)
        else torch.tensor(np.asarray(x), device=device), tree)


def read_back(aux: Dict[str, Any]) -> Dict[str, Any]:
    """Aux tensors to the host in one transfer: scalars as floats, the rest
    (DQN's per-sample ``td_abs``) as float32 numpy arrays."""
    tensors = {k: torch.as_tensor(v) for k, v in aux.items()}
    device = next(iter(tensors.values())).device
    flat = torch.cat([t.detach().to(device, torch.float32).reshape(-1)
                      for t in tensors.values()]).cpu().numpy()
    out, i = {}, 0
    for k, t in tensors.items():
        part = flat[i:i + t.numel()]
        i += t.numel()
        out[k] = float(part[0]) if t.dim() == 0 else part.reshape(t.shape)
    return out


class TorchLearner:
    def __init__(
        self,
        module: RLModule,
        loss_fn: Callable,  # (module, params, batch[, extra]) -> (loss, aux_dict)
        optimizer: Optional[AdamW] = None,
        learning_rate: float = 3e-4,
        mesh=None,
        seed: int = 0,
        extra_update_fn: Optional[Callable] = None,
        device=None,
    ):
        self.mesh = mesh
        self._group, self._shards, self._shard = None, 1, 0
        if mesh is not None:
            from ray_tpu_torch.models.training import mesh_device
            from ray_tpu_torch.parallel.mesh import axis_sizes

            beyond = {a: n for a, n in axis_sizes(mesh).items() if a != "data" and n > 1}
            if beyond:
                raise ValueError(f"the learner shards its batch over 'data' only, as the JAX "
                                 f"package's does; the mesh also has {beyond}")
            self._shards = axis_sizes(mesh)["data"]
            if self._shards > 1:
                self._group, self._shard = mesh.get_group("data"), mesh.get_local_rank("data")
            device = mesh_device(mesh)
        self.device = resolve_device(device)
        self.module = module
        self._loss_fn = loss_fn
        self.optimizer = optimizer or adam(learning_rate)
        self.params = module.init(seed, device=self.device)
        for leaf in tree_leaves(self.params):
            leaf.requires_grad_(True)
        self.opt_state = self.optimizer.init(self.params)
        # Auxiliary state the loss may consume (DQN's target params):
        # loss_fn(module, params, batch, extra). Never part of the batch,
        # which a LearnerGroup slices per remote learner.
        self.extra: Any = None
        # Optional (new_params, extra) -> new_extra, applied after each
        # optimizer step (e.g. SAC's polyak target blend) on the device.
        self._extra_update_fn = extra_update_fn
        self._loss_wants_extra = len(inspect.signature(loss_fn).parameters) >= 4

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """One SGD step on a host batch. Scalar aux entries come back as
        floats; vector aux (e.g. DQN's per-sample `td_abs` for prioritized
        replay) comes back as numpy arrays, from the same step."""
        batch = {k: torch.tensor(self._rows(np.asarray(v)), device=self.device)
                 for k, v in batch.items()}
        args = (batch, self.extra) if self._loss_wants_extra else (batch,)
        token = _DATA_GROUP.set(None if self._group is None else (self._group, self._shards))
        try:
            loss, aux = self._loss_fn(self.module, self.params, *args)
        finally:
            _DATA_GROUP.reset(token)
        leaves = tree_leaves(self.params)
        # A leaf the loss never reads (PG's value tower) gets a zero
        # gradient, as under jax.grad.
        grads = [torch.zeros_like(p) if g is None else g for p, g in
                 zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        aux = dict(aux, total_loss=loss)
        if self._group is not None:
            grads, aux = self._average(grads), self._global_aux(aux)
        grad_norm = self.optimizer.update_(self.params, grads, self.opt_state)
        if self._extra_update_fn is not None:
            with torch.no_grad():
                self.extra = self._extra_update_fn(self.params, self.extra)
        return read_back(dict(aux, grad_norm=grad_norm))

    # ------------------------------------------------------------- the data axis
    def _rows(self, x: np.ndarray) -> np.ndarray:
        """This rank's contiguous rows of a whole batch column."""
        if self._shards == 1:
            return x
        if len(x) % self._shards:
            raise ValueError(f"a batch of {len(x)} rows does not split over {self._shards} "
                             "data ranks")
        per = len(x) // self._shards
        return x[self._shard * per:(self._shard + 1) * per]

    @torch.no_grad()
    def _average(self, grads):
        """The mean of every rank's gradients, in one all-reduce."""
        import torch.distributed as dist

        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self._group)
        flat /= self._shards
        return [p.view_as(g) for p, g in zip(flat.split([g.numel() for g in grads]), grads)]

    @torch.no_grad()
    def _global_aux(self, aux):
        """The whole batch's aux: the ranks' scalars averaged (their shards
        are equal), the per-row vectors gathered in row order."""
        import torch.distributed as dist

        from ray_tpu_torch.parallel.spmd import gather_rows

        scalars = [k for k, v in aux.items() if torch.as_tensor(v).dim() == 0]
        out = {k: gather_rows(torch.as_tensor(v), self._group, self._shards)
               for k, v in aux.items() if k not in scalars}
        means = torch.stack([torch.as_tensor(aux[k], device=self.device).float()
                             for k in scalars])
        dist.all_reduce(means, group=self._group)
        out.update(zip(scalars, means / self._shards))
        return out

    def placement(self) -> Dict[str, Any]:
        """This learner's process, visible GPU ids and the device its params
        are on."""
        return {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": str(tree_leaves(self.params)[0].device)}

    def set_extra(self, extra: Any) -> None:
        """Swap the auxiliary state (e.g. a synced target network), given as
        a tree of numpy arrays or tensors."""
        self.extra = None if extra is None else to_device(extra, self.device)

    def get_extra(self) -> Any:
        return None if self.extra is None else params_to_numpy(self.extra)

    # ------------------------------------------------------------- state sync
    def get_weights(self) -> Any:
        """The params as a numpy tree with the JAX package's leaf names."""
        return params_to_numpy(self.params)

    @torch.no_grad()
    def set_weights(self, weights: Any) -> None:
        """Copy a numpy tree (matched by key) into the params in place; the
        optimizer state is kept, as the JAX learner keeps it."""
        tree_map(lambda p, w: p.copy_(torch.tensor(np.asarray(w))), self.params, weights)

    def state(self) -> Dict[str, Any]:
        """Params and optimizer state as numpy trees: a checkpoint written on
        the GPU loads on a CPU-only machine."""
        return {"params": self.get_weights(), "opt_state": {
            "count": self.opt_state["count"], "mu": params_to_numpy(self.opt_state["mu"]),
            "nu": params_to_numpy(self.opt_state["nu"])}}

    @torch.no_grad()
    def load_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["params"])
        opt = state["opt_state"]
        for key in ("mu", "nu"):
            tree_map(lambda t, a: t.copy_(torch.tensor(np.asarray(a))), self.opt_state[key],
                     opt[key])
        self.opt_state["count"] = int(opt["count"])
