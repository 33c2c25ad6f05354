"""TorchLearner: gradient updates on one device, the ``JaxLearner`` counterpart.

The counterpart of ``ray_tpu/rllib/core/learner.py``. Where the JAX learner's
update is one jitted function with donated state, this one updates its
tensors in place: params, the optimizer's moments and the loss's ``extra``
state (DQN's target network) live on one device, which is the GPU unless the
caller names another, and ``update`` copies each host batch there once and
reads every aux value back in one transfer.
"""

from __future__ import annotations

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
        if mesh is not None:
            raise NotImplementedError(
                "a learner over a device mesh is not ported yet: ROADMAP.md Queue 1 item 3")
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
        batch = {k: torch.tensor(np.asarray(v), device=self.device) for k, v in batch.items()}
        if self._loss_wants_extra:
            loss, aux = self._loss_fn(self.module, self.params, batch, self.extra)
        else:
            loss, aux = self._loss_fn(self.module, self.params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(self.params))
        grad_norm = self.optimizer.update_(self.params, list(grads), self.opt_state)
        if self._extra_update_fn is not None:
            with torch.no_grad():
                self.extra = self._extra_update_fn(self.params, self.extra)
        return read_back(dict(aux, total_loss=loss, grad_norm=grad_norm))

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
