"""Distributional (C51) Q-network module with optional dueling heads.

The counterpart of ``ray_tpu/rllib/core/distributional.py``: DQN's
``num_atoms > 1`` and ``dueling`` knobs. The module emits per-action atom
logits in one (B, A, natoms) tensor from a shared trunk; the dueling combine
(value + advantage - mean advantage) happens in logit space, and scalar
Q-values are the support-weighted softmax. The categorical projection lives in
the loss (``dqn.py make_c51_loss``), not here.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ray_tpu_torch.rllib.core.rl_module import (
    QValueModule,
    _activation,
    as_generator,
    mlp_forward,
    mlp_init,
)


class DuelingQMLPModule(QValueModule):
    """Scalar dueling Q-net (``dueling=True``, num_atoms=1):
    Q(s,a) = V(s) + A(s,a) - mean_a A(s,a), heads off a shared trunk."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int] = (64, 64), activation: str = "tanh"):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hiddens = tuple(hiddens)
        self.activation = activation

    def init(self, seed, device=None):
        g = as_generator(seed)
        return {
            "trunk": mlp_init(g, (self.obs_dim, *self.hiddens), device=device),
            "adv": mlp_init(g, (self.hiddens[-1], self.num_actions), device=device),
            "val": mlp_init(g, (self.hiddens[-1], 1), device=device),
        }

    def forward(self, params, obs):
        h = _activation(self.activation)(mlp_forward(params["trunk"], obs, self.activation))
        adv = mlp_forward(params["adv"], h, self.activation)
        val = mlp_forward(params["val"], h, self.activation)
        q = val + adv - adv.mean(dim=-1, keepdim=True)
        return q, q.amax(dim=-1)


class DistributionalQModule(QValueModule):
    """C51 Q-net: trunk -> (dueling) atom-logit heads; Q = E_z[softmax]."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int] = (64, 64), activation: str = "tanh",
                 num_atoms: int = 51, v_min: float = -10.0, v_max: float = 10.0,
                 dueling: bool = True):
        if num_atoms < 2:
            raise ValueError("num_atoms must be >= 2 (use QMLPModule for scalar Q)")
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hiddens = tuple(hiddens)
        self.activation = activation
        self.num_atoms = int(num_atoms)
        self.v_min = float(v_min)
        self.v_max = float(v_max)
        self.dueling = bool(dueling)
        # Fixed support; a buffer, not a parameter.
        self.support = np.linspace(v_min, v_max, num_atoms).astype(np.float32)

    def init(self, seed, device=None):
        g = as_generator(seed)
        params = {
            "trunk": mlp_init(g, (self.obs_dim, *self.hiddens), device=device),
            "adv": mlp_init(g, (self.hiddens[-1], self.num_actions * self.num_atoms),
                            device=device),
        }
        if self.dueling:
            params["val"] = mlp_init(g, (self.hiddens[-1], self.num_atoms), device=device)
        return params

    def support_on(self, like) -> torch.Tensor:
        """The support as a tensor beside ``like``."""
        return torch.as_tensor(self.support, device=like.device)

    # -------------------------------------------------------------- forwards
    def _trunk(self, params, obs):
        # mlp_forward leaves the last layer linear; the trunk feeds heads, so
        # apply the nonlinearity it skipped.
        return _activation(self.activation)(mlp_forward(params["trunk"], obs, self.activation))

    def dist_logits(self, params, obs):
        """(B, A, natoms) atom logits; dueling combine in logit space."""
        h = self._trunk(params, obs)
        adv = mlp_forward(params["adv"], h, self.activation).reshape(
            obs.shape[:-1] + (self.num_actions, self.num_atoms))
        if not self.dueling:
            return adv
        val = mlp_forward(params["val"], h, self.activation)[..., None, :]
        return val + adv - adv.mean(dim=-2, keepdim=True)

    def dist_probs(self, params, obs):
        return torch.softmax(self.dist_logits(params, obs), dim=-1)

    def forward(self, params, obs):
        """Scalar Q-values (B, A) = support-weighted atom probabilities."""
        q = torch.sum(self.dist_probs(params, obs) * self.support_on(obs), dim=-1)
        return q, q.amax(dim=-1)
