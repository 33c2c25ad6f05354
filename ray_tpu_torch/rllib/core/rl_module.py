"""RLModule: the neural-net interface of RLlib, over trees of torch tensors.

The counterpart of ``ray_tpu/rllib/core/rl_module.py``. A module object holds
its config and pure forwards over a parameter tree, as
``ray_tpu_torch/models/gpt.py`` does; the tree is the JAX package's leaf for
leaf (lists of ``{"w": (m, n), "b": (n,)}`` layers computed as ``x @ w + b``,
plus SAC's scalar ``log_alpha``), so weights, target networks and checkpoints
cross processes as numpy trees and ``params_from_numpy``/``params_to_numpy``
carry them unchanged. Random draws come from an explicit ``torch.Generator``
where the JAX package splits a key, so initial weights and sampled actions
follow another stream than JAX's.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.accelerators.gpu import resolve_device


def as_generator(seed_or_generator) -> torch.Generator:
    """A CPU ``torch.Generator``: the one given, or a new one seeded with it."""
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator().manual_seed(int(seed_or_generator))


def mlp_init(generator: torch.Generator, sizes, final_scale: float = 1.0, device=None):
    """He-scaled MLP tower shared by every module class: a list of
    {"w", "b"} layer dicts on ``device``; the last layer's weights scale by
    final_scale (e.g. 0.01 for a near-uniform initial policy). Drawn on the
    CPU from ``generator``, so a seed gives the same weights on any device."""
    device = resolve_device(device)
    layers = []
    for i, (m, n) in enumerate(zip(sizes[:-1], sizes[1:])):
        scale = math.sqrt(2.0 / m)
        if i == len(sizes) - 2:
            scale = scale * final_scale
        w = torch.randn((m, n), generator=generator, dtype=torch.float32) * scale
        layers.append({"w": w.to(device), "b": torch.zeros((n,), dtype=torch.float32, device=device)})
    return layers


_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    "elu": F.elu,
    # jax.nn.gelu's default is the tanh approximation.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def _activation(name: str):
    """Resolve an activation name to a torch function."""
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; one of {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


def mlp_forward(layers, x, activation: str = "tanh"):
    """Run an mlp_init tower: `activation` between layers, linear final."""
    act = _activation(activation)
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            x = act(x)
    return x


class RLModule:
    """Interface: subclasses define init(seed, device) -> params and pure
    forwards."""

    def init(self, seed, device=None) -> Any:
        """Params from a seed or a ``torch.Generator``, on ``device`` (None:
        the GPU; raises when there is none)."""
        raise NotImplementedError

    def forward(self, params, obs):
        """Returns (action_logits, value_estimate)."""
        raise NotImplementedError

    def action_dist(self, params, obs, generator, explore: bool = True):
        """Sample actions + logp under the current policy.

        Returns (action, logp, value, logits); the behavior logits ride along
        so PPO can compute the true KL(prev || curr) from them.
        ``generator`` lives on the device of ``obs``.
        """
        logits, value = self.forward(params, obs)
        logp = F.log_softmax(logits, dim=-1)
        if explore:
            probs = logp.exp().reshape(-1, logits.shape[-1])
            action = torch.multinomial(probs, 1, generator=generator).reshape(logits.shape[:-1])
        else:
            action = torch.argmax(logits, dim=-1)
        act_logp = torch.gather(logp, -1, action[..., None])[..., 0]
        return action, act_logp, value, logits


class QValueModule(RLModule):
    """Base for Q-value modules: subclasses define forward -> (q, max_q) and
    inherit the ONE epsilon-greedy implementation. The runner detects
    value-based modules by the presence of `epsilon_greedy`, so this method
    must live here and NOT on RLModule."""

    # Replay-trained: the runner skips logp/value/dist buffers entirely.
    off_policy = True

    def epsilon_greedy(self, params, obs, generator, explore: bool, epsilon):
        q, value = self.forward(params, obs)
        greedy = torch.argmax(q, dim=-1)
        if explore:
            random_a = torch.randint(0, q.shape[-1], greedy.shape, generator=generator,
                                     device=q.device)
            u = torch.rand(greedy.shape, generator=generator, device=q.device)
            action = torch.where(u < epsilon, random_a, greedy)
        else:
            action = greedy
        # logp slot unused for value-based policies; q rides the logits slot.
        return action, torch.zeros(greedy.shape, device=q.device), value, q


class QMLPModule(QValueModule):
    """Single-tower Q-network MLP for value-based algorithms: forward returns
    per-action Q-values (logits slot) + max-Q (value slot); exploration is
    epsilon-greedy. No value tower: every weight here is read on the Q path."""

    def __init__(self, obs_dim: int, num_actions: int, hiddens: Sequence[int] = (64, 64),
                 activation: str = "tanh"):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hiddens = tuple(hiddens)
        self.activation = activation

    def init(self, seed, device=None):
        g = as_generator(seed)
        return {"q": mlp_init(g, (self.obs_dim, *self.hiddens, self.num_actions), device=device)}

    def forward(self, params, obs):
        q = mlp_forward(params["q"], obs, self.activation)
        return q, q.amax(dim=-1)


class MLPModule(RLModule):
    """Policy + value MLP with shared-nothing towers (categorical actions)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int] = (64, 64), activation: str = "tanh"):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hiddens = tuple(hiddens)
        self.activation = activation

    def init(self, seed, device=None):
        g = as_generator(seed)
        return {
            # Near-zero policy head -> near-uniform initial policy.
            "pi": mlp_init(g, (self.obs_dim, *self.hiddens, self.num_actions), final_scale=0.01,
                           device=device),
            "vf": mlp_init(g, (self.obs_dim, *self.hiddens, 1), device=device),
        }

    def forward(self, params, obs):
        logits = mlp_forward(params["pi"], obs, self.activation)
        value = mlp_forward(params["vf"], obs, self.activation)[..., 0]
        return logits, value


class _BoxActions:
    """Affine map between a Box's bounds and (-1, 1), for the continuous
    modules."""

    def _set_bounds(self, act_low, act_high):
        self.act_low = np.asarray(act_low, np.float32)
        self.act_high = np.asarray(act_high, np.float32)
        self.act_dim = int(self.act_low.size)
        self.center = (self.act_high + self.act_low) / 2.0
        self.scale = (self.act_high - self.act_low) / 2.0

    def _t(self, name, like):
        """Bound array ``name`` as a tensor beside ``like``, made once per
        device: a copy from host memory inside a loss would wait for every
        kernel queued before it."""
        cache = self.__dict__.setdefault("_bounds_on", {})
        key = (name, like.device)
        if key not in cache:
            cache[key] = torch.tensor(getattr(self, name), device=like.device)
        return cache[key]

    def __getstate__(self):
        # The per-device bound tensors stay in the process that made them.
        return {k: v for k, v in self.__dict__.items() if k != "_bounds_on"}

    def q_values(self, q_params, obs, action_env):
        """Q(s, a) for one tower; actions normalize back to (-1, 1) so tower
        inputs stay O(1) whatever the env's bounds."""
        a = (action_env - self._t("center", obs)) / self._t("scale", obs)
        x = torch.cat([obs, a], dim=-1)
        return mlp_forward(q_params, x, self.activation)[..., 0]


class SquashedGaussianModule(_BoxActions, RLModule):
    """Continuous-control actor-critic: tanh-squashed Gaussian policy + twin
    Q towers (SAC's module). Actions map to the Box bounds via an affine of
    tanh(u); log-probs carry the tanh + affine Jacobian corrections. One tree
    {"pi", "q1", "q2", "log_alpha"}."""

    off_policy = True
    LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0

    def __init__(self, obs_dim: int, act_low, act_high,
                 hiddens: Sequence[int] = (256, 256), activation: str = "tanh"):
        self.obs_dim = obs_dim
        self._set_bounds(act_low, act_high)
        self.hiddens = tuple(hiddens)
        self.activation = activation

    def init(self, seed, device=None):
        g = as_generator(seed)
        q_sizes = (self.obs_dim + self.act_dim, *self.hiddens, 1)
        return {
            "pi": mlp_init(g, (self.obs_dim, *self.hiddens, 2 * self.act_dim), device=device),
            "q1": mlp_init(g, q_sizes, device=device),
            "q2": mlp_init(g, q_sizes, device=device),
            "log_alpha": torch.zeros((), dtype=torch.float32, device=resolve_device(device)),
        }

    # ------------------------------------------------------------ policy math
    def dist_params(self, params, obs):
        out = mlp_forward(params["pi"], obs, self.activation)
        mean, log_std = torch.split(out, self.act_dim, dim=-1)
        return mean, torch.clamp(log_std, self.LOG_STD_MIN, self.LOG_STD_MAX)

    def sample(self, params, obs, noise):
        """Reparameterized squashed sample from pre-drawn standard normals.
        Returns (action_env_scale, logp)."""
        mean, log_std = self.dist_params(params, obs)
        u = mean + torch.exp(log_std) * noise
        a_raw = torch.tanh(u)
        # N(u; mean, std) log-density, then tanh + affine Jacobians.
        logp = torch.sum(-0.5 * noise * noise - log_std - 0.5 * math.log(2.0 * math.pi), dim=-1)
        logp = logp - torch.sum(torch.log(1.0 - a_raw * a_raw + 1e-6), dim=-1)
        logp = logp - float(np.sum(np.log(self.scale)))
        return self._t("center", obs) + self._t("scale", obs) * a_raw, logp

    # ----------------------------------------------------------- runner hooks
    def forward(self, params, obs):
        """(dist params, Q(s, mean action)): the value slot for diagnostics."""
        mean, log_std = self.dist_params(params, obs)
        a_env = self._t("center", obs) + self._t("scale", obs) * torch.tanh(mean)
        return torch.cat([mean, log_std], dim=-1), self.q_values(params["q1"], obs, a_env)

    def action_dist(self, params, obs, generator, explore: bool = True):
        mean, log_std = self.dist_params(params, obs)
        if explore:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        else:
            noise = torch.zeros_like(mean)
        action, logp = self.sample(params, obs, noise)
        value = self.q_values(params["q1"], obs, action)
        return action, logp, value, torch.cat([mean, log_std], dim=-1)


class DeterministicContinuousModule(_BoxActions, RLModule):
    """Deterministic continuous-control actor-critic: tanh policy mapped to
    the Box bounds + twin Q towers (TD3's module; DDPG uses one tower of it).
    Exploration is Gaussian noise on the env-scale action, clipped to bounds,
    with the noise scale fixed at construction."""

    off_policy = True

    def __init__(self, obs_dim: int, act_low, act_high,
                 hiddens: Sequence[int] = (256, 256), activation: str = "tanh",
                 explore_noise: float = 0.1):
        self.obs_dim = obs_dim
        self._set_bounds(act_low, act_high)
        self.hiddens = tuple(hiddens)
        self.activation = activation
        self.explore_noise = float(explore_noise)

    def init(self, seed, device=None):
        g = as_generator(seed)
        q_sizes = (self.obs_dim + self.act_dim, *self.hiddens, 1)
        return {
            "pi": mlp_init(g, (self.obs_dim, *self.hiddens, self.act_dim), device=device),
            "q1": mlp_init(g, q_sizes, device=device),
            "q2": mlp_init(g, q_sizes, device=device),
        }

    def pi(self, params, obs):
        """Deterministic env-scale action."""
        raw = mlp_forward(params["pi"], obs, self.activation)
        return self._t("center", obs) + self._t("scale", obs) * torch.tanh(raw)

    def forward(self, params, obs):
        a = self.pi(params, obs)
        return a, self.q_values(params["q1"], obs, a)

    def action_dist(self, params, obs, generator, explore: bool = True):
        a = self.pi(params, obs)
        if explore:
            noise = torch.randn(a.shape, generator=generator, device=a.device) * (
                self.explore_noise * self._t("scale", obs))
            a = torch.clamp(a + noise, self._t("act_low", obs), self._t("act_high", obs))
        value = self.q_values(params["q1"], obs, a)
        # logp slot unused for deterministic policies; the action rides the
        # logits slot for diagnostics.
        return a, torch.zeros(a.shape[:-1], device=a.device), value, a
