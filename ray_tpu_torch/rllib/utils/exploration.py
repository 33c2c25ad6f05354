"""Exploration strategy library: pluggable action selection.

The counterpart of ``ray_tpu/rllib/utils/exploration.py``; reference:
`rllib/utils/exploration/` — EpsilonGreedy (`epsilon_greedy.py`), SoftQ
(`soft_q.py`), StochasticSampling (`stochastic_sampling.py`), Random
(`random.py`), GaussianNoise (`gaussian_noise.py`), OrnsteinUhlenbeckNoise
(`ornstein_uhlenbeck_noise.py`), ParameterNoise (`parameter_noise.py`).

A strategy is a pair of functions: `actions(...)` runs in the runner's
forward with every annealable knob (epsilon, noise scale, OU state) passed in
a `state` dict and returned updated, and `schedule()` is driver-side numpy
that recomputes the annealed scalars from the global env-step count and is
pushed to runners with the weight sync. Random draws come from the runner's
`torch.Generator`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.training import tree_map


class Exploration:
    """Interface. `actions` takes the state and returns it updated."""

    #: strategies that need per-env persistent arrays (OU noise) override.
    def initial_state(self, num_envs: int, act_shape: Tuple[int, ...]) -> Dict[str, Any]:
        return {}

    def schedule(self, env_steps: int) -> Dict[str, Any]:
        """Driver-side: annealed scalars for the current global step count.
        Merged into the runner's live state by `EnvRunner.set_exploration`."""
        return {}

    def on_weights(self, params, generator):
        """Hook at weight-sync time (ParameterNoise perturbs here). Returns
        the params the ROLLOUT should use; learner params are untouched."""
        return params

    def actions(self, module, params, obs, generator, explore: bool, state: Dict[str, Any]):
        """(action, logp, value, dist_inputs, new_state)."""
        raise NotImplementedError


def _anneal(initial: float, final: float, steps: int, t: int) -> float:
    frac = min(1.0, t / max(1, steps))
    return float(initial + frac * (final - initial))


def _zeros(like):
    return torch.zeros(like.shape[:-1], device=like.device)


class EpsilonGreedy(Exploration):
    """Annealed epsilon-greedy over Q-values (reference:
    `rllib/utils/exploration/epsilon_greedy.py`)."""

    def __init__(self, initial_epsilon: float = 1.0, final_epsilon: float = 0.05,
                 epsilon_timesteps: int = 10_000):
        self.initial_epsilon = float(initial_epsilon)
        self.final_epsilon = float(final_epsilon)
        self.epsilon_timesteps = int(epsilon_timesteps)

    def initial_state(self, num_envs, act_shape):
        return {"epsilon": np.float32(self.initial_epsilon)}

    def schedule(self, env_steps):
        return {
            "epsilon": np.float32(
                _anneal(self.initial_epsilon, self.final_epsilon,
                        self.epsilon_timesteps, env_steps)
            )
        }

    def actions(self, module, params, obs, generator, explore, state):
        if hasattr(module, "epsilon_greedy"):
            # Q modules carry the canonical implementation (QValueModule);
            # delegating keeps one copy of the argmax/dither block.
            a, logp, v, d = module.epsilon_greedy(
                params, obs, generator, explore, float(state["epsilon"])
            )
            return a, logp, v, d, state
        q, value = module.forward(params, obs)
        greedy = torch.argmax(q, dim=-1)
        if explore:
            random_a = torch.randint(0, q.shape[-1], greedy.shape, generator=generator,
                                     device=q.device)
            u = torch.rand(greedy.shape, generator=generator, device=q.device)
            action = torch.where(u < float(state["epsilon"]), random_a, greedy)
        else:
            action = greedy
        return action, _zeros(q), value, q, state


class SoftQ(Exploration):
    """Boltzmann sampling from softmax(Q / temperature) (reference:
    `rllib/utils/exploration/soft_q.py`)."""

    def __init__(self, temperature: float = 1.0):
        self.temperature = float(temperature)

    def initial_state(self, num_envs, act_shape):
        return {"temperature": np.float32(self.temperature)}

    def actions(self, module, params, obs, generator, explore, state):
        q, value = module.forward(params, obs)
        if explore:
            logits = q / max(float(state["temperature"]), 1e-8)
            probs = torch.softmax(logits, dim=-1).reshape(-1, q.shape[-1])
            action = torch.multinomial(probs, 1, generator=generator).reshape(q.shape[:-1])
        else:
            action = torch.argmax(q, dim=-1)
        return action, _zeros(q), value, q, state


class StochasticSampling(Exploration):
    """Sample the module's own action distribution (reference:
    `rllib/utils/exploration/stochastic_sampling.py` — the PG default)."""

    def actions(self, module, params, obs, generator, explore, state):
        a, logp, v, d = module.action_dist(params, obs, generator, explore)
        return a, logp, v, d, state


class Random(Exploration):
    """Uniform-random actions while exploring; greedy otherwise (reference:
    `rllib/utils/exploration/random.py` — pure-exploration warmup)."""

    def actions(self, module, params, obs, generator, explore, state):
        if not explore:
            a, logp, v, d = module.action_dist(params, obs, generator, False)
            return a, logp, v, d, state
        out, value = module.forward(params, obs)
        low = getattr(module, "act_low", None)
        if low is not None:  # continuous Box
            lo, hi = module._t("act_low", obs), module._t("act_high", obs)
            u = torch.rand(obs.shape[:-1] + (module.act_dim,), generator=generator,
                           device=obs.device)
            action = lo + u * (hi - lo)
            return action, _zeros(action), value, out, state
        action = torch.randint(0, out.shape[-1], out.shape[:-1], generator=generator,
                               device=out.device)
        return action, _zeros(out), value, out, state


class GaussianNoise(Exploration):
    """Deterministic action + annealed additive Gaussian noise, clipped to
    bounds (reference: `rllib/utils/exploration/gaussian_noise.py` — the
    DDPG/TD3 default). `scale` anneals initial->final over scale_timesteps."""

    def __init__(self, stddev: float = 0.1, initial_scale: float = 1.0,
                 final_scale: float = 1.0, scale_timesteps: int = 10_000,
                 random_timesteps: int = 0):
        self.stddev = float(stddev)
        self.initial_scale = float(initial_scale)
        self.final_scale = float(final_scale)
        self.scale_timesteps = int(scale_timesteps)
        self.random_timesteps = int(random_timesteps)

    def initial_state(self, num_envs, act_shape):
        return {
            "scale": np.float32(self.initial_scale),
            # >0 while in the pure-random warmup phase.
            "pure_random": np.float32(1.0 if self.random_timesteps > 0 else 0.0),
        }

    def schedule(self, env_steps):
        return {
            "scale": np.float32(
                _anneal(self.initial_scale, self.final_scale,
                        self.scale_timesteps, env_steps)
            ),
            "pure_random": np.float32(1.0 if env_steps < self.random_timesteps else 0.0),
        }

    def actions(self, module, params, obs, generator, explore, state):
        a = module.pi(params, obs)
        if explore:
            lo, hi = module._t("act_low", obs), module._t("act_high", obs)
            noise = torch.randn(a.shape, generator=generator, device=a.device) * (
                self.stddev * float(state["scale"]) * module._t("scale", obs))
            noisy = torch.clamp(a + noise, lo, hi)
            rand = lo + torch.rand(a.shape, generator=generator, device=a.device) * (hi - lo)
            a = rand if float(state["pure_random"]) > 0 else noisy
        value = module.q_values(params["q1"], obs, a)
        return a, _zeros(a), value, a, state


class OrnsteinUhlenbeckNoise(Exploration):
    """Temporally-correlated OU noise for continuous control (reference:
    `rllib/utils/exploration/ornstein_uhlenbeck_noise.py`). The OU process
    x += theta*(-x)*dt + sigma*sqrt(dt)*N(0,1) lives in the state as a
    (num_envs, act_dim) array and persists across rollout fragments."""

    def __init__(self, ou_theta: float = 0.15, ou_sigma: float = 0.2,
                 ou_base_scale: float = 0.1, initial_scale: float = 1.0,
                 final_scale: float = 1.0, scale_timesteps: int = 10_000):
        self.ou_theta = float(ou_theta)
        self.ou_sigma = float(ou_sigma)
        self.ou_base_scale = float(ou_base_scale)
        self.initial_scale = float(initial_scale)
        self.final_scale = float(final_scale)
        self.scale_timesteps = int(scale_timesteps)

    def initial_state(self, num_envs, act_shape):
        return {
            "scale": np.float32(self.initial_scale),
            "ou": np.zeros((num_envs,) + tuple(act_shape), np.float32),
        }

    def schedule(self, env_steps):
        return {
            "scale": np.float32(
                _anneal(self.initial_scale, self.final_scale,
                        self.scale_timesteps, env_steps)
            )
        }

    def actions(self, module, params, obs, generator, explore, state):
        a = module.pi(params, obs)
        new_state = state
        if explore:
            ou = torch.as_tensor(state["ou"], device=a.device)
            drift = torch.randn(ou.shape, generator=generator, device=a.device)
            ou = ou + self.ou_theta * (-ou) + self.ou_sigma * drift
            noise = self.ou_base_scale * float(state["scale"]) * ou * module._t("scale", obs)
            a = torch.clamp(a + noise, module._t("act_low", obs), module._t("act_high", obs))
            new_state = dict(state, ou=ou)
        value = module.q_values(params["q1"], obs, a)
        return a, _zeros(a), value, a, new_state


class ParameterNoise(Exploration):
    """Adaptive parameter-space noise (reference:
    `rllib/utils/exploration/parameter_noise.py`, Plappert et al. 2018):
    the ROLLOUT acts greedily under weights perturbed once per weight sync
    with N(0, stddev) — exploration comes from a consistently-different
    policy rather than per-step action dithering. Learner weights are never
    perturbed; each sync draws a fresh perturbation."""

    def __init__(self, stddev: float = 0.05):
        self.stddev = float(stddev)

    def on_weights(self, params, generator):
        def perturb(leaf):
            if not leaf.is_floating_point():
                return leaf
            return leaf + self.stddev * torch.randn(leaf.shape, generator=generator,
                                                    device=leaf.device)

        return tree_map(perturb, params)

    def actions(self, module, params, obs, generator, explore, state):
        # Greedy under the (already-perturbed) rollout params.
        a, logp, v, d = module.action_dist(params, obs, generator, False)
        return a, logp, v, d, state


_STRATEGIES = {
    "EpsilonGreedy": EpsilonGreedy,
    "SoftQ": SoftQ,
    "StochasticSampling": StochasticSampling,
    "Random": Random,
    "GaussianNoise": GaussianNoise,
    "OrnsteinUhlenbeckNoise": OrnsteinUhlenbeckNoise,
    "ParameterNoise": ParameterNoise,
}


def build_exploration(spec: Any) -> Optional[Exploration]:
    """Resolve an exploration spec: None, an Exploration instance, or a dict
    {"type": <name-or-class>, **kwargs} (the reference's exploration_config
    format, `rllib/utils/exploration/exploration.py from_config`)."""
    if spec is None or isinstance(spec, Exploration):
        return spec
    if isinstance(spec, type) and issubclass(spec, Exploration):
        return spec()
    if isinstance(spec, dict):
        spec = dict(spec)
        typ = spec.pop("type", None)
        if typ is None:
            raise ValueError("exploration_config requires a 'type' key")
        if isinstance(typ, str):
            if typ not in _STRATEGIES:
                raise ValueError(
                    f"unknown exploration type {typ!r}; one of {sorted(_STRATEGIES)}"
                )
            typ = _STRATEGIES[typ]
        return typ(**spec)
    raise TypeError(f"unsupported exploration spec: {type(spec)}")
