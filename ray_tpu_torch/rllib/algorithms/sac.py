"""SAC: soft actor-critic with twin critics, auto-tuned temperature, and
polyak-averaged target networks — the continuous-control algorithm of the zoo.

The counterpart of ``ray_tpu/rllib/algorithms/sac.py``; reference:
`rllib/algorithms/sac/sac.py` (SACConfig: `twin_q=True, tau=5e-3,
initial_alpha=1.0, target_entropy="auto" -> -act_dim, n_step=1`) and the loss
in `sac_torch_policy.py` (critic: mse on Q - y with
y = r + gamma * (min twin target Q - alpha * logp(a'|s')); actor:
alpha * logp(a|s) - min Q(s, a) with reparameterized a; alpha:
-log_alpha * (logp + target_entropy)).

All three objectives (critic, actor, temperature) are ONE loss over a single
params tree, with detached tensors carving the per-objective dependency
structure the reference expresses through three separate optimizers, as in
the JAX package. The polyak target blend runs on the learner's device after
each step (the learner's `extra_update_fn`), so the targets never visit the
host. Policy noise is pre-drawn on the host from the JAX package's numpy
stream and rides in the batch, so an update matches the JAX one to float
tolerance. A policy map (``.multi_agent()``) trains one such learner per
policy, each with its own buffer and targets.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.models.training import tree_map
from ray_tpu_torch.rllib.algorithms.a2c import sample_rollouts
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN
from ray_tpu_torch.rllib.core.learner import adam
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.gamma = 0.99
        self.tau = 5e-3
        self.buffer_capacity = 100_000
        self.learning_starts = 1_000
        self.train_batch_size = 256
        self.updates_per_iteration = 64
        self.target_entropy: Optional[float] = None  # None -> -act_dim
        self.grad_clip = 10.0
        self.model = {"hiddens": (256, 256)}
        self._algo_cls = SAC


def detached(tree):
    """A tree's tensors cut from the graph (the JAX package's stop_gradient)."""
    return tree_map(lambda t: t.detach(), tree)


def make_sac_loss(config: SACConfig, target_entropy: float) -> Callable:
    gamma = config.gamma

    def loss(module, params, batch, extra):
        alpha = torch.exp(params["log_alpha"])
        obs, actions = batch["obs"], batch["actions"]

        # --- critic: y from target twins and a fresh next action ------------
        with torch.no_grad():
            a_next, logp_next = module.sample(params, batch["next_obs"], batch["noise_next"])
            q1t = module.q_values(extra["q1"], batch["next_obs"], a_next)
            q2t = module.q_values(extra["q2"], batch["next_obs"], a_next)
            y = batch["rewards"] + gamma * (1.0 - batch["terminateds"]) * (
                torch.minimum(q1t, q2t) - alpha * logp_next)
        q1 = module.q_values(params["q1"], obs, actions)
        q2 = module.q_values(params["q2"], obs, actions)
        # loss_weight zeroes rows whose TD target is invalid (a truncated tail
        # with no recorded final obs); the actor/alpha terms keep them.
        if "loss_weight" in batch:
            w = batch["loss_weight"]
            denom = torch.clamp(torch.sum(w), min=1.0)
            critic_loss = (torch.sum(w * torch.square(q1 - y)) / denom
                           + torch.sum(w * torch.square(q2 - y)) / denom)
        else:
            critic_loss = torch.mean(torch.square(q1 - y)) + torch.mean(torch.square(q2 - y))

        # --- actor: reparameterized a through frozen critics ----------------
        a_pi, logp_pi = module.sample(params, obs, batch["noise_pi"])
        q_pi = torch.minimum(
            module.q_values(detached(params["q1"]), obs, a_pi),
            module.q_values(detached(params["q2"]), obs, a_pi),
        )
        actor_loss = torch.mean(alpha.detach() * logp_pi - q_pi)

        # --- temperature -----------------------------------------------------
        alpha_loss = -torch.mean(params["log_alpha"] * (logp_pi + target_entropy).detach())

        total = critic_loss + actor_loss + alpha_loss
        aux = {
            "critic_loss": critic_loss,
            "actor_loss": actor_loss,
            "alpha_loss": alpha_loss,
            "alpha": alpha,
            "q_mean": torch.mean(q1),
            "logp_pi_mean": torch.mean(logp_pi),
        }
        return total, aux

    return loss


def make_polyak(tau: float, towers) -> Callable:
    """(new_params, extra) -> extra blended toward the online ``towers`` by
    ``tau``: target = (1 - tau) * target + tau * online."""

    def polyak(new_params, extra):
        online = {k: new_params[k] for k in towers}
        return tree_map(lambda t, o: (1.0 - tau) * t + tau * o, extra, online)

    return polyak


def squashed_gaussian_module(algo: Algorithm, obs_dim: int, act_space):
    """SAC's and CQL's module from the catalog; sets the loss's target
    entropy (-act_dim unless the config names one)."""
    from ray_tpu_torch.rllib.models.catalog import ModelCatalog

    algo._target_entropy = (
        algo.config.target_entropy
        if algo.config.target_entropy is not None
        else -float(np.prod(act_space.shape))
    )
    return ModelCatalog.get_module("squashed_gaussian", obs_dim, act_space, algo.config.model)


def replay_updates(algo: Algorithm, out: Dict[str, Any], add_columns: Callable) -> Dict[str, Any]:
    """``updates_per_iteration`` learner updates on replayed batches once the
    buffer holds ``learning_starts`` rows; ``add_columns(batch)`` adds the
    host-drawn columns of each. Their mean metrics into ``out``."""
    cfg = algo.config
    if algo.buffer.size < cfg.learning_starts:
        return out
    t0 = time.perf_counter()
    metrics_acc: List[Dict[str, float]] = []
    for _ in range(cfg.updates_per_iteration):
        batch = algo.buffer.sample(cfg.train_batch_size, algo._rng)
        add_columns(batch)
        metrics_acc.append(algo.learner_group.update(batch))
        algo.num_updates += 1
    out.update({k: float(np.mean([m[k] for m in metrics_acc])) for k in metrics_acc[0]})
    out["learn_time_s"] = time.perf_counter() - t0
    out["num_learner_updates"] = len(metrics_acc)
    return out


def sample_into_buffer(algo: Algorithm) -> Dict[str, Any]:
    """One rollout fragment from each runner into the replay buffer."""
    rollouts, sample_s = sample_rollouts(algo)
    for ro in rollouts:
        algo.buffer.add(DQN._transitions(ro))
        algo.env_steps += int(ro["rewards"].size)
    return {"buffer_size": algo.buffer.size, "num_env_steps_sampled": algo.env_steps,
            "sample_time_s": sample_s}


class SAC(Algorithm):
    # Policy-map training via MultiAgentEnvRunner's replay mode (continuous
    # Box agents; per-policy buffers/targets).
    _supports_multi_agent = True

    def __init__(self, config: SACConfig):
        super().__init__(config)
        self.num_updates = 0
        self.env_steps = 0
        self._rng = np.random.default_rng(config.seed)
        # Target twins start as copies of the online critics.
        if self.is_multi_agent:
            self.buffers = {pid: ReplayBuffer(config.buffer_capacity) for pid in self.modules}
            groups = self.learner_groups.values()
        else:
            self.buffer = ReplayBuffer(config.buffer_capacity)
            groups = [self.learner_group]
        for lg in groups:
            w = lg.get_weights()
            lg.set_extra({"q1": w["q1"], "q2": w["q2"]})

    def make_module_continuous(self, obs_dim: int, act_space):
        # Multi-agent note: make_loss() reads the LAST target entropy set
        # here; with heterogeneous Box shapes across policies, pass an
        # explicit config.target_entropy.
        return squashed_gaussian_module(self, obs_dim, act_space)

    def make_module(self, obs_dim: int, num_actions: int):
        raise NotImplementedError(
            "SAC in this build targets continuous (Box) action spaces"
        )

    def make_loss(self) -> Callable:
        return make_sac_loss(self.config, self._target_entropy)

    def make_optimizer(self):
        return adam(self.config.lr, grad_clip=self.config.grad_clip)

    def make_extra_update(self) -> Callable:
        return make_polyak(self.config.tau, ("q1", "q2"))

    # ----------------------------------------------------------- one iteration
    def _add_noise(self, batch: Dict[str, np.ndarray], module=None) -> None:
        B, act_dim = len(batch["rewards"]), (module or self.module).act_dim
        batch["noise_next"] = self._rng.standard_normal((B, act_dim)).astype(np.float32)
        batch["noise_pi"] = self._rng.standard_normal((B, act_dim)).astype(np.float32)

    def _training_step_multi_agent(self) -> Dict[str, Any]:
        from ray_tpu_torch.rllib.algorithms.dqn import replay_ma_training_step

        return replay_ma_training_step(
            self, batch_extras=lambda pid, batch: self._add_noise(batch, self.modules[pid]))

    def training_step(self) -> Dict[str, Any]:
        if self.is_multi_agent:
            return self._training_step_multi_agent()
        out = sample_into_buffer(self)
        return self.collect_episode_metrics(replay_updates(self, out, self._add_noise))

    # -------------------------------------------------------------- checkpoint
    def _extra_state(self) -> Dict[str, Any]:
        if self.is_multi_agent:
            targets = {pid: lg.get_extra() for pid, lg in self.learner_groups.items()}
        else:
            targets = self.learner_group.get_extra()
        return {
            "targets": targets,
            "num_updates": self.num_updates,
            "env_steps": self.env_steps,
        }

    def _load_extra_state(self, state: Dict[str, Any]) -> None:
        if state.get("targets") is not None:
            if self.is_multi_agent:
                for pid, lg in self.learner_groups.items():
                    lg.set_extra(state["targets"][pid])
            else:
                self.learner_group.set_extra(state["targets"])
        self.num_updates = int(state.get("num_updates", 0))
        self.env_steps = int(state.get("env_steps", 0))
