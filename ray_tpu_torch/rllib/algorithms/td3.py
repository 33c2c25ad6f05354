"""TD3: twin-delayed deep deterministic policy gradient (continuous control).

The counterpart of ``ray_tpu/rllib/algorithms/td3.py``; reference:
`rllib/algorithms/td3/td3.py` (TD3Config over DDPG:
`twin_q=True, policy_delay=2, smooth_target_policy=True,
target_noise=0.2, target_noise_clip=0.5, critic_lr=1e-3, actor_lr=1e-3,
tau=5e-3`) and the loss in `ddpg_torch_policy.py` (critic: mse on
Q(s,a) - y with y = r + gamma * min twin target Q(s', pi_t(s') + clipped
noise); actor: -Q1(s, pi(s)); delayed policy updates). DDPG is the
degenerate config (policy_delay=1, no smoothing).

Both objectives are ONE loss with detached tensors carving the
actor/critic split; the delayed policy update rides as a 0/1 `actor_weight`
batch column, as in the JAX package; target policy smoothing noise is
pre-drawn on the host and clipped inside the loss; the three target nets are
the learner's `extra` state, blended after each step on its device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.sac import (
    detached,
    make_polyak,
    replay_updates,
    sample_into_buffer,
)
from ray_tpu_torch.rllib.core.learner import adam
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer


class TD3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.gamma = 0.99
        self.tau = 5e-3
        self.buffer_capacity = 100_000
        self.learning_starts = 1_000
        self.train_batch_size = 128
        self.updates_per_iteration = 64
        self.policy_delay = 2
        self.target_noise = 0.2
        self.target_noise_clip = 0.5
        self.explore_noise = 0.1
        self.grad_clip = 10.0
        self.model = {"hiddens": (256, 256)}
        self._algo_cls = TD3

    def training(self, **kwargs) -> "TD3Config":
        aliases = {"smooth_target_policy": None}  # accepted, always on
        kwargs = {k: v for k, v in kwargs.items() if k not in aliases}
        super().training(**kwargs)
        return self


def make_td3_loss(config: TD3Config) -> Callable:
    gamma = config.gamma
    noise_clip = float(config.target_noise_clip)

    def loss(module, params, batch, extra):
        obs = batch["obs"]
        low, high = module._t("act_low", obs), module._t("act_high", obs)

        # --- critic: smoothed deterministic target action ------------------
        with torch.no_grad():
            smooth = torch.clamp(batch["target_noise"], -noise_clip, noise_clip)
            # `extra` is params-shaped ({"pi","q1","q2"}): module.pi reads its
            # "pi" tower directly.
            a_next = torch.clamp(
                module.pi(extra, batch["next_obs"]) + smooth * module._t("scale", obs), low, high)
            q1t = module.q_values(extra["q1"], batch["next_obs"], a_next)
            q2t = module.q_values(extra["q2"], batch["next_obs"], a_next)
            y = batch["rewards"] + gamma * (1.0 - batch["terminateds"]) * torch.minimum(q1t, q2t)
        q1 = module.q_values(params["q1"], obs, batch["actions"])
        q2 = module.q_values(params["q2"], obs, batch["actions"])
        critic_loss = torch.mean(torch.square(q1 - y)) + torch.mean(torch.square(q2 - y))

        # --- actor: through frozen critics, gated by the delay column ------
        a_pi = module.pi(params, obs)
        actor_obj = -torch.mean(module.q_values(detached(params["q1"]), obs, a_pi))
        # actor_weight is all-ones on policy-update rounds, all-zeros
        # otherwise (a per-row column, so a learner gang's row split works).
        actor_gate = torch.mean(batch["actor_weight"])
        total = critic_loss + actor_gate * actor_obj
        aux = {
            "critic_loss": critic_loss,
            "actor_loss": actor_obj,
            "q_mean": torch.mean(q1),
            "td_error_mean": torch.mean(torch.abs(q1 - y)),
        }
        return total, aux

    return loss


class TD3(Algorithm):
    def __init__(self, config: TD3Config):
        super().__init__(config)
        self.buffer = ReplayBuffer(config.buffer_capacity)
        self.num_updates = 0
        self.env_steps = 0
        self._rng = np.random.default_rng(config.seed)
        # Targets start as copies of the online nets (all three towers).
        w = self.learner_group.get_weights()
        self.learner_group.set_extra({"pi": w["pi"], "q1": w["q1"], "q2": w["q2"]})

    def make_module_continuous(self, obs_dim: int, act_space):
        from ray_tpu_torch.rllib.models.catalog import ModelCatalog

        module = ModelCatalog.get_module(
            "deterministic_continuous", obs_dim, act_space, self.config.model
        )
        module.explore_noise = float(self.config.explore_noise)
        return module

    def make_module(self, obs_dim: int, num_actions: int):
        raise NotImplementedError(
            "TD3 targets continuous (Box) action spaces"
        )

    def make_loss(self) -> Callable:
        return make_td3_loss(self.config)

    def make_optimizer(self):
        return adam(self.config.lr, grad_clip=self.config.grad_clip)

    def make_extra_update(self) -> Callable:
        return make_polyak(self.config.tau, ("pi", "q1", "q2"))

    # ----------------------------------------------------------- one iteration
    def _add_columns(self, batch: Dict[str, np.ndarray]) -> None:
        cfg = self.config
        B = len(batch["rewards"])
        batch["target_noise"] = (
            self._rng.standard_normal((B, self.module.act_dim)).astype(np.float32)
            * cfg.target_noise
        )
        gate = 1.0 if self.num_updates % cfg.policy_delay == 0 else 0.0
        batch["actor_weight"] = np.full(B, gate, np.float32)

    def training_step(self) -> Dict[str, Any]:
        out = sample_into_buffer(self)
        return self.collect_episode_metrics(replay_updates(self, out, self._add_columns))

    # -------------------------------------------------------------- checkpoint
    def _extra_state(self) -> Dict[str, Any]:
        return {
            "targets": self.learner_group.get_extra(),
            "num_updates": self.num_updates,
            "env_steps": self.env_steps,
        }

    def _load_extra_state(self, state: Dict[str, Any]) -> None:
        if state.get("targets") is not None:
            self.learner_group.set_extra(state["targets"])
        self.num_updates = int(state.get("num_updates", 0))
        self.env_steps = int(state.get("env_steps", 0))


class DDPGConfig(TD3Config):
    """DDPG as the degenerate TD3 (reference: `rllib/algorithms/ddpg/` —
    TD3 is DDPG + twin critics + delay + smoothing; running TD3's machinery
    with policy_delay=1 and no smoothing noise recovers DDPG's update)."""

    def __init__(self):
        super().__init__()
        self.policy_delay = 1
        self.target_noise = 0.0
        self.target_noise_clip = 0.0
