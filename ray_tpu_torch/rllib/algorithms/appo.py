"""APPO: Asynchronous PPO — IMPALA's V-trace chassis + PPO's clipped
surrogate against a lagging target policy.

The counterpart of ``ray_tpu/rllib/algorithms/appo.py``; reference:
`rllib/algorithms/appo/appo.py:39` (APPOConfig(ImpalaConfig):
`clip_param=0.4, use_kl_loss=False, kl_coeff=1.0, kl_target=0.01, tau=1.0,
target_update_frequency=1`) and the loss in `appo_torch_policy.py:171-266`:
V-trace computed with the TARGET network as the target policy
(rho = pi_target/mu), `is_ratio = clamp(mu/pi_target, 0, 2)`,
`logp_ratio = is_ratio * pi/mu`, clipped surrogate, optional
KL(target || current), value loss vs the V-trace targets; target network
refreshed every `target_update_frequency` updates by a tau-blend
(`appo.py:117` "updated_param = tau * current + (1 - tau) * target").

The same (N, T) env-major batches and in-loss V-trace as IMPALA; the target
params are the learner's `extra` state on its device, and the tau-blend is
a host-triggered `set_extra`, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.training import tree_map
from ray_tpu_torch.rllib.algorithms.a2c import categorical_terms, timed_update
from ray_tpu_torch.rllib.algorithms.impala import Impala, ImpalaConfig, vtrace


class APPOConfig(ImpalaConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.clip_param = 0.4
        self.use_kl_loss = False
        self.kl_coeff = 1.0
        self.kl_target = 0.01
        self.tau = 1.0
        self.target_update_frequency = 1
        self._algo_cls = APPO


def make_appo_loss(config: APPOConfig) -> Callable:
    """(module, params, batch, target_params) -> (loss, aux)."""
    gamma = config.gamma
    rho_bar = config.vtrace_clip_rho_threshold
    pg_rho_bar = config.vtrace_clip_pg_rho_threshold
    c_bar = config.vtrace_clip_c_threshold
    clip = config.clip_param
    vf_coeff = config.vf_loss_coeff
    ent_coeff = config.entropy_coeff
    use_kl = config.use_kl_loss

    def loss(module, params, batch, target_params):
        obs, actions, behavior_logp = batch["obs"], batch["actions"], batch["logp"]
        curr_logp, entropy, values, logp_all = categorical_terms(module, params, obs, actions)
        # Old (lagging target) policy: gradients never flow into it.
        with torch.no_grad():
            t_logp_all = F.log_softmax(module.forward(target_params, obs)[0], dim=-1)
            old_logp = torch.gather(t_logp_all, -1, actions[..., None])[..., 0]

        # V-trace with the target policy as pi (appo_torch_policy.py:208:
        # target_policy_logits = old_policy_behaviour_logits).
        vs, pg_adv, _ = vtrace(module, params, batch, old_logp, values, gamma, rho_bar,
                               pg_rho_bar, c_bar)

        # PPO surrogate with the decoupled importance ratio
        # (appo_torch_policy.py:236-251).
        is_ratio = torch.clamp(torch.exp(behavior_logp - old_logp), 0.0, 2.0)
        logp_ratio = is_ratio * torch.exp(curr_logp - behavior_logp)
        surrogate = torch.minimum(
            pg_adv * logp_ratio,
            pg_adv * torch.clamp(logp_ratio, 1.0 - clip, 1.0 + clip),
        )
        pi_loss = -torch.mean(surrogate)
        vf_loss = 0.5 * torch.mean(torch.square(values - vs))
        # KL(old_policy || current) (appo_torch_policy.py:201).
        kl = torch.mean(torch.sum(torch.exp(t_logp_all) * (t_logp_all - logp_all), dim=-1))
        total = pi_loss + vf_coeff * vf_loss - ent_coeff * entropy
        if use_kl:
            total = total + torch.mean(batch["kl_coeff"]) * kl
        aux = {
            "policy_loss": pi_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_kl": kl,
            "mean_is_ratio": torch.mean(is_ratio),
        }
        return total, aux

    return loss


class APPO(Impala):
    def __init__(self, config: APPOConfig):
        super().__init__(config)
        self.kl_coeff = float(config.kl_coeff)
        self._updates_since_target_sync = 0
        # Target network = initial weights (reference initializes the target
        # model as a copy of the model).
        self.learner_group.set_extra(self.learner_group.get_weights())

    def make_loss(self) -> Callable:
        return make_appo_loss(self.config)

    # ----------------------------------------------------------- one iteration
    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        batch, sample_s = self._sample_env_major_batch()
        N = batch["rewards"].shape[0]
        batch["kl_coeff"] = np.full(N, self.kl_coeff, np.float32)
        out = timed_update(self, batch, {"sample_time_s": sample_s})

        # Adaptive KL (only meaningful when the KL term is in the loss).
        if cfg.use_kl_loss:
            if out["mean_kl"] > 2.0 * cfg.kl_target:
                self.kl_coeff *= 1.5
            elif out["mean_kl"] < 0.5 * cfg.kl_target:
                self.kl_coeff *= 0.5
            out["kl_coeff"] = self.kl_coeff

        # Lagging target refresh (appo.py:117 tau-blend), every
        # `target_update_frequency` updates.
        self._updates_since_target_sync += 1
        if self._updates_since_target_sync >= cfg.target_update_frequency:
            self._updates_since_target_sync = 0
            tau = cfg.tau
            blended = tree_map(
                lambda c, t: tau * np.asarray(c) + (1.0 - tau) * np.asarray(t),
                self.learner_group.get_weights(),
                self.learner_group.get_extra(),
            )
            self.learner_group.set_extra(blended)
            out["num_target_updates"] = 1

        out["num_env_steps_sampled"] = int(batch["rewards"].size)
        return self.collect_episode_metrics(out)

    # -------------------------------------------------------------- checkpoint
    def _extra_state(self) -> Dict[str, Any]:
        return {
            "kl_coeff": self.kl_coeff,
            "target_params": self.learner_group.get_extra(),
        }

    def _load_extra_state(self, state: Dict[str, Any]) -> None:
        self.kl_coeff = float(state.get("kl_coeff", self.config.kl_coeff))
        if state.get("target_params") is not None:
            self.learner_group.set_extra(state["target_params"])
