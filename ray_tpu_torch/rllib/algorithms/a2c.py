"""A2C: synchronous advantage actor-critic.

The counterpart of ``ray_tpu/rllib/algorithms/a2c.py``; reference:
`rllib/algorithms/a2c/a2c.py` (A2CConfig — synchronous rollout gather + one
SGD step per iteration on the plain actor-critic loss; `a3c_torch_policy.py`
loss: -logp * advantage + vf_coeff * value_error - entropy_coeff * entropy,
with GAE advantages from postprocessing).

PPO's shape minus the surrogate: GAE on the host, then one gradient step per
batch of gathered rollouts on the learner's device.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import _flatten, compute_gae
from ray_tpu_torch.rllib.core.learner import adam


class A2CConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.lambda_ = 1.0  # reference A2C default: plain returns
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.grad_clip = 40.0
        self._algo_cls = A2C


def categorical_terms(module, params, obs, actions):
    """(log pi(a|s), mean entropy, values, log pi(.|s)) of a policy-value
    module."""
    logits, values = module.forward(params, obs)
    logp_all = F.log_softmax(logits, dim=-1)
    logp = torch.gather(logp_all, -1, actions[..., None])[..., 0]
    entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
    return logp, entropy, values, logp_all


def make_a2c_loss(config: A2CConfig) -> Callable:
    """(module, params, batch) -> (loss, aux) for TorchLearner."""
    vf_coeff = config.vf_loss_coeff
    ent_coeff = config.entropy_coeff

    def loss(module, params, batch):
        logp, entropy, values, _ = categorical_terms(module, params, batch["obs"], batch["actions"])
        pi_loss = -torch.mean(logp * batch["advantages"])
        vf_loss = torch.mean(torch.square(values - batch["value_targets"]))
        total = pi_loss + vf_coeff * vf_loss - ent_coeff * entropy
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss, "entropy": entropy}

    return loss


def sample_rollouts(algo: Algorithm):
    """Push the learner's weights to every runner, then one rollout fragment
    from each: (rollouts, sample seconds)."""
    import ray_tpu_torch

    weights = algo.learner_group.get_weights()
    ray_tpu_torch.get([r.set_weights.remote(weights) for r in algo.env_runners])
    t0 = time.perf_counter()
    rollouts = ray_tpu_torch.get([r.sample.remote() for r in algo.env_runners])
    return rollouts, time.perf_counter() - t0


def timed_update(algo: Algorithm, batch, out: Dict[str, Any]) -> Dict[str, Any]:
    """One learner update on ``batch``; its metrics and learn time into ``out``."""
    t0 = time.perf_counter()
    out.update(algo.learner_group.update(batch))
    out["learn_time_s"] = time.perf_counter() - t0
    out["num_learner_updates"] = 1
    return out


class A2C(Algorithm):
    # Like PPO: truncations bootstrap through runner-side values.
    _record_final_obs = False

    def make_loss(self) -> Callable:
        return make_a2c_loss(self.config)

    def make_optimizer(self):
        return adam(self.config.lr, grad_clip=self.config.grad_clip)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        rollouts, sample_s = sample_rollouts(self)
        flats: List[Dict[str, np.ndarray]] = []
        for ro in rollouts:
            ro = dict(ro)
            ro.update(compute_gae(ro, cfg.gamma, cfg.lambda_))
            flats.append(_flatten(ro))
        keys = ("obs", "actions", "advantages", "value_targets")
        batch = {k: np.concatenate([f[k] for f in flats]) for k in keys}
        a = batch["advantages"]
        batch["advantages"] = (a - a.mean()) / max(1e-4, a.std())
        out = timed_update(self, batch, {"sample_time_s": sample_s})
        out["num_env_steps_sampled"] = len(batch["advantages"])
        return self.collect_episode_metrics(out)
