"""PPO: Proximal Policy Optimization on the TorchLearner stack.

The counterpart of ``ray_tpu/rllib/algorithms/ppo.py``; reference:
`rllib/algorithms/ppo/ppo.py:56` (PPOConfig) and the loss in
`rllib/algorithms/ppo/ppo_torch_policy.py` (clipped surrogate over
logp_ratio, KL(prev||curr) from stored behavior dist inputs, clipped value
loss, entropy bonus); adaptive KL rule from `rllib/policy/torch_mixins.py:87`
(coeff *= 1.5 above 2*target, *= 0.5 below target/2).

The loss (policy forward, surrogate, KL, value loss) runs on the learner's
device; GAE postprocessing stays on the host (numpy over the (T, N) rollout
buffers), as in the JAX package.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import adam


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lambda_ = 0.95
        self.kl_coeff = 0.2
        self.kl_target = 0.01
        self.clip_param = 0.3
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.minibatch_size = 128
        self.num_epochs = 4
        self.grad_clip = 0.5
        self.use_critic = True
        self._algo_cls = PPO

    def training(self, **kwargs) -> "PPOConfig":
        # Accept the reference's old-stack names as aliases.
        aliases = {"sgd_minibatch_size": "minibatch_size", "num_sgd_iter": "num_epochs"}
        kwargs = {aliases.get(k, k): v for k, v in kwargs.items()}
        super().training(**kwargs)
        return self


def compute_gae(
    rollout: Dict[str, np.ndarray], gamma: float, lambda_: float
) -> Dict[str, np.ndarray]:
    """GAE(lambda) over a (T, N) rollout fragment with bootstrapped tails.

    Reference semantics: `rllib/evaluation/postprocessing.py`
    (`compute_advantages`) — advantages from reversed TD(lambda) residuals,
    value targets = advantages + values.
    """
    rewards, values, dones = rollout["rewards"], rollout["values"], rollout["dones"]
    # Truncation (time limit) is not termination: the advantage chain still
    # stops at the boundary, but the TD residual bootstraps through
    # V(final_obs) instead of zero. Rollouts lacking the split fall back to
    # treating every done as terminal.
    terminateds = rollout.get("terminateds")
    boot = rollout.get("bootstrap_values")
    if terminateds is None or boot is None:
        terminateds, boot = dones, None
    T = rewards.shape[0]
    adv = np.zeros_like(rewards)
    lastgaelam = np.zeros(rewards.shape[1], np.float32)
    for t in reversed(range(T)):
        next_values = rollout["last_values"] if t == T - 1 else values[t + 1]
        if boot is not None:
            truncated = dones[t] * (1.0 - terminateds[t])
            next_values = np.where(truncated > 0, boot[t], next_values)
        nonterminal = 1.0 - terminateds[t]
        delta = rewards[t] + gamma * next_values * nonterminal - values[t]
        lastgaelam = delta + gamma * lambda_ * (1.0 - dones[t]) * lastgaelam
        adv[t] = lastgaelam
    return {"advantages": adv, "value_targets": adv + values}


def _flatten(rollout: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """(T, N, ...) buffers -> (T*N, ...) flat transition batch."""
    out = {}
    for k, v in rollout.items():
        if k in ("last_values", "last_obs"):
            continue
        out[k] = v.reshape((-1,) + v.shape[2:])
    return out


def make_ppo_loss(config: PPOConfig) -> Callable:
    """(module, params, batch) -> (loss, aux) for TorchLearner."""
    clip = config.clip_param
    vf_clip = config.vf_clip_param
    vf_coeff = config.vf_loss_coeff
    ent_coeff = config.entropy_coeff
    use_critic = config.use_critic

    def loss(module, params, batch):
        logits, values = module.forward(params, batch["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        curr_logp = torch.gather(logp_all, -1, batch["actions"][..., None])[..., 0]
        logp_ratio = torch.exp(curr_logp - batch["logp"])
        adv = batch["advantages"]
        surrogate = torch.minimum(
            adv * logp_ratio,
            adv * torch.clamp(logp_ratio, 1.0 - clip, 1.0 + clip),
        )
        # True KL(prev || curr) over the categorical dist, from the behavior
        # logits the runner stored (= reference's ACTION_DIST_INPUTS path).
        prev_logp_all = F.log_softmax(batch["behavior_logits"], dim=-1)
        kl = torch.sum(torch.exp(prev_logp_all) * (prev_logp_all - logp_all), dim=-1)
        mean_kl = torch.mean(kl)
        entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
        mean_entropy = torch.mean(entropy)
        if use_critic:
            vf_err = torch.square(values - batch["value_targets"])
            mean_vf = torch.mean(torch.clamp(vf_err, 0.0, vf_clip))
        else:
            mean_vf = torch.zeros((), device=logits.device)
        # kl_coeff rides in the batch (per-row broadcast scalar), as in the
        # JAX package, where it spares a recompile.
        kl_coeff = torch.mean(batch["kl_coeff"])
        policy_loss = -torch.mean(surrogate)
        total = (
            policy_loss
            + kl_coeff * mean_kl
            + vf_coeff * mean_vf
            - ent_coeff * mean_entropy
        )
        aux = {
            "policy_loss": policy_loss,
            "vf_loss": mean_vf,
            "mean_kl": mean_kl,
            "entropy": mean_entropy,
        }
        return total, aux

    return loss


class PPO(Algorithm):
    # PPO bootstraps truncations through runner-side values (bootstrap_values)
    # and never reads final_obs: skip shipping the obs-sized buffer.
    _record_final_obs = False
    # Policy-map training via MultiAgentEnvRunner (reference: PPO rides the
    # generic multi-agent machinery in `rollout_worker.py`).
    _supports_multi_agent = True

    def __init__(self, config: PPOConfig):
        super().__init__(config)
        if self.is_multi_agent:
            self.kl_coeff = {pid: float(config.kl_coeff) for pid in self.modules}
        else:
            self.kl_coeff = float(config.kl_coeff)

    def make_loss(self) -> Callable:
        return make_ppo_loss(self.config)

    def make_optimizer(self):
        return adam(self.config.lr, grad_clip=self.config.grad_clip)

    # ----------------------------------------------------------- one iteration
    def _sgd_epochs(self, learner_group, batch: Dict[str, np.ndarray],
                    kl_coeff: float) -> Tuple[Dict[str, float], float]:
        """Multi-epoch minibatch SGD on one flat batch; returns (mean metrics,
        KL sampled over the final epoch)."""
        cfg = self.config
        a = batch["advantages"]
        batch["advantages"] = (a - a.mean()) / max(1e-4, a.std())
        B = len(batch["advantages"])
        mb = min(cfg.minibatch_size, B)
        if cfg.num_learners > 1:
            mb = max(cfg.num_learners, mb - mb % cfg.num_learners)
        if mb > B:
            raise ValueError(
                f"train batch of {B} rows is smaller than num_learners="
                f"{cfg.num_learners}; sample more steps per iteration"
            )
        metrics_acc: List[Dict[str, float]] = []
        rng = np.random.default_rng(cfg.seed + self.iteration)
        mb_per_epoch = 0
        for epoch in range(cfg.num_epochs):
            perm = rng.permutation(B)
            mb_per_epoch = 0
            for start in range(0, B - mb + 1, mb):
                idx = perm[start : start + mb]
                minibatch = {k: v[idx] for k, v in batch.items()}
                minibatch["kl_coeff"] = np.full(mb, kl_coeff, np.float32)
                metrics_acc.append(learner_group.update(minibatch))
                mb_per_epoch += 1
        out = {
            k: float(np.mean([m[k] for m in metrics_acc])) for k in metrics_acc[0]
        }
        sampled_kl = float(
            np.mean([m["mean_kl"] for m in metrics_acc[-mb_per_epoch:]])
        )
        out["num_env_steps_trained"] = B
        out["num_learner_updates"] = len(metrics_acc)
        return out, sampled_kl

    def _adapt_kl(self, sampled_kl: float, current: float) -> float:
        """`torch_mixins.py:87` rule: *=1.5 above 2*target, *=0.5 below /2."""
        target = self.config.kl_target
        if sampled_kl > 2.0 * target:
            return current * 1.5
        if sampled_kl < 0.5 * target:
            return current * 0.5
        return current

    def _training_step_multi_agent(self) -> Dict[str, Any]:
        import ray_tpu_torch

        cfg = self.config
        weights = self.policy_weights()
        ray_tpu_torch.get([r.set_weights.remote(weights) for r in self.env_runners])
        t0 = time.perf_counter()
        samples = ray_tpu_torch.get([r.sample.remote() for r in self.env_runners])
        out: Dict[str, Any] = {"sample_time_s": time.perf_counter() - t0}
        total_steps = 0
        train_set = cfg.policies_to_train or list(self.learner_groups)
        t0 = time.perf_counter()
        for pid, lg in self.learner_groups.items():
            chunks = [s[pid] for s in samples if pid in s]
            if not chunks:
                continue
            batch = {
                k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]
            }
            total_steps += len(batch["advantages"])
            if pid not in train_set:
                continue
            metrics, sampled_kl = self._sgd_epochs(lg, batch, self.kl_coeff[pid])
            self.kl_coeff[pid] = self._adapt_kl(sampled_kl, self.kl_coeff[pid])
            metrics["kl_coeff"] = self.kl_coeff[pid]
            for k, v in metrics.items():
                out[f"policy_{pid}/{k}"] = v
        out["learn_time_s"] = time.perf_counter() - t0
        out["num_learner_updates"] = sum(
            v for k, v in out.items() if k.endswith("/num_learner_updates"))
        out["num_env_steps_sampled"] = total_steps
        return self.collect_episode_metrics(out)

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch

        if self.is_multi_agent:
            return self._training_step_multi_agent()
        cfg = self.config
        # 1. Push current weights to all samplers.
        weights = self.learner_group.get_weights()
        ray_tpu_torch.get([r.set_weights.remote(weights) for r in self.env_runners])
        # 2. Parallel rollouts.
        t0 = time.perf_counter()
        rollouts = ray_tpu_torch.get([r.sample.remote() for r in self.env_runners])
        sample_s = time.perf_counter() - t0
        # 3. GAE on the host, then one flat train batch.
        flats: List[Dict[str, np.ndarray]] = []
        for ro in rollouts:
            ro = dict(ro)
            ro.update(compute_gae(ro, cfg.gamma, cfg.lambda_))
            flats.append(_flatten(ro))
        # Only the keys the loss consumes ride into the update.
        keys = (
            "obs",
            "actions",
            "logp",
            "behavior_logits",
            "advantages",
            "value_targets",
        )
        batch = {k: np.concatenate([f[k] for f in flats]) for k in keys}
        B = len(batch["advantages"])
        # 4. Standardized advantages + multi-epoch minibatch SGD, then the
        # adaptive KL update on the final epoch's sampled KL.
        t0 = time.perf_counter()
        out, sampled_kl = self._sgd_epochs(self.learner_group, batch, self.kl_coeff)
        out["learn_time_s"], out["sample_time_s"] = time.perf_counter() - t0, sample_s
        self.kl_coeff = self._adapt_kl(sampled_kl, self.kl_coeff)
        out["kl_coeff"] = self.kl_coeff
        out["num_env_steps_sampled"] = B
        return self.collect_episode_metrics(out)

    # -------------------------------------------------------------- checkpoint
    def _extra_state(self) -> Dict[str, Any]:
        return {"kl_coeff": self.kl_coeff}

    def _load_extra_state(self, state: Dict[str, Any]) -> None:
        kl = state.get("kl_coeff", self.config.kl_coeff)
        self.kl_coeff = dict(kl) if isinstance(kl, dict) else float(kl)
