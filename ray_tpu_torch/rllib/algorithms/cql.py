"""CQL: conservative Q-learning — offline continuous-control RL.

The counterpart of ``ray_tpu/rllib/algorithms/cql.py``; reference:
`rllib/algorithms/cql/cql.py` (CQLConfig over SAC: `min_q_weight=5.0,
bc_iters=20000, temperature=1.0, num_actions=10`, offline-only input) and the
loss in `cql_torch_policy.py` (SAC objectives + the CQL(H) regularizer:
logsumexp over Q at sampled actions minus Q at the dataset action, pushing Q
down on out-of-distribution actions so the policy can't exploit
extrapolation error — the reason vanilla SAC diverges offline).

One loss = SAC's critic/actor/temperature terms + the conservative penalty.
The penalty's action samples (uniform random, and fresh policy samples at s
and s') are pre-drawn on the host from the JAX package's numpy stream and
ride the batch as (B, R, act_dim) tensors; the Q towers evaluate the (B, R)
sample fan in one batched matmul per layer. Batches come from
`config.offline_data(input_=)`; no env runner samples for training.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.sac import (
    SACConfig,
    make_polyak,
    make_sac_loss,
    squashed_gaussian_module,
)
from ray_tpu_torch.rllib.core.learner import adam


class CQLConfig(SACConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.min_q_weight = 5.0
        self.cql_num_actions = 4  # R samples per source (random/pi/pi')
        self.train_batch_size = 256
        self.updates_per_iteration = 16
        self.num_env_runners = 0
        self._algo_cls = CQL


def make_cql_loss(config: CQLConfig, target_entropy: float) -> Callable:
    sac_loss = make_sac_loss(config, target_entropy)
    min_q_weight = float(config.min_q_weight)

    def loss(module, params, batch, extra):
        total, aux = sac_loss(module, params, batch, extra)

        # --- conservative penalty (CQL(H)) ---------------------------------
        # Q over the sample fan: uniform-random actions plus fresh policy
        # samples at s and s', importance-corrected (uniform density for the
        # random fan, policy logp for the sampled fans — `cql_torch_policy`).
        B, R, _ = batch["cql_random_actions"].shape
        obs_fan = batch["obs"][:, None, :].expand(B, R, batch["obs"].shape[-1])
        next_fan = batch["next_obs"][:, None, :].expand(B, R, batch["next_obs"].shape[-1])
        a_rand = batch["cql_random_actions"]
        with torch.no_grad():
            a_pi, logp_pi = module.sample(params, obs_fan, batch["cql_noise_pi"])
            a_next, logp_next = module.sample(params, next_fan, batch["cql_noise_next"])
        # log-density of uniform over the action box.
        log_unif = -float(np.sum(np.log(module.act_high - module.act_low + 1e-8)))
        penalties = {}
        for tower in ("q1", "q2"):
            q_rand = module.q_values(params[tower], obs_fan, a_rand)
            q_pi = module.q_values(params[tower], obs_fan, a_pi)
            q_next = module.q_values(params[tower], obs_fan, a_next)
            cat = torch.cat([q_rand - log_unif, q_pi - logp_pi, q_next - logp_next], dim=1)
            lse = torch.logsumexp(cat, dim=1) - float(np.log(3.0 * R))
            q_data = module.q_values(params[tower], batch["obs"], batch["actions"])
            penalties[tower] = torch.mean(lse - q_data)
        cql_term = min_q_weight * (penalties["q1"] + penalties["q2"])
        aux = dict(aux)
        aux["cql_penalty"] = (penalties["q1"] + penalties["q2"]) / 2.0
        return total + cql_term, aux

    return loss


class CQL(Algorithm):
    """Offline: batches come from `config.offline_data(input_=...)` with
    obs/actions/rewards/next_obs (or new_obs)/dones columns; no sampling
    actors are built. `evaluate()` (base Algorithm) rolls the learned policy
    in the config env on dedicated CPU eval runners."""

    _needs_env_runners = False

    def __init__(self, config: CQLConfig):
        super().__init__(config)
        self.reader = config.build_input_reader(
            batch_size=config.train_batch_size, seed=config.seed
        )
        self.num_updates = 0
        self._rng = np.random.default_rng(config.seed)
        w = self.learner_group.get_weights()
        self.learner_group.set_extra({"q1": w["q1"], "q2": w["q2"]})

    def make_module_continuous(self, obs_dim: int, act_space):
        return squashed_gaussian_module(self, obs_dim, act_space)

    def make_module(self, obs_dim: int, num_actions: int):
        raise NotImplementedError("CQL targets continuous (Box) action spaces")

    def make_loss(self) -> Callable:
        return make_cql_loss(self.config, self._target_entropy)

    def make_optimizer(self):
        return adam(self.config.lr, grad_clip=self.config.grad_clip)

    def make_extra_update(self) -> Callable:
        return make_polyak(self.config.tau, ("q1", "q2"))

    # ----------------------------------------------------------- one iteration
    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        act_dim = self.module.act_dim
        low, high = self.module.act_low, self.module.act_high
        R = int(cfg.cql_num_actions)
        metrics_acc: List[Dict[str, float]] = []
        learn_s = 0.0
        for _ in range(max(1, cfg.updates_per_iteration)):
            raw = dict(self.reader.next())
            batch = self._prep_batch(raw, cfg.train_batch_size)
            B = len(batch["rewards"])
            batch["noise_next"] = self._rng.standard_normal(
                (B, act_dim)
            ).astype(np.float32)
            batch["noise_pi"] = self._rng.standard_normal(
                (B, act_dim)
            ).astype(np.float32)
            batch["cql_random_actions"] = self._rng.uniform(
                low, high, (B, R, act_dim)
            ).astype(np.float32)
            batch["cql_noise_pi"] = self._rng.standard_normal(
                (B, R, act_dim)
            ).astype(np.float32)
            batch["cql_noise_next"] = self._rng.standard_normal(
                (B, R, act_dim)
            ).astype(np.float32)
            t0 = time.perf_counter()
            metrics_acc.append(self.learner_group.update(batch))
            learn_s += time.perf_counter() - t0
            self.num_updates += 1
        out = {
            k: float(np.mean([m[k] for m in metrics_acc])) for k in metrics_acc[0]
        }
        out["num_updates"] = self.num_updates
        out["num_env_steps_trained"] = (
            max(1, cfg.updates_per_iteration) * cfg.train_batch_size
        )
        out.update(learn_time_s=learn_s, num_learner_updates=len(metrics_acc))
        return out

    @staticmethod
    def _prep_batch(raw: Dict[str, np.ndarray], batch_size: int) -> Dict[str, np.ndarray]:
        next_obs = raw.get("next_obs", raw.get("new_obs"))
        if next_obs is None:
            raise ValueError(
                "CQL needs next_obs (or new_obs) in the offline data"
            )
        dones = raw.get("terminateds", raw.get("dones"))
        if dones is None:
            raise ValueError("CQL needs terminateds/dones in the offline data")
        batch = {
            "obs": np.asarray(raw["obs"], np.float32),
            "actions": np.asarray(raw["actions"], np.float32),
            "rewards": np.asarray(raw["rewards"], np.float32),
            "next_obs": np.asarray(next_obs, np.float32),
            "terminateds": np.asarray(dones, np.float32),
        }
        n = len(batch["rewards"])
        if n > batch_size:
            batch = {k: v[:batch_size] for k, v in batch.items()}
        return batch

    # -------------------------------------------------------------- checkpoint
    def _extra_state(self) -> Dict[str, Any]:
        return {
            "targets": self.learner_group.get_extra(),
            "num_updates": self.num_updates,
        }

    def _load_extra_state(self, state: Dict[str, Any]) -> None:
        if state.get("targets") is not None:
            self.learner_group.set_extra(state["targets"])
        self.num_updates = int(state.get("num_updates", 0))
