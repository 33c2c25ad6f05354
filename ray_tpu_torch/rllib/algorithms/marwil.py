"""MARWIL: Monotonic Advantage Re-Weighted Imitation Learning (offline RL).

The counterpart of ``ray_tpu/rllib/algorithms/marwil.py``; reference:
`rllib/algorithms/marwil/marwil.py` (MARWILConfig: `beta=1.0, vf_coeff=1.0,
moving_average_sqd_adv_norm_start=100.0,
moving_average_sqd_adv_norm_update_rate=1e-8, lr=1e-4,
train_batch_size=2000`) and the loss in `marwil_torch_policy.py:47-112`:
logp weighted by exp(beta * adv / sqrt(moving-average |adv|^2)), value loss
0.5 * mean(adv^2); beta=0 degenerates to plain behavioral cloning (BC).

The moving-average advantage norm rides INTO the batch as a broadcast scalar
(like PPO's kl_coeff) and the fresh `adv_squared_mean` rides OUT through the
aux; the EMA update stays on the host, as in the JAX package.

Training is purely offline: batches come from `config.offline_data(input_=)`
(JSON-lines episodes) and the card learns from them; Monte-Carlo returns are
computed on the host per batch, resetting at episode boundaries. No env
runner samples for training; `evaluate()` rolls the greedy policy in the
config's env on one CPU actor.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.a2c import categorical_terms
from ray_tpu_torch.rllib.algorithms.algorithm import RUNNER_CPUS, Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import adam


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-4
        self.beta = 1.0
        self.vf_coeff = 1.0
        self.bc_logstd_coeff = 0.0
        self.moving_average_sqd_adv_norm_start = 100.0
        self.moving_average_sqd_adv_norm_update_rate = 1e-8
        self.train_batch_size = 2000
        self.updates_per_iteration = 1
        self.grad_clip: Optional[float] = None
        self.num_env_runners = 0
        self._algo_cls = MARWIL


def compute_returns(
    rewards: np.ndarray, dones: np.ndarray, gamma: float
) -> np.ndarray:
    """Discounted Monte-Carlo return per transition over a flat batch of
    concatenated episode segments; `dones` cuts the accumulation.

    Reference: MARWIL postprocesses with `compute_advantages(..., lambda=1,
    use_gae=False)` — advantages column = discounted return. The final
    segment of a batch always ends done (readers guarantee it)."""
    out = np.zeros_like(rewards, dtype=np.float32)
    acc = 0.0
    for t in reversed(range(len(rewards))):
        # A done row restarts the accumulation with its own reward.
        acc = rewards[t] + gamma * acc * (1.0 - dones[t])
        out[t] = acc
    return out


def make_marwil_loss(config: MARWILConfig) -> Callable:
    """(module, params, batch) -> (loss, aux) for TorchLearner."""
    beta = float(config.beta)
    vf_coeff = float(config.vf_coeff)

    def loss(module, params, batch):
        logp, _, values, _ = categorical_terms(module, params, batch["obs"], batch["actions"])
        if beta != 0.0:
            adv = batch["returns"] - values
            adv_sq_mean = torch.mean(torch.square(adv))
            # The EMA norm enters as a broadcast scalar (host-updated between
            # steps from the adv_squared_mean aux below).
            ma_norm = torch.mean(batch["ma_sqd_adv_norm"])
            exp_advs = torch.exp(beta * adv / (1e-8 + torch.sqrt(ma_norm))).detach()
            v_loss = 0.5 * adv_sq_mean
        else:
            adv_sq_mean = torch.zeros((), device=logp.device)
            exp_advs = 1.0
            v_loss = torch.zeros((), device=logp.device)
        p_loss = -torch.mean(exp_advs * logp)
        total = p_loss + vf_coeff * v_loss
        aux = {
            "policy_loss": p_loss,
            "vf_loss": v_loss,
            "adv_squared_mean": adv_sq_mean,
            "mean_logp": torch.mean(logp),
        }
        return total, aux

    return loss


class MARWIL(Algorithm):
    _needs_env_runners = False

    def __init__(self, config: MARWILConfig):
        super().__init__(config)
        self.reader = config.build_input_reader(
            batch_size=config.train_batch_size, seed=config.seed
        )
        self.ma_sqd_adv_norm = float(config.moving_average_sqd_adv_norm_start)
        self._eval_runner = None

    def make_loss(self) -> Callable:
        return make_marwil_loss(self.config)

    def make_optimizer(self):
        if self.config.grad_clip is not None:
            return adam(self.config.lr, grad_clip=self.config.grad_clip)
        return None

    # ----------------------------------------------------------- one iteration
    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        metrics: Dict[str, float] = {}
        read_s = learn_s = 0.0
        for _ in range(max(1, cfg.updates_per_iteration)):
            t0 = time.perf_counter()
            batch = dict(self.reader.next())
            batch["obs"] = np.asarray(batch["obs"], np.float32)
            batch["actions"] = np.asarray(batch["actions"], np.int64)
            n = len(batch["actions"])
            train = {"obs": batch["obs"], "actions": batch["actions"]}
            if cfg.beta != 0.0:
                if "rewards" not in batch or "dones" not in batch:
                    raise ValueError(
                        "MARWIL (beta != 0) needs rewards + episode boundaries "
                        "(dones) in the offline data to compute returns"
                    )
                train["returns"] = compute_returns(
                    np.asarray(batch["rewards"], np.float32),
                    np.asarray(batch["dones"], np.float32),
                    cfg.gamma,
                )
                train["ma_sqd_adv_norm"] = np.full(
                    n, self.ma_sqd_adv_norm, np.float32
                )
            else:
                # BC's loss reads only obs/actions; the columns keep the
                # JAX package's batch layout.
                train["returns"] = np.zeros(n, np.float32)
                train["ma_sqd_adv_norm"] = np.ones(n, np.float32)
            if n > cfg.train_batch_size:
                # Readers serve whole episodes, so row counts drift batch to
                # batch. Slice AFTER return computation (truncating first
                # would corrupt the Monte-Carlo returns of the kept rows).
                train = {k: v[: cfg.train_batch_size] for k, v in train.items()}
            t1 = time.perf_counter()
            metrics = self.learner_group.update(train)
            learn_s += time.perf_counter() - t1
            read_s += t1 - t0
            if cfg.beta != 0.0:
                # Host-side EMA update (the torch policy keeps this as a
                # buffer; here the loss stays a function of its inputs).
                rate = cfg.moving_average_sqd_adv_norm_update_rate
                self.ma_sqd_adv_norm += rate * (
                    metrics["adv_squared_mean"] - self.ma_sqd_adv_norm
                )
        out = dict(metrics)
        out["ma_sqd_adv_norm"] = self.ma_sqd_adv_norm
        out["num_env_steps_trained"] = (
            max(1, cfg.updates_per_iteration) * cfg.train_batch_size
        )
        out.update(read_time_s=read_s, learn_time_s=learn_s,
                   num_learner_updates=max(1, cfg.updates_per_iteration))
        return out

    # -------------------------------------------------------------- evaluation
    def evaluate(self, num_episodes: int = 10) -> Dict[str, float]:
        """Greedy rollouts in the config env on one CPU runner actor
        (reference: `Algorithm.evaluate` with explore=False)."""
        import ray_tpu_torch
        from ray_tpu_torch.rllib.env.env_runner import EnvRunner

        if self._eval_runner is None:
            self._eval_runner = ray_tpu_torch.remote(EnvRunner).options(
                num_cpus=RUNNER_CPUS).remote(
                self.config.env_creator(),
                self.module,
                num_envs=2,
                rollout_length=256,
                seed=self.config.seed + 424242,
                record_value_extras=False,
                record_final_obs=False,
                num_cpus=RUNNER_CPUS,
            )
        runner = self._eval_runner
        ray_tpu_torch.get([runner.set_weights.remote(self.learner_group.get_weights()),
                           runner.episode_stats.remote(clear=True)])
        stats = {"episodes": 0}
        for _ in range(20):
            runner.sample.remote(explore=False)
            stats = ray_tpu_torch.get(runner.episode_stats.remote(clear=False))
            if stats["episodes"] >= num_episodes:
                break
        return stats

    def stop(self) -> None:
        import ray_tpu_torch

        if self._eval_runner is not None:
            ray_tpu_torch.kill(self._eval_runner)
            self._eval_runner = None
        super().stop()

    # -------------------------------------------------------------- checkpoint
    def _extra_state(self) -> Dict[str, Any]:
        return {"ma_sqd_adv_norm": self.ma_sqd_adv_norm}

    def _load_extra_state(self, state: Dict[str, Any]) -> None:
        self.ma_sqd_adv_norm = float(
            state.get(
                "ma_sqd_adv_norm", self.config.moving_average_sqd_adv_norm_start
            )
        )
