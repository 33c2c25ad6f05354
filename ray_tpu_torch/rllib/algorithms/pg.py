"""PG: vanilla policy gradient (REINFORCE).

The counterpart of ``ray_tpu/rllib/algorithms/pg.py``; reference:
`rllib/algorithms/pg/pg.py` + `pg_torch_policy.py` — loss is
-mean(logp * cumulative_discounted_return); no critic, no clipping. The
return computation reuses MARWIL's episode-boundary-aware Monte-Carlo
accumulation; returns are batch-standardized as a variance-reducing
baseline (the reference leaves standardization to `post_process_advantages`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.a2c import categorical_terms, sample_rollouts, timed_update
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.marwil import compute_returns


class PGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 4e-3
        self.entropy_coeff = 0.0
        # REINFORCE consumes COMPLETE episodes (the reference uses
        # batch_mode="complete_episodes"); with fixed-fragment runners the
        # fragment must cover the env's episode length or long (good!)
        # episodes get discarded and training plateaus near the fragment
        # size. Default high; match it to your env's time limit.
        self.rollout_fragment_length = 512
        self._algo_cls = PG


def make_pg_loss(config: PGConfig) -> Callable:
    ent_coeff = config.entropy_coeff

    def loss(module, params, batch):
        logp, entropy, _, _ = categorical_terms(module, params, batch["obs"], batch["actions"])
        pg_loss = -torch.mean(logp * batch["returns"])
        total = pg_loss - ent_coeff * entropy
        return total, {"policy_loss": pg_loss, "entropy": entropy}

    return loss


class PG(Algorithm):
    # No critic: the runner skips value/dist buffers and bootstrap forwards.
    _record_value_extras = False
    _record_final_obs = False

    def make_loss(self) -> Callable:
        return make_pg_loss(self.config)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        rollouts, sample_s = sample_rollouts(self)
        obs, actions, returns = [], [], []
        for ro in rollouts:
            T, N = ro["rewards"].shape
            # Per-env columns are contiguous trajectories; compute returns
            # column-wise with episode cuts, dropping the unfinished tail
            # (REINFORCE needs complete episodes — a truncated tail's return
            # is not observable).
            for env in range(N):
                dones = ro["dones"][:, env]
                last_done = int(np.max(np.nonzero(dones)[0])) if dones.any() else -1
                if last_done < 0:
                    continue
                sl = slice(0, last_done + 1)
                obs.append(ro["obs"][sl, env])
                actions.append(ro["actions"][sl, env])
                returns.append(
                    compute_returns(ro["rewards"][sl, env], dones[sl], cfg.gamma)
                )
        if not obs:
            return self.collect_episode_metrics(
                {"num_env_steps_sampled": 0, "sample_time_s": sample_s})
        batch = {
            "obs": np.concatenate(obs),
            "actions": np.concatenate(actions),
            "returns": np.concatenate(returns).astype(np.float32),
        }
        r = batch["returns"]
        batch["returns"] = (r - r.mean()) / max(1e-4, r.std())
        n = len(r)
        if n > 256:
            # Complete-episode batches vary in size every iteration: trim to
            # a 256 multiple, as the JAX package does to bound its compiles
            # (rows are independent in the REINFORCE loss; the trim discards
            # a few transitions).
            keep = (n // 256) * 256
            batch = {k: v[:keep] for k, v in batch.items()}
        out = timed_update(self, batch, {"sample_time_s": sample_s})
        out["num_env_steps_sampled"] = n
        return self.collect_episode_metrics(out)
