"""Ape-X DQN: distributed prioritized experience replay.

The counterpart of ``ray_tpu/rllib/algorithms/apex_dqn.py``; reference:
`rllib/algorithms/apex_dqn/apex_dqn.py` (Horgan et al. 2018) — many rollout
workers with per-worker exploration feed sharded replay-buffer ACTORS; the
learner samples from the shards asynchronously and ships new priorities
back; sampling and learning are decoupled (workers are never blocked on the
learner).

Rollout submission is pipelined: one `sample()` in flight per runner;
`ray_tpu_torch.wait` harvests whichever fragments are done, pushes each to a
round-robin replay shard and resubmits that runner. The replay shards and
the runners are CPU actors; the learner is on the GPU in the driver.
Per-worker epsilons follow the reference's `PerWorkerEpsilonGreedy` power
schedule, so exploration diversity comes from the fleet. Priorities refresh
from the per-sample |TD| the learner update itself returns, sent back to the
shard as a numpy array — no extra weight fetch or TD forward per step.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer

# What each replay shard actor holds: one CPU.
SHARD_CPUS = 1


class ApexDQNConfig(DQNConfig):
    def __init__(self):
        super().__init__()
        self.num_env_runners = 2
        self.num_replay_shards = 2
        self.prioritized_replay_alpha = 0.6
        self.prioritized_replay_beta = 0.4
        self.final_prioritized_replay_beta = 1.0
        self.beta_annealing_timesteps = 200_000
        # Per-worker exploration (reference `PerWorkerEpsilonGreedy`):
        # worker i of n holds epsilon = base ** (1 + i/(n-1) * exponent).
        self.per_worker_epsilon_base = 0.4
        self.per_worker_epsilon_exponent = 7.0
        # Max rollout fragments pushed per training_step before learning
        # (bounds driver-side harvest work; extras stay queued).
        self.max_fragments_per_step = 8
        self._algo_cls = ApexDQN


class ReplayShard:
    """Remote actor owning one PrioritizedReplayBuffer shard."""

    def __init__(self, capacity: int, alpha: float, seed: int):
        self.buf = PrioritizedReplayBuffer(capacity, alpha)
        self._rng = np.random.default_rng(seed)

    def add(self, batch: Dict[str, np.ndarray]) -> int:
        self.buf.add(batch)
        return self.buf.size

    def sample(self, batch_size: int, beta: float):
        if self.buf.size < batch_size:
            return None
        return self.buf.sample(batch_size, self._rng, beta=beta)

    def update_priorities(self, idx, priorities) -> None:
        self.buf.update_priorities(idx, priorities)

    def size(self) -> int:
        return self.buf.size

    def stats(self) -> Dict[str, float]:
        return self.buf.stats()

    def placement(self) -> Dict[str, Any]:
        """This shard's process and the GPU ids it sees (none)."""
        import os

        return {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}


class ApexDQN(DQN):
    """DQN with sharded prioritized replay actors + pipelined rollouts."""

    def __init__(self, config: ApexDQNConfig):
        import ray_tpu_torch

        if config.exploration_config is not None:
            # Ape-X's exploration IS the per-worker epsilon power schedule;
            # a strategy would silently swallow the per-worker floats.
            raise ValueError(
                "ApexDQN owns per-worker epsilon-greedy exploration; "
                "exploration_config is not supported (tune "
                "per_worker_epsilon_base/exponent instead)"
            )
        if config.replay_buffer_config is not None:
            # Sharded prioritized replay actors ARE the algorithm; a uniform
            # replay_buffer_config would be silently overridden otherwise.
            raise ValueError(
                "ApexDQN always uses sharded prioritized replay; configure "
                "prioritized_replay_alpha/beta + num_replay_shards instead "
                "of replay_buffer_config"
            )
        Algorithm.__init__(self, config)
        shard_cls = ray_tpu_torch.remote(ReplayShard)
        self.replay_shards: List[Any] = [
            shard_cls.options(num_cpus=SHARD_CPUS).remote(
                max(1, config.buffer_capacity // config.num_replay_shards),
                config.prioritized_replay_alpha,
                config.seed + 77 * i,
            )
            for i in range(config.num_replay_shards)
        ]
        self._shard_rr = 0
        self.num_updates = 0
        self.env_steps = 0
        self._rng = np.random.default_rng(config.seed)
        self._sync_target()
        # One in-flight sample() per runner, resubmitted on harvest — the
        # decoupling that makes Ape-X Ape-X.
        self._pending: Dict[Any, Any] = {}
        self._push_worker_epsilons()

    # ----------------------------------------------------------- exploration
    def worker_epsilons(self) -> List[float]:
        cfg = self.config
        n = max(1, len(self.env_runners))
        if n == 1:
            return [cfg.per_worker_epsilon_base]
        return [
            cfg.per_worker_epsilon_base
            ** (1.0 + (i / (n - 1)) * cfg.per_worker_epsilon_exponent)
            for i in range(n)
        ]

    def _push_worker_epsilons(self) -> None:
        import ray_tpu_torch

        ray_tpu_torch.get(
            [
                r.set_exploration.remote(eps)
                for r, eps in zip(self.env_runners, self.worker_epsilons())
            ]
        )

    def beta(self) -> float:
        from ray_tpu_torch.rllib.utils.exploration import _anneal

        cfg = self.config
        return _anneal(
            cfg.prioritized_replay_beta,
            cfg.final_prioritized_replay_beta,
            cfg.beta_annealing_timesteps,
            self.env_steps,
        )

    # ---------------------------------------------------------- rollout plane
    def _harvest_rollouts(self) -> int:
        """Collect finished fragments, push each to a shard, resubmit the
        runner. Never blocks on stragglers beyond the first fragment."""
        import ray_tpu_torch

        for r in self.env_runners:
            if not any(owner is r for owner in self._pending.values()):
                self._pending[r.sample.remote()] = r
        pushed = 0
        adds = []
        first = True
        while self._pending and pushed < self.config.max_fragments_per_step:
            ready, _ = ray_tpu_torch.wait(
                list(self._pending), num_returns=1, timeout=None if first else 0.0
            )
            if not ready:
                break
            first = False
            for ref in ready:
                runner = self._pending.pop(ref)
                ro = ray_tpu_torch.get(ref)
                trans = self._transitions(
                    ro, self.config.n_step, self.config.gamma
                )
                shard = self.replay_shards[self._shard_rr % len(self.replay_shards)]
                self._shard_rr += 1
                adds.append(shard.add.remote(trans))
                self.env_steps += int(ro["rewards"].size)
                pushed += 1
                self._pending[runner.sample.remote()] = runner
        ray_tpu_torch.get(adds)  # adds are small; the barrier keeps size metrics honest
        return pushed

    # ------------------------------------------------------------ train plane
    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch

        cfg = self.config
        weights = self.learner_group.get_weights()
        # Fire-and-forget: each runner applies the new weights after its
        # in-flight fragment (standard Ape-X staleness). A barrier here would
        # queue behind every runner's pending sample() and re-couple the
        # learner to the slowest runner.
        for r in self.env_runners:
            r.set_weights.remote(weights)
        t0 = time.perf_counter()
        pushed = self._harvest_rollouts()
        sample_s = time.perf_counter() - t0
        beta = self.beta()
        sizes = ray_tpu_torch.get([s.size.remote() for s in self.replay_shards])
        out: Dict[str, Any] = {
            "num_env_steps_sampled": self.env_steps,
            "replay_shard_sizes": sizes,
            "fragments_pushed": pushed,
            "beta": beta,
            "worker_epsilons": self.worker_epsilons(),
            "sample_time_s": sample_s,
        }
        if sum(sizes) < cfg.learning_starts:
            return self.collect_episode_metrics(out)

        t0 = time.perf_counter()
        metrics_acc: List[Dict[str, float]] = []

        # Pipeline: request the NEXT shard's batch while updating on the
        # current one.
        def request(i: int):
            shard = self.replay_shards[i % len(self.replay_shards)]
            return shard, shard.sample.remote(cfg.train_batch_size, beta)

        nxt = request(0)
        for u in range(cfg.updates_per_iteration):
            shard, ref = nxt
            batch = ray_tpu_torch.get(ref)
            if u + 1 < cfg.updates_per_iteration:
                nxt = request(u + 1)
            if batch is None:
                continue
            idx = batch.pop("batch_indexes")
            m = self.learner_group.update(batch)
            td = np.asarray(m.pop("td_abs"))
            metrics_acc.append(m)
            self.num_updates += 1
            # Per-sample |TD| from the update itself -> new shard priorities.
            shard.update_priorities.remote(idx[: len(td)], td)
            if self.num_updates % cfg.target_network_update_freq == 0:
                self._sync_target()
        if metrics_acc:
            out.update(
                {k: float(np.mean([m[k] for m in metrics_acc])) for k in metrics_acc[0]}
            )
            out["num_updates"] = self.num_updates
            out["learn_time_s"] = time.perf_counter() - t0
            out["num_learner_updates"] = len(metrics_acc)
        return self.collect_episode_metrics(out)

    def stop(self) -> None:
        import ray_tpu_torch

        super().stop()
        for s in self.replay_shards:
            ray_tpu_torch.kill(s)
        self.replay_shards = []
