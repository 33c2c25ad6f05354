"""DQN: deep Q-learning with replay, target network, and double-Q targets.

The counterpart of ``ray_tpu/rllib/algorithms/dqn.py``; reference:
`rllib/algorithms/dqn/dqn.py` (DQNConfig: replay buffer,
`target_network_update_freq`, `n_step`, double-Q default) and the TD loss in
`dqn_torch_policy.py` (huber on Q(s,a) - y, y = r + gamma^n * Q_target).

The TD loss runs on the TorchLearner's device; the target network's
parameters are the learner's EXTRA state (`set_extra`), never in the batch,
which a LearnerGroup slices per remote learner. The replay buffer is
host-side numpy in the driver. Exploration is epsilon-greedy with the
schedule held by the driver and pushed to runners.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import _MULTI_AGENT, Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import adam, batch_sum
from ray_tpu_torch.rllib.utils.replay_buffers import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
)


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.buffer_capacity = 50_000
        self.learning_starts = 1_000
        self.train_batch_size = 64
        self.updates_per_iteration = 32
        self.target_network_update_freq = 200  # in learner updates
        self.double_q = True
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 10_000  # env steps
        self.grad_clip = 10.0
        # Rainbow knobs (reference DQNConfig: `n_step`, `num_atoms`,
        # `v_min/v_max`, `dueling` — Rainbow is DQN configuration, not a
        # separate algorithm). n_step > 1 builds n-step returns with per-row
        # bootstrap discounts; num_atoms > 1 switches to the C51 categorical
        # distributional loss on a DistributionalQModule.
        self.n_step = 1
        self.num_atoms = 1
        self.v_min = -10.0
        self.v_max = 10.0
        self.dueling = False
        # None -> uniform ring buffer; {"type": "PrioritizedReplayBuffer",
        # "alpha": .., "beta": ..} -> proportional prioritization with IS
        # weights riding `loss_weight` (reference: DQNConfig
        # `replay_buffer_config`, default MultiAgentPrioritizedReplayBuffer).
        self.replay_buffer_config: Optional[Dict[str, Any]] = None
        self._algo_cls = DQN

    def replay_is_prioritized(self) -> bool:
        rbc = self.replay_buffer_config or {}
        return rbc.get("type") in ("PrioritizedReplayBuffer", PrioritizedReplayBuffer)

    def make_replay_buffer(self) -> ReplayBuffer:
        rbc = self.replay_buffer_config
        if rbc:
            typ = rbc.get("type", "ReplayBuffer")
            if self.replay_is_prioritized():
                return PrioritizedReplayBuffer(
                    self.buffer_capacity, alpha=rbc.get("alpha", 0.6)
                )
            if typ not in ("ReplayBuffer", ReplayBuffer):
                raise ValueError(f"unknown replay buffer type {typ!r}")
        return ReplayBuffer(self.buffer_capacity)

    def training(self, **kwargs) -> "DQNConfig":
        aliases = {"target_update_freq": "target_network_update_freq"}
        kwargs = {aliases.get(k, k): v for k, v in kwargs.items()}
        super().training(**kwargs)
        return self


def _take(x, idx):
    """x[..., idx] per row: x (B, A, ...) at idx (B,) -> (B, ...)."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 1)).expand((-1, 1) + x.shape[2:])
    return torch.gather(x, 1, idx)[:, 0]


def make_dqn_loss(config: DQNConfig) -> Callable:
    """(module, params, batch, extra) -> (loss, aux): huber TD error with
    (double-)Q targets from the target params in the learner's extra state."""
    gamma = config.gamma
    double_q = config.double_q

    def loss(module, params, batch, extra):
        target_params = extra["target_params"]
        q_all, _ = module.forward(params, batch["obs"])
        q_sa = _take(q_all, batch["actions"])
        with torch.no_grad():
            tq_all, _ = module.forward(target_params, batch["next_obs"])
            if double_q:
                # Online net picks the action, target net evaluates it.
                next_q_online, _ = module.forward(params, batch["next_obs"])
                tq = _take(tq_all, torch.argmax(next_q_online, dim=-1))
            else:
                tq = tq_all.amax(dim=-1)
            # n-step batches carry a per-row bootstrap discount (gamma^h, h
            # the realized horizon); 1-step batches use the scalar.
            disc = batch["discount"] if "discount" in batch else gamma
            y = batch["rewards"] + disc * (1.0 - batch["terminateds"]) * tq
        td = q_sa - y
        # loss_weight is all-ones when the runner recorded true final
        # observations (truncated rows bootstrap through them); the fallback
        # in _transitions zero-weights truncated rows instead.
        weight = batch["loss_weight"]
        abs_td = torch.abs(td)
        huber = torch.where(abs_td < 1.0, 0.5 * td * td, abs_td - 0.5)
        denom = torch.clamp(batch_sum(weight), min=1.0)
        total = batch_sum(weight * huber) / denom
        aux = {
            "td_error_mean": batch_sum(weight * abs_td) / denom,
            "q_mean": torch.mean(q_sa),
            # Per-sample |TD| rides out of the SAME update: prioritized
            # replay refreshes priorities from it without a second forward.
            "td_abs": abs_td,
        }
        return total, aux

    return loss


def make_c51_loss(config: DQNConfig) -> Callable:
    """Categorical distributional TD loss (C51, Bellemare et al. 2017;
    reference: `dqn_torch_policy.py` num_atoms>1 branch). The Bellman-updated
    support Tz = r + gamma^h * (1-term) * z is projected onto the fixed atom
    grid and trained by cross-entropy against the online log-probs of the
    taken action; double-DQN selects the target action by online Q means.
    The projection is a one-hot product, as in the JAX package."""
    gamma = config.gamma
    double_q = config.double_q

    def loss(module, params, batch, extra):
        natoms = module.num_atoms
        delta = (module.v_max - module.v_min) / (natoms - 1)

        logits = module.dist_logits(params, batch["obs"])  # (B, A, K)
        logp_sa = _take(F.log_softmax(logits, dim=-1), batch["actions"])  # (B, K)
        with torch.no_grad():
            support = module.support_on(logits)
            tprobs = module.dist_probs(extra["target_params"], batch["next_obs"])
            if double_q:
                q_next, _ = module.forward(params, batch["next_obs"])
            else:
                q_next = torch.sum(tprobs * support, dim=-1)
            p_next = _take(tprobs, torch.argmax(q_next, dim=-1))  # (B, K)
            disc = batch["discount"][..., None] if "discount" in batch else gamma
            Tz = torch.clamp(
                batch["rewards"][..., None]
                + disc * (1.0 - batch["terminateds"])[..., None] * support,
                module.v_min,
                module.v_max,
            )
            b = (Tz - module.v_min) / delta
            lo = torch.clamp(torch.floor(b), 0, natoms - 1)
            hi = torch.clamp(lo + 1, 0, natoms - 1)
            w_hi = b - lo  # 0 when b sits on an atom (incl. the top atom: hi==lo)
            w_lo = 1.0 - w_hi
            m = torch.einsum("bj,bjk->bk", p_next * w_lo,
                             F.one_hot(lo.long(), natoms).to(p_next.dtype))
            m = m + torch.einsum("bj,bjk->bk", p_next * w_hi,
                                 F.one_hot(hi.long(), natoms).to(p_next.dtype))

        ce = -torch.sum(m * logp_sa, dim=-1)  # (B,)
        weight = batch["loss_weight"]
        total = batch_sum(weight * ce) / torch.clamp(batch_sum(weight), min=1.0)
        # Q(s,a) for metrics from the already-computed logits: E_z[softmax]
        # of the taken action's atom row.
        q_sa = torch.sum(torch.exp(logp_sa) * module.support_on(logp_sa), dim=-1)
        aux = {
            "td_error_mean": total,
            "q_mean": torch.mean(q_sa),
            # Per-sample cross-entropy vs the projected target: the
            # distributional TD error, for prioritized replay.
            "td_abs": ce,
        }
        return total, aux

    return loss


def n_step_columns(rew, dones, n: int, gamma: float):
    """Vectorized n-step window math over (T, N) rollout buffers.

    Returns (returns, end_index, discount): per row t the discounted reward
    sum over steps t..e (stopping at the first done or the fragment edge),
    the inclusive end index e, and the bootstrap discount gamma^(e-t+1).
    Loops over the n offsets only — O(n) vector ops, not O(T*N*n) Python.
    """
    T, N = rew.shape
    R = rew.astype(np.float32).copy()
    end = np.tile(np.arange(T, dtype=np.int64)[:, None], (1, N))
    discount = np.full((T, N), gamma, np.float32)
    cont = 1.0 - dones  # window may extend past step t+k-1
    for k in range(1, n):
        ext = cont[: T - k]  # rows that extend to step t+k
        R[: T - k] += (gamma**k) * rew[k:] * ext
        end[: T - k] = np.where(ext > 0, np.arange(k, T)[:, None], end[: T - k])
        discount[: T - k] = np.where(
            ext > 0, np.float32(gamma ** (k + 1)), discount[: T - k]
        )
        cont = cont.copy()
        cont[: T - k] *= 1.0 - dones[k:]
    return R, end, discount


def replay_ma_training_step(algo: Algorithm, **kwargs) -> Dict[str, Any]:
    """The multi-agent replay iteration (per-policy buffers and learners)."""
    raise NotImplementedError(_MULTI_AGENT)


class DQN(Algorithm):
    def __init__(self, config: DQNConfig):
        super().__init__(config)
        self.buffer = config.make_replay_buffer()
        self.num_updates = 0
        self.env_steps = 0
        self._rng = np.random.default_rng(config.seed)
        self._sync_target()

    def _sync_target(self) -> None:
        self.target_params = self.learner_group.get_weights()
        self.learner_group.set_extra({"target_params": self.target_params})

    # Q-network module from the catalog (epsilon-greedy exploration).
    _module_kind = "q"

    def make_module(self, obs_dim: int, num_actions: int):
        cfg = self.config
        if cfg.num_atoms > 1 or cfg.dueling:
            # Same model-dict conventions as the catalog path (fcnet_*
            # aliases honored); custom_module cannot combine with the
            # Rainbow architectures, so fail loudly instead of bypassing it.
            from ray_tpu_torch.rllib.models.catalog import _activation, _hiddens

            m = cfg.model or {}
            if m.get("custom_module"):
                raise ValueError(
                    "custom_module cannot be combined with num_atoms>1/"
                    "dueling (those knobs select their own architectures)"
                )
            hiddens, activation = _hiddens(m), _activation(m)
            if cfg.num_atoms > 1:
                from ray_tpu_torch.rllib.core.distributional import DistributionalQModule

                return DistributionalQModule(
                    obs_dim,
                    num_actions,
                    hiddens=hiddens,
                    activation=activation,
                    num_atoms=cfg.num_atoms,
                    v_min=cfg.v_min,
                    v_max=cfg.v_max,
                    dueling=cfg.dueling,
                )
            from ray_tpu_torch.rllib.core.distributional import DuelingQMLPModule

            return DuelingQMLPModule(
                obs_dim, num_actions, hiddens=hiddens, activation=activation
            )
        return super().make_module(obs_dim, num_actions)

    def make_loss(self) -> Callable:
        if self.config.num_atoms > 1:
            return make_c51_loss(self.config)
        return make_dqn_loss(self.config)

    def make_optimizer(self):
        return adam(self.config.lr, grad_clip=self.config.grad_clip)

    # -------------------------------------------------------------- schedule
    def epsilon(self) -> float:
        from ray_tpu_torch.rllib.utils.exploration import _anneal

        cfg = self.config
        return _anneal(
            cfg.epsilon_initial, cfg.epsilon_final, cfg.epsilon_decay_steps,
            self.env_steps,
        )

    # ----------------------------------------------------------- one iteration
    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch

        cfg = self.config
        weights = self.learner_group.get_weights()
        sync = [r.set_weights.remote(weights) for r in self.env_runners]
        out: Dict[str, Any] = {}
        if self.exploration is None:
            # Built-in epsilon-greedy schedule; configured strategies are
            # pushed (and reported) by the base train() instead.
            eps = self.epsilon()
            sync += [r.set_exploration.remote(eps) for r in self.env_runners]
            out["epsilon"] = eps
        ray_tpu_torch.get(sync)
        t0 = time.perf_counter()
        rollouts = ray_tpu_torch.get([r.sample.remote() for r in self.env_runners])
        out["sample_time_s"] = time.perf_counter() - t0
        for ro in rollouts:
            self.buffer.add(self._transitions(ro, cfg.n_step, cfg.gamma))
            self.env_steps += int(ro["rewards"].size)

        out.update(
            buffer_size=self.buffer.size,
            num_env_steps_sampled=self.env_steps,
        )
        prioritized = isinstance(self.buffer, PrioritizedReplayBuffer)
        beta = (cfg.replay_buffer_config or {}).get("beta", 0.4)
        if self.buffer.size >= cfg.learning_starts:
            t0 = time.perf_counter()
            metrics_acc: List[Dict[str, float]] = []
            for _ in range(cfg.updates_per_iteration):
                if prioritized:
                    batch = self.buffer.sample(
                        cfg.train_batch_size, self._rng, beta=beta
                    )
                    idx = batch.pop("batch_indexes")
                else:
                    batch = self.buffer.sample(cfg.train_batch_size, self._rng)
                m = self.learner_group.update(batch)
                td = m.pop("td_abs", None)
                metrics_acc.append(m)
                self.num_updates += 1
                if prioritized:
                    # Refresh sampled priorities from the per-sample |TD| the
                    # update itself returned.
                    td = np.asarray(td)
                    self.buffer.update_priorities(idx[: len(td)], td)
                if self.num_updates % cfg.target_network_update_freq == 0:
                    self._sync_target()
            out.update(
                {k: float(np.mean([m[k] for m in metrics_acc])) for k in metrics_acc[0]}
            )
            out["learn_time_s"] = time.perf_counter() - t0
            out["num_learner_updates"] = len(metrics_acc)
        return self.collect_episode_metrics(out)

    @staticmethod
    def _transitions(
        ro: Dict[str, np.ndarray], n_step: int = 1, gamma: float = 0.99
    ) -> Dict[str, np.ndarray]:
        """(T, N) rollout buffers -> flat (s, a, r, s', terminated, weight);
        n_step > 1 adds n-step returns + a per-row bootstrap `discount`."""
        obs, dones, terms = ro["obs"], ro["dones"], ro["terminateds"]
        next_obs = np.concatenate([obs[1:], ro["last_obs"][None]], axis=0)
        # SAME_STEP autoreset: the row after a done holds the reset obs, which
        # is the CORRECT s' only for rows that didn't end; terminated rows
        # never use s'. Truncated (time-limit) rows substitute the true final
        # observation the runner recorded and keep full weight — the TD target
        # bootstraps through the real state, nothing is discarded.
        truncated = ro.get("truncateds")
        final_obs = ro.get("final_obs")
        if truncated is None or final_obs is None:
            truncated = dones - terms
            weight = 1.0 - truncated  # no final obs recorded: exclude rows
        else:
            mask = truncated.reshape(
                truncated.shape + (1,) * (final_obs.ndim - truncated.ndim)
            )
            next_obs = np.where(mask > 0, final_obs, next_obs)
            weight = np.ones_like(dones)
        rewards = ro["rewards"]
        flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
        out = {
            "obs": flat(obs).astype(np.float32),
            "actions": flat(ro["actions"]),
        }
        if n_step > 1:
            # Each row's window runs to its end index e (first done or the
            # fragment edge); bootstrap obs/terminal/weight are GATHERED from
            # row e, so truncation handling above applies transitively.
            R, end, discount = n_step_columns(rewards, dones, n_step, gamma)
            envi = np.arange(obs.shape[1])
            out.update(
                rewards=flat(R),
                next_obs=flat(next_obs[end, envi]).astype(np.float32),
                terminateds=flat(terms[end, envi]).astype(np.float32),
                loss_weight=flat(weight[end, envi]).astype(np.float32),
                discount=flat(discount),
            )
        else:
            out.update(
                rewards=flat(rewards).astype(np.float32),
                next_obs=flat(next_obs).astype(np.float32),
                terminateds=flat(terms).astype(np.float32),
                loss_weight=flat(weight).astype(np.float32),
            )
        return out

    # -------------------------------------------------------------- checkpoint
    def _extra_state(self) -> Dict[str, Any]:
        return {
            "target_params": self.target_params,
            "num_updates": self.num_updates,
            "env_steps": self.env_steps,
        }

    def _load_extra_state(self, state: Dict[str, Any]) -> None:
        if "target_params" in state:
            self.target_params = state["target_params"]
            self.learner_group.set_extra({"target_params": self.target_params})
        self.num_updates = int(state.get("num_updates", 0))
        self.env_steps = int(state.get("env_steps", 0))
