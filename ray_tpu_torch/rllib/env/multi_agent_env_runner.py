"""MultiAgentEnvRunner: sampling actor over MultiAgentEnv instances with
per-policy action routing.

The counterpart of ``ray_tpu/rllib/env/multi_agent_env_runner.py``;
reference: `rllib/evaluation/rollout_worker.py` multi-agent path — obs are
routed to policies via `policy_mapping_fn(agent_id)`, actions route back, and
each policy accumulates its own train batch (`rllib/evaluation/episode.py`).
Per step, all agents mapped to the same policy batch into ONE forward, and
GAE runs here on the completed per-agent trajectories, so the learner
receives flat per-policy batches, as in the JAX package.

A runner is a CPU actor, as ``EnvRunner`` is: every policy's module runs on
``device="cpu"`` under ``torch.no_grad()`` with as many threads as the actor
holds CPUs. Random draws come from one ``torch.Generator`` per runner, seeded
as ``EnvRunner`` seeds its own, where the JAX runner splits a key.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.models.training import tree_leaves
from ray_tpu_torch.rllib.callbacks import Episode as _Episode


def _segment_gae(
    rewards: np.ndarray,
    values: np.ndarray,
    bootstrap: float,
    gamma: float,
    lambda_: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """GAE over one contiguous single-agent trajectory segment. `bootstrap`
    is V(next_obs) after the last row (0.0 when the segment terminated)."""
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    lastgaelam = 0.0
    for t in reversed(range(T)):
        next_v = bootstrap if t == T - 1 else values[t + 1]
        delta = rewards[t] + gamma * next_v - values[t]
        lastgaelam = delta + gamma * lambda_ * lastgaelam
        adv[t] = lastgaelam
    return adv, adv + values


class _Trajectory:
    """Per-(env, agent) rollout accumulator."""

    __slots__ = ("obs", "actions", "logp", "logits", "values", "rewards")

    def __init__(self):
        self.obs: List[np.ndarray] = []
        self.actions: List[Any] = []
        self.logp: List[float] = []
        self.logits: List[np.ndarray] = []
        self.values: List[float] = []
        self.rewards: List[float] = []

    def __len__(self):
        return len(self.actions)


class MultiAgentEnvRunner:
    def __init__(
        self,
        env_creator: Callable[[], Any],
        modules: Dict[str, Any],  # policy_id -> RLModule
        policy_mapping_fn: Callable[[str], str],
        num_envs: int = 2,
        rollout_length: int = 128,
        seed: int = 0,
        gamma: float = 0.99,
        lambda_: float = 0.95,
        default_explore: bool = True,
        callbacks=None,
        num_cpus: float = 1,
    ):
        from ray_tpu_torch.rllib.callbacks import DefaultCallbacks

        # One thread per CPU the actor holds, as EnvRunner.
        torch.set_num_threads(max(1, int(num_cpus)))
        self.device = torch.device("cpu")
        # Worker-side lifecycle hooks (parity with EnvRunner).
        self._callbacks = (callbacks or DefaultCallbacks)()

        self._envs = [env_creator() for _ in range(num_envs)]
        # `config.explore=False` pins training rollouts deterministic.
        self._default_explore = bool(default_explore)
        self.modules = modules
        self.policy_mapping_fn = policy_mapping_fn
        self.rollout_length = rollout_length
        self.gamma = gamma
        self.lambda_ = lambda_
        self._generator = torch.Generator().manual_seed(int(seed))
        self._params = {
            pid: m.init(seed + i, device=self.device)
            for i, (pid, m) in enumerate(modules.items())
        }
        # Replay-trained policy maps (multi-agent DQN/SAC): trajectories
        # close into flat (s, a, r, s', terminated) transition batches per
        # policy instead of GAE columns, and Q modules act epsilon-greedily
        # with a schedule the algorithm pushes (same contract as EnvRunner).
        self.value_based = any(
            getattr(m, "off_policy", False) or hasattr(m, "epsilon_greedy")
            for m in modules.values()
        )
        self._epsilon = 1.0
        # Live episode state per env.
        self._obs: List[Dict[str, Any]] = []
        self._done_agents: List[set] = []
        self._episode_return: List[float] = []
        self._episode_len: List[int] = []
        self._completed: List[Tuple[float, int]] = []
        for i, env in enumerate(self._envs):
            obs, _ = env.reset(seed=seed + 7919 * (i + 1))
            self._obs.append(obs)
            self._done_agents.append(set())
            self._episode_return.append(0.0)
            self._episode_len.append(0)
        # Open per-(env, agent-id) trajectories.
        self._traj: List[Dict[str, _Trajectory]] = [dict() for _ in self._envs]

    def _act(self, pid: str, obs: np.ndarray, explore: bool):
        """(action, logp, value, dist_inputs) of policy ``pid`` as numpy,
        from one forward on the CPU."""
        module, params = self.modules[pid], self._params[pid]
        obs = torch.from_numpy(np.ascontiguousarray(obs, np.float32))
        with torch.no_grad():
            if hasattr(module, "epsilon_greedy"):
                out = module.epsilon_greedy(params, obs, self._generator, explore,
                                            self._epsilon)
            else:
                out = module.action_dist(params, obs, self._generator, explore)
        return [t.numpy() for t in out]

    def placement(self) -> Dict[str, Any]:
        """Where this runner computes: its process, visible GPU ids, the
        device of its params and its thread count."""
        first = next(iter(self._params.values()))
        return {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": str(tree_leaves(first)[0].device),
                "num_threads": torch.get_num_threads()}

    def set_weights(self, weights: Dict[str, Any]) -> None:
        for pid, w in weights.items():
            self._params[pid] = params_from_numpy(w, device=self.device)

    def set_exploration(self, epsilon: float) -> None:
        """Epsilon push for Q policies (the algorithm holds the schedule)."""
        self._epsilon = float(epsilon)

    # ------------------------------------------------------------------ sample
    def sample(self, explore=None) -> Dict[str, Dict[str, np.ndarray]]:
        """Collect `rollout_length` env steps; returns per-policy flat batches:
        GAE columns (advantages/value_targets) for policy-gradient maps, or
        (s, a, r, s', terminated) transitions for replay-trained maps."""
        if explore is None:
            explore = self._default_explore
        if self.value_based:
            keys = (
                "obs", "actions", "rewards", "next_obs",
                "terminateds", "loss_weight",
            )
        else:
            keys = (
                "obs", "actions", "logp", "behavior_logits",
                "advantages", "value_targets",
            )
        out: Dict[str, Dict[str, List[np.ndarray]]] = {
            pid: {k: [] for k in keys} for pid in self.modules
        }
        for _ in range(self.rollout_length):
            self._step_once(out, explore)
        # Close out still-open trajectories (episode continues next fragment):
        # PG bootstraps through V(current obs); replay transitions tail with
        # s' = current obs, terminated=0 (the target net bootstraps).
        for e in range(len(self._envs)):
            open_agents = list(self._traj[e].keys())
            if not open_agents:
                continue
            if self.value_based:
                for aid in open_agents:
                    self._close_trajectory(
                        out, e, aid,
                        close_obs=self._obs[e].get(aid), terminated=False,
                    )
            else:
                boots = self._values_for(
                    {aid: self._obs[e][aid] for aid in open_agents if aid in self._obs[e]}
                )
                for aid in open_agents:
                    self._close_trajectory(out, e, aid, boots.get(aid, 0.0))
        batches = {
            pid: {k: _stack(v) for k, v in cols.items()}
            for pid, cols in out.items()
            if cols["actions"]
        }
        self._callbacks.on_sample_end(samples=batches)
        return batches

    def _group_by_policy(
        self, per_env_obs: List[Dict[str, Any]]
    ) -> Dict[str, List[Tuple[int, str]]]:
        """(env_idx, agent_id) pairs ready to act, grouped by policy."""
        groups: Dict[str, List[Tuple[int, str]]] = {}
        for e, obs in enumerate(per_env_obs):
            for aid in obs:
                if aid in self._done_agents[e]:
                    continue
                groups.setdefault(self.policy_mapping_fn(aid), []).append((e, aid))
        return groups

    def _step_once(self, out, explore: bool) -> None:
        groups = self._group_by_policy(self._obs)
        actions: List[Dict[str, Any]] = [dict() for _ in self._envs]
        for pid, members in groups.items():
            obs_batch = np.stack(
                [np.asarray(self._obs[e][aid], np.float32).ravel() for e, aid in members]
            )
            a, logp, value, logits = self._act(pid, obs_batch, explore)
            for j, (e, aid) in enumerate(members):
                tr = self._traj[e].setdefault(aid, _Trajectory())
                tr.obs.append(obs_batch[j])
                tr.actions.append(a[j])
                if not self.value_based:
                    tr.logp.append(float(logp[j]))
                    tr.logits.append(logits[j])
                    tr.values.append(float(value[j]))
                actions[e][aid] = a[j]
        for e, env in enumerate(self._envs):
            if not actions[e]:
                self._reset_env(e)
                continue
            obs, rews, terms, truncs, infos = env.step(actions[e])
            for aid, r in rews.items():
                # An action opens a pending reward slot (len(rewards) ==
                # len(actions) - 1). Rewards reported on steps where the agent
                # did NOT act (turn-based envs: agent absent from obs is "not
                # ready") accumulate into the last acted step instead of
                # appending — appending would desynchronize rewards[i] from
                # actions[i] and misattribute credit in GAE.
                tr = self._traj[e].get(aid)
                if tr is not None and len(tr.actions):
                    if len(tr.rewards) < len(tr.actions):
                        tr.rewards.append(float(r))
                    else:
                        tr.rewards[-1] += float(r)
                self._episode_return[e] += float(r)
            self._episode_len[e] += 1
            next_obs = dict(self._obs[e])
            next_obs.update(obs)
            for aid in list(rews):
                terminated = bool(terms.get(aid, False))
                truncated = bool(truncs.get(aid, False))
                if terminated or truncated:
                    self._done_agents[e].add(aid)
                    if self.value_based:
                        self._close_trajectory(
                            out, e, aid,
                            close_obs=obs.get(aid), terminated=terminated,
                        )
                    else:
                        boot = 0.0
                        if truncated and not terminated and aid in obs:
                            boot = self._values_for({aid: obs[aid]}).get(aid, 0.0)
                        self._close_trajectory(out, e, aid, boot)
            self._obs[e] = next_obs
            if terms.get("__all__") or truncs.get("__all__"):
                # Close any trajectories still open (an env may end the whole
                # episode via __all__ without per-agent terminal flags):
                # truncation-style end bootstraps through V(last obs),
                # termination cuts to zero — and either way the buffers must
                # not leak into the next episode.
                open_agents = list(self._traj[e].keys())
                if open_agents:
                    if self.value_based:
                        terminated_all = bool(terms.get("__all__"))
                        for aid in open_agents:
                            self._close_trajectory(
                                out, e, aid,
                                close_obs=next_obs.get(aid),
                                terminated=terminated_all,
                            )
                    else:
                        boots = (
                            self._values_for(
                                {
                                    aid: next_obs[aid]
                                    for aid in open_agents
                                    if aid in next_obs
                                }
                            )
                            if truncs.get("__all__")
                            else {}
                        )
                        for aid in open_agents:
                            self._close_trajectory(out, e, aid, boots.get(aid, 0.0))
                self._completed.append(
                    (self._episode_return[e], self._episode_len[e])
                )
                self._callbacks.on_episode_end(
                    episode=_Episode(
                        episode_return=float(self._episode_return[e]),
                        episode_length=int(self._episode_len[e]),
                    )
                )
                self._reset_env(e)

    def _reset_env(self, e: int) -> None:
        obs, _ = self._envs[e].reset()
        self._obs[e] = obs
        self._done_agents[e] = set()
        self._episode_return[e] = 0.0
        self._episode_len[e] = 0

    def _values_for(self, obs_by_agent: Dict[str, Any]) -> Dict[str, float]:
        """V(obs) per agent under the agent's policy (bootstrap helper)."""
        vals: Dict[str, float] = {}
        groups: Dict[str, List[str]] = {}
        for aid in obs_by_agent:
            groups.setdefault(self.policy_mapping_fn(aid), []).append(aid)
        for pid, aids in groups.items():
            batch = np.stack(
                [np.asarray(obs_by_agent[a], np.float32).ravel() for a in aids]
            )
            _, _, value, _ = self._act(pid, batch, False)
            for a, v in zip(aids, value):
                vals[a] = float(v)
        return vals

    def _close_trajectory(
        self, out, e: int, aid: str, bootstrap: float = 0.0,
        close_obs: Any = None, terminated: bool = False,
    ) -> None:
        tr = self._traj[e].pop(aid, None)
        if tr is None or len(tr) == 0:
            return
        # A trailing action whose reward was never reported (episode ended via
        # __all__ before the env credited it) earns 0. Rewards can never
        # exceed actions: inter-action rewards fold into the last acted step.
        if len(tr.rewards) < len(tr.actions):
            tr.rewards.extend([0.0] * (len(tr.actions) - len(tr.rewards)))
        assert len(tr.rewards) == len(tr.actions), (
            f"trajectory desync for {aid}: "
            f"{len(tr.rewards)} rewards vs {len(tr.actions)} actions"
        )
        n = len(tr.actions)
        rewards = np.asarray(tr.rewards, np.float32)
        pid = self.policy_mapping_fn(aid)
        cols = out[pid]
        if self.value_based:
            # Flat replay transitions: s'[i] is the agent's NEXT observation
            # (consecutive within the trajectory; skipped turn-based steps
            # collapse into one transition). The tail's s' is `close_obs`
            # (the final/current obs); terminated marks only the tail row —
            # a fragment-end close bootstraps through the target net.
            obs_arr = np.stack(tr.obs)
            weight = np.ones(n, np.float32)
            if close_obs is not None:
                last_next = np.asarray(close_obs, np.float32).ravel()
            else:
                # No final obs for the tail. Terminated rows never read s'
                # (the TD target zeroes it); a TRUNCATED/fragment close
                # without an obs would bootstrap through its own source
                # state — exclude that row instead (same rule as the
                # single-agent fallback in DQN._transitions).
                last_next = obs_arr[-1]
                if not terminated:
                    weight[-1] = 0.0
            next_obs = np.concatenate([obs_arr[1:], last_next[None]], axis=0)
            term_col = np.zeros(n, np.float32)
            term_col[-1] = 1.0 if terminated else 0.0
            cols["obs"].append(obs_arr)
            cols["actions"].append(np.asarray(tr.actions))
            cols["rewards"].append(rewards)
            cols["next_obs"].append(next_obs)
            cols["terminateds"].append(term_col)
            cols["loss_weight"].append(weight)
            return
        values = np.asarray(tr.values, np.float32)
        adv, targets = _segment_gae(
            rewards, values, bootstrap, self.gamma, self.lambda_
        )
        cols["obs"].append(np.stack(tr.obs[:n]))
        cols["actions"].append(np.asarray(tr.actions[:n]))
        cols["logp"].append(np.asarray(tr.logp[:n], np.float32))
        cols["behavior_logits"].append(np.stack(tr.logits[:n]))
        cols["advantages"].append(adv)
        cols["value_targets"].append(targets)

    # ------------------------------------------------------------------- stats
    def episode_stats(self, clear: bool = True) -> Dict[str, float]:
        eps = self._completed
        if clear:
            self._completed = []
        if not eps:
            return {"episodes": 0}
        rets = [r for r, _ in eps]
        lens = [l for _, l in eps]
        return {
            "episodes": len(eps),
            "episode_return_mean": float(np.mean(rets)),
            "episode_return_max": float(np.max(rets)),
            "episode_return_min": float(np.min(rets)),
            "episode_len_mean": float(np.mean(lens)),
        }

    def close(self) -> None:
        for env in self._envs:
            env.close()


def _stack(chunks: List[np.ndarray]) -> np.ndarray:
    return np.concatenate(chunks, axis=0)
