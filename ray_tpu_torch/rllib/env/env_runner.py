"""EnvRunner: a sampling actor on the CPU over a vector of environments.

The counterpart of ``ray_tpu/rllib/env/env_runner.py``; reference:
`rllib/evaluation/rollout_worker.py:166` (`sample():879`) and the new-stack
`rllib/env/env_runner.py`. Collects fixed-size rollout fragments with the
current policy weights (synced before each round), returning flat numpy
batches ready for GAE and the learner.

A runner is a CPU actor by design: its forward runs on ``device="cpu"`` under
``torch.no_grad()`` with as many threads as the actor holds CPUs, and it
never looks for a GPU (the runtime shows it none). It steps its envs itself
(``VectorEnv``) and reads their spaces by attribute, so neither it nor the
algorithm imports gymnasium to run an env creator's env.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.models.training import tree_leaves
from ray_tpu_torch.rllib.core.rl_module import RLModule


def is_discrete(space) -> bool:
    """Whether a space is Discrete (it has ``n``); otherwise it is a Box
    (``shape``, ``low``, ``high``)."""
    return hasattr(space, "n")


class VectorEnv:
    """``len(env_fns)`` envs stepped in turn with gymnasium's ``SAME_STEP``
    autoreset, the contract of ``gymnasium.vector.SyncVectorEnv(...,
    autoreset_mode=AutoresetMode.SAME_STEP)``: an env that terminates or
    truncates is reset in the same step, the observation returned for it is
    the reset one, and its final observation goes into ``infos["final_obs"]``
    (an object array, None where no episode ended) with the mask
    ``infos["_final_obs"]``. ``reset(seed=s)`` seeds env *i* with *s + i*;
    later resets draw from each env's own generator. Rewards are float64 and
    the done flags bool, as there."""

    def __init__(self, env_fns):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space

    def _stack(self, obs):
        dtype = getattr(self.single_observation_space, "dtype", None)
        obs = np.stack(obs)
        return obs if dtype is None else obs.astype(dtype, copy=False)

    def reset(self, seed: Optional[int] = None):
        seeds = [None] * self.num_envs if seed is None else [seed + i for i in range(self.num_envs)]
        return self._stack([env.reset(seed=s)[0] for env, s in zip(self.envs, seeds)]), {}

    def step(self, actions):
        n = self.num_envs
        obs = []
        rewards = np.zeros(n, np.float64)
        terminated, truncated = np.zeros(n, np.bool_), np.zeros(n, np.bool_)
        final_obs, has_final = np.full(n, None, dtype=object), np.zeros(n, np.bool_)
        for i, env in enumerate(self.envs):
            o, rewards[i], terminated[i], truncated[i], _ = env.step(actions[i])
            if terminated[i] or truncated[i]:
                final_obs[i], has_final[i] = o, True
                o, _ = env.reset()
            obs.append(o)
        infos = {"final_obs": final_obs, "_final_obs": has_final} if has_final.any() else {}
        return self._stack(obs), rewards, terminated, truncated, infos

    def close(self):
        for env in self.envs:
            env.close()


class EnvRunner:
    def __init__(
        self,
        env_creator: Callable[[], Any],
        module: RLModule,
        num_envs: int = 4,
        rollout_length: int = 128,
        seed: int = 0,
        gamma: float = 0.99,
        record_final_obs: bool = True,
        record_value_extras: bool = True,
        obs_connector: Any = None,
        action_connector: Any = None,
        exploration: Any = None,
        default_explore: bool = True,
        callbacks: Any = None,
        num_cpus: float = 1,
    ):
        from ray_tpu_torch.rllib.callbacks import DefaultCallbacks, Episode
        from ray_tpu_torch.rllib.connectors.connector import build_connector
        from ray_tpu_torch.rllib.utils.exploration import build_exploration

        # One thread per CPU the actor holds: runners on one host would
        # otherwise each start a thread per core and fight over them.
        torch.set_num_threads(max(1, int(num_cpus)))
        self.device = torch.device("cpu")
        # Worker-side lifecycle hooks (reference: callbacks run in rollout
        # workers); instantiated HERE so hook state is per-runner.
        self._callbacks = (callbacks or DefaultCallbacks)()
        self._episode_cls = Episode
        self._envs = VectorEnv([env_creator for _ in range(num_envs)])
        self.module = module
        self.num_envs = num_envs
        self.rollout_length = rollout_length
        self.gamma = gamma
        # `config.explore=False` (reference `AlgorithmConfig.explore`) pins
        # training rollouts deterministic; evaluate() still overrides per
        # call via sample(explore=...).
        self._default_explore = bool(default_explore)
        # Algorithms that bootstrap truncations via runner-side values (PPO)
        # skip the obs-sized final_obs buffer entirely.
        self.record_final_obs = record_final_obs
        # Algorithms whose loss recomputes values under current params
        # (IMPALA/V-trace) skip value/dist buffers and bootstrap forwards.
        self.record_value_extras = record_value_extras
        # Connector seams (reference: `rllib/connectors/`): obs transforms
        # run before the forward, action transforms before env.step. Built
        # HERE (each runner actor owns fresh connector state).
        self._obs_conn = build_connector(obs_connector)
        self._act_conn = build_connector(action_connector)
        self._generator = torch.Generator().manual_seed(int(seed))
        self._params = module.init(seed, device=self.device)
        self._obs, _ = self._envs.reset(seed=seed)
        # Each raw obs batch is preprocessed EXACTLY once (stateful
        # connectors like NormalizeObs accumulate per call).
        self._obs_in = self._preprocess(self._obs)
        self._episode_returns = np.zeros(num_envs)
        self._episode_lengths = np.zeros(num_envs, dtype=np.int64)
        self._completed: list = []
        # Box action spaces (continuous control) sample float vectors; the
        # rollout buffers size/type themselves off the space.
        space = self._envs.single_action_space
        self._continuous = not is_discrete(space)
        self._act_shape = tuple(space.shape) if self._continuous else ()
        self._act_dtype = np.float32 if self._continuous else np.int64
        # Replay-trained modules (Q-nets, SAC) never consume logp/value/dist
        # buffers: skip filling and shipping them (and bootstrap forwards).
        self._value_based = getattr(module, "off_policy", False) or hasattr(
            module, "epsilon_greedy"
        )
        # Pluggable exploration (reference: `rllib/utils/exploration/` via
        # exploration_config). `_clean_params` backs deterministic
        # (explore=False) action paths when ParameterNoise perturbs the
        # rollout params.
        self._exploration = build_exploration(exploration)
        self._clean_params = self._params
        self._epsilon = 1.0
        if self._exploration is not None:
            self._expl_state = self._exploration.initial_state(num_envs, self._act_shape)

    def _act(self, params, obs: np.ndarray, explore: bool):
        """(action, logp, value, dist_inputs) as numpy, from one forward on
        the CPU."""
        obs = torch.from_numpy(np.ascontiguousarray(obs, np.float32))
        g = self._generator
        with torch.no_grad():
            if self._exploration is not None:
                *out, self._expl_state = self._exploration.actions(
                    self.module, params if explore else self._clean_params, obs, g, explore,
                    self._expl_state)
            elif hasattr(self.module, "epsilon_greedy"):
                # Value-based modules (DQN): epsilon pushed by the driver.
                out = self.module.epsilon_greedy(params, obs, g, explore, self._epsilon)
            else:
                out = self.module.action_dist(params, obs, g, explore)
        return [t.numpy() for t in out]

    def placement(self) -> Dict[str, Any]:
        """Where this runner computes: its process, visible GPU ids, the
        device of its params and its thread count."""
        return {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": str(tree_leaves(self._params)[0].device),
                "num_threads": torch.get_num_threads()}

    def set_weights(self, weights) -> None:
        params = params_from_numpy(weights, device=self.device)
        self._clean_params = params
        if self._exploration is not None:
            # ParameterNoise redraws its perturbation here (once per sync);
            # other strategies return the weights untouched.
            self._params = self._exploration.on_weights(params, self._generator)
        else:
            self._params = params

    def set_exploration(self, value) -> None:
        """Exploration push from the driver: a float (legacy DQN epsilon) or
        a dict of schedule values merged into the strategy's state."""
        if isinstance(value, dict):
            if self._exploration is not None:
                self._expl_state = {**self._expl_state, **value}
            return
        self._epsilon = float(value)
        if self._exploration is not None and "epsilon" in self._expl_state:
            self._expl_state = dict(self._expl_state, epsilon=np.float32(value))

    # ------------------------------------------------------------- connectors
    def _preprocess(self, obs) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        return self._obs_conn(obs) if self._obs_conn is not None else obs

    def get_connector_state(self):
        return self._obs_conn.state() if self._obs_conn is not None else {}

    def set_connector_state(self, state, freeze: bool = False) -> None:
        """Adopt another runner's connector state (evaluation runners run on
        the training runners' normalization stats, frozen so eval batches
        don't pollute them — reference: `MeanStdFilter` sync semantics)."""
        if self._obs_conn is None:
            return
        self._obs_conn.set_state(state)
        if freeze and hasattr(self._obs_conn, "frozen"):
            self._obs_conn.frozen = True
        for c in getattr(self._obs_conn, "connectors", []):
            if freeze and hasattr(c, "frozen"):
                c.frozen = True

    def sample(self, explore: Optional[bool] = None) -> Dict[str, np.ndarray]:
        """One rollout fragment: (T*num_envs) flat transition batch."""
        if explore is None:
            explore = self._default_explore
        T, N = self.rollout_length, self.num_envs
        value_based = self._value_based
        need_logp = not value_based
        need_values = not value_based and self.record_value_extras
        # The train batch records the CONNECTED obs — the loss must see
        # exactly what the policy forward saw. Carried from the previous
        # fragment (preprocessed once there).
        obs_in = self._obs_in
        obs_buf = np.zeros((T, N) + obs_in.shape[1:], np.float32)
        act_buf = np.zeros((T, N) + self._act_shape, self._act_dtype)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)
        term_buf = np.zeros((T, N), np.float32)
        if need_logp:
            logp_buf = np.zeros((T, N), np.float32)
        if need_values:
            val_buf = np.zeros((T, N), np.float32)
            # V(final_obs) where an episode hit its time limit: GAE bootstraps
            # truncated episodes through this value.
            boot_buf = np.zeros((T, N), np.float32)
        # True final observation at truncation boundaries (SAME_STEP autoreset
        # replaces next_obs with the reset obs there); value-based algorithms
        # bootstrap their TD targets through these rows.
        final_obs_buf = (
            np.zeros((T, N) + obs_in.shape[1:], np.float32)
            if self.record_final_obs
            else None
        )
        trunc_buf = np.zeros((T, N), np.float32)
        logits_buf: Optional[np.ndarray] = None
        for t in range(T):
            action, logp, value, logits = self._act(self._params, obs_in, explore)
            if need_logp:
                logp_buf[t] = logp
            if need_values:
                if logits_buf is None:
                    logits_buf = np.zeros((T, N) + np.shape(logits)[1:], np.float32)
                logits_buf[t] = logits
                val_buf[t] = value
            obs_buf[t] = obs_in
            act_buf[t] = action
            env_action = (
                self._act_conn(action) if self._act_conn is not None else action
            )
            nxt, rew, term, trunc, infos = self._envs.step(env_action)
            done = np.logical_or(term, trunc)
            rew_buf[t] = rew
            done_buf[t] = done.astype(np.float32)
            term_buf[t] = np.asarray(term, np.float32)
            trunc_only = np.logical_and(trunc, np.logical_not(term))
            if trunc_only.any():
                idx = np.nonzero(trunc_only)[0]
                raw_final = self._final_observations(infos, nxt)
                # Connect ONLY the truly-final rows (the rest are next-step
                # obs that will be preprocessed at loop end), then scatter
                # into a full batch. Non-idx rows are zero and never read.
                pf_rows = self._preprocess(raw_final[idx])
                final_obs = np.zeros_like(obs_in)
                final_obs[idx] = pf_rows
                trunc_buf[t, idx] = 1.0
                if final_obs_buf is not None:
                    final_obs_buf[t, idx] = pf_rows
                if need_values:
                    _, _, fvals, _ = self._act(self._params, final_obs, False)
                    boot_buf[t, idx] = fvals[idx]
            self._episode_returns += rew
            self._episode_lengths += 1
            for i in np.nonzero(done)[0]:
                ep = (float(self._episode_returns[i]), int(self._episode_lengths[i]))
                self._completed.append(ep)
                self._callbacks.on_episode_end(
                    episode=self._episode_cls(
                        episode_return=ep[0], episode_length=ep[1]
                    )
                )
                self._episode_returns[i] = 0.0
                self._episode_lengths[i] = 0
            self._obs = nxt
            self._obs_in = obs_in = self._preprocess(self._obs)
        out = {
            "obs": obs_buf,
            "actions": act_buf,
            "rewards": rew_buf,
            "dones": done_buf,
            "terminateds": term_buf,
            "truncateds": trunc_buf,
            # Final observations (value-based algorithms build next_obs by
            # shifting obs and closing the tail with these).
            "last_obs": obs_in,
        }
        if final_obs_buf is not None:
            out["final_obs"] = final_obs_buf
        if need_logp:
            out["logp"] = logp_buf
        if need_values:
            # Bootstrap value for the final observation of each env.
            _, _, last_val, _ = self._act(self._params, obs_in, explore)
            out.update(
                behavior_logits=logits_buf,
                values=val_buf,
                bootstrap_values=boot_buf,
                last_values=np.asarray(last_val, np.float32),
            )
        self._callbacks.on_sample_end(samples=out)
        return out

    def _final_observations(self, infos, nxt: np.ndarray) -> np.ndarray:
        """Per-env final observations for done envs (SAME_STEP autoreset puts
        them in infos; fall back to the post-step obs when absent)."""
        finals = None
        for key in ("final_obs", "final_observation"):
            if key in infos:
                finals = infos[key]
                break
        out = np.array(nxt, copy=True)
        if finals is not None:
            for i, f in enumerate(finals):
                if f is not None:
                    out[i] = f
        return out

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
        self._envs.close()
