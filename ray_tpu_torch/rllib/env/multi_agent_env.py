"""MultiAgentEnv: one environment hosting many independently-acting agents.

The counterpart of ``ray_tpu/rllib/env/multi_agent_env.py``; reference:
`rllib/env/multi_agent_env.py:30` — agents are string ids; reset and step
speak per-agent dicts; the terminated/truncated dicts carry the special
`"__all__"` key marking whole-episode end. `make_multi_agent` (reference
`multi_agent_env.py:284`) turns any single-agent env into a MultiAgentEnv of
N independent copies — the standard test substrate.

The runner contract (see `MultiAgentEnvRunner`):
- `reset()` returns (obs_dict, info_dict) for every agent ready to act.
- `step(action_dict)` takes actions ONLY for agents that appeared in the
  previous obs dict, and returns per-agent obs/reward/terminated/truncated/
  info dicts. Agents absent from the returned obs dict are done (or simply
  not ready); `terminateds["__all__"]`/`truncateds["__all__"]` end the
  episode for everyone.

Spaces are read by attribute (``.n``, ``.shape``, ``.low``, ``.high``), as
the env runner reads them: a callable creator's env needs no gymnasium, and
a string id is made through the algorithm's one gymnasium seam
(``algorithm.gym_make``), when the env is made.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Set, Tuple, Union

MultiAgentDict = Dict[str, Any]


class MultiAgentEnv:
    """Base class. Subclasses implement reset/step over per-agent dicts and
    (preferably) expose `observation_space`/`action_space` as dicts mapping
    agent id -> space."""

    # Dict agent_id -> space when in the preferred format.
    observation_space: Any = None
    action_space: Any = None

    def get_agent_ids(self) -> Set[str]:
        if isinstance(self.observation_space, dict):
            return set(self.observation_space)
        return set()

    def reset(
        self, *, seed: Optional[int] = None, options: Optional[dict] = None
    ) -> Tuple[MultiAgentDict, MultiAgentDict]:
        raise NotImplementedError

    def step(
        self, action_dict: MultiAgentDict
    ) -> Tuple[
        MultiAgentDict, MultiAgentDict, MultiAgentDict, MultiAgentDict, MultiAgentDict
    ]:
        raise NotImplementedError

    def close(self) -> None:
        pass


def make_multi_agent(
    env_name_or_creator: Union[str, Callable[[], Any]],
) -> Callable[[Optional[dict]], MultiAgentEnv]:
    """Wrap a single-agent env as N independent agents (one sub-env each).

    Reference semantics (`multi_agent_env.py:284` `make_multi_agent`): agent
    ids are 0..N-1 (stringified here), each steps its own copy; a done
    sub-env's agent drops out of subsequent obs dicts; `"__all__"` turns True
    once every sub-env is done.
    """

    def creator(config: Optional[dict] = None) -> MultiAgentEnv:
        config = config or {}
        num = int(config.get("num_agents", 1))

        def make_one():
            if callable(env_name_or_creator):
                return env_name_or_creator()
            from ray_tpu_torch.rllib.algorithms.algorithm import gym_make

            kwargs = {k: v for k, v in config.items() if k != "num_agents"}
            return gym_make(env_name_or_creator, **kwargs)

        class _IndependentMultiEnv(MultiAgentEnv):
            def __init__(self):
                self._envs = {str(i): make_one() for i in range(num)}
                self.observation_space = {
                    aid: e.observation_space for aid, e in self._envs.items()
                }
                self.action_space = {
                    aid: e.action_space for aid, e in self._envs.items()
                }
                self._done: Set[str] = set()
                self._terminated: Set[str] = set()

            def reset(self, *, seed=None, options=None):
                self._done = set()
                self._terminated = set()
                obs, infos = {}, {}
                for i, (aid, env) in enumerate(self._envs.items()):
                    s = None if seed is None else seed + i
                    obs[aid], infos[aid] = env.reset(seed=s, options=options)
                return obs, infos

            def step(self, action_dict):
                obs, rews, terms, truncs, infos = {}, {}, {}, {}, {}
                for aid, action in action_dict.items():
                    if aid in self._done:
                        continue
                    o, r, te, tr, info = self._envs[aid].step(action)
                    rews[aid] = r
                    terms[aid] = bool(te)
                    truncs[aid] = bool(tr)
                    infos[aid] = info
                    obs[aid] = o  # final obs still reported for bootstrap
                    if te or tr:
                        self._done.add(aid)
                        if te:
                            self._terminated.add(aid)
                all_done = len(self._done) == len(self._envs)
                terms["__all__"] = all_done and self._done == self._terminated
                truncs["__all__"] = all_done and not terms["__all__"]
                return obs, rews, terms, truncs, infos

            def close(self):
                for env in self._envs.values():
                    env.close()

        return _IndependentMultiEnv()

    return creator
