"""Algorithm + AlgorithmConfig: the RLlib training driver.

The counterpart of ``ray_tpu/rllib/algorithms/algorithm.py``; reference:
`rllib/algorithms/algorithm.py:149` (`Algorithm(Trainable)`,
`training_step:1336`) and `algorithm_config.py` (fluent config:
`.environment().training().env_runners().learners()`). `train()` runs one
iteration: sync weights -> parallel sampling on EnvRunner actors (CPU) ->
learner update(s) on the GPU -> aggregated metrics.

The learner's device has one switch, ``.learners(num_gpus_per_learner=)``:
the default 1 puts a local learner's params on the GPU (and raises when
there is none), and each remote learner holds that share of the ``GPU``
resource; 0 runs them on the CPU. Offline algorithms (MARWIL, BC, CQL) read
``config.offline_data(input_=)`` and build no env runner for training.

``.multi_agent(policies=, policy_mapping_fn=)`` trains a policy map (PPO, DQN
and SAC): one module and one LearnerGroup per policy, each on the GPU as
above, and ``MultiAgentEnvRunner`` CPU actors routing each agent's obs to its
policy. Remote learners of all the policies must fit the cluster's ``GPU``
together (``build()`` raises otherwise: the runtime would wait forever to
place the ones that do not).
"""

from __future__ import annotations

import copy
import os
import pickle
import time
import types
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from ray_tpu_torch._private.accelerators.gpu import default_device
from ray_tpu_torch.rllib.env.env_runner import is_discrete

# What each env-runner actor holds: one CPU, and its forward runs one thread.
RUNNER_CPUS = 1


class AlgorithmConfig:
    def __init__(self):
        self.env: Union[str, Callable, None] = None
        self.env_config: Dict[str, Any] = {}
        self.lr = 3e-4
        self.gamma = 0.99
        self.train_batch_size = 512
        self.seed = 0
        self.num_env_runners = 2
        self.num_envs_per_runner = 4
        self.rollout_fragment_length = 64
        self.num_learners = 0  # 0 = local learner in the driver process
        # The GPUs each learner holds; 0 = the CPU (see the module docstring).
        self.num_gpus_per_learner = 1.0
        self.model: Dict[str, Any] = {"hiddens": (64, 64)}
        self.framework_str = "torch"
        # Multi-agent (reference `algorithm_config.py` `.multi_agent()`):
        # policies maps policy_id -> None (spaces inferred from the env's
        # per-agent dicts via policy_mapping_fn). Empty = single-agent.
        self.policies: Dict[str, Any] = {}
        self.policy_mapping_fn: Optional[Callable[[str], str]] = None
        self.policies_to_train: Optional[List[str]] = None
        # Offline data (reference `.offline_data(input_=...)`): a path/glob/
        # list of JSON-lines files, an InputReader, or a zero-arg callable
        # returning an InputReader.
        self.input_: Any = None
        # Connector specs (reference `rllib/connectors/`): a Connector
        # instance, a factory callable, or a list of either — built fresh
        # inside each runner actor.
        self.env_to_module_connector: Any = None
        self.module_to_env_connector: Any = None
        # Evaluation (reference `.evaluation(...)`,
        # `algorithm.py:847 evaluate()`): a dedicated eval-runner fleet
        # sampling with its own explore setting every `evaluation_interval`
        # training iterations for `evaluation_duration` episodes/timesteps.
        self.evaluation_interval: Optional[int] = None
        self.evaluation_duration: int = 10
        self.evaluation_duration_unit: str = "episodes"
        self.evaluation_num_env_runners: int = 1
        self.evaluation_explore: bool = False
        # Exploration (reference `.exploration(exploration_config=...)`,
        # `rllib/utils/exploration/`): None -> each algorithm's built-in
        # default (DQN epsilon-greedy, stochastic policies sample); a dict
        # {"type": "SoftQ", ...} plugs a strategy from
        # `ray_tpu_torch.rllib.utils.exploration` into every env runner.
        self.explore: bool = True
        self.exploration_config: Any = None
        # Lifecycle hooks (reference `AlgorithmConfig.callbacks`): a
        # DefaultCallbacks subclass, instantiated on the driver AND inside
        # each env-runner actor (episode/sample hooks run there).
        from ray_tpu_torch.rllib.callbacks import DefaultCallbacks

        self.callbacks_class = DefaultCallbacks

    # ------------------------------------------------------------ fluent API
    def environment(self, env=None, *, env_config: Optional[dict] = None) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training option '{k}'")
            setattr(self, k, v)
        return self

    def env_runners(
        self,
        num_env_runners: Optional[int] = None,
        num_envs_per_runner: Optional[int] = None,
        rollout_fragment_length: Optional[int] = None,
        env_to_module_connector: Any = None,
        module_to_env_connector: Any = None,
    ) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_runner is not None:
            self.num_envs_per_runner = num_envs_per_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if env_to_module_connector is not None:
            self.env_to_module_connector = env_to_module_connector
        if module_to_env_connector is not None:
            self.module_to_env_connector = module_to_env_connector
        return self

    def evaluation(
        self,
        evaluation_interval: Optional[int] = None,
        evaluation_duration: Optional[int] = None,
        evaluation_duration_unit: Optional[str] = None,
        evaluation_num_env_runners: Optional[int] = None,
        evaluation_explore: Optional[bool] = None,
    ) -> "AlgorithmConfig":
        """Configure the dedicated evaluation pass (reference:
        `AlgorithmConfig.evaluation`)."""
        if evaluation_interval is not None:
            self.evaluation_interval = int(evaluation_interval)
        if evaluation_duration is not None:
            self.evaluation_duration = int(evaluation_duration)
        if evaluation_duration_unit is not None:
            if evaluation_duration_unit not in ("episodes", "timesteps"):
                raise ValueError(
                    "evaluation_duration_unit must be 'episodes' or 'timesteps'"
                )
            self.evaluation_duration_unit = evaluation_duration_unit
        if evaluation_num_env_runners is not None:
            self.evaluation_num_env_runners = int(evaluation_num_env_runners)
        if evaluation_explore is not None:
            self.evaluation_explore = bool(evaluation_explore)
        return self

    def exploration(
        self,
        explore: Optional[bool] = None,
        exploration_config: Any = None,
    ) -> "AlgorithmConfig":
        """Configure exploration (reference: `AlgorithmConfig.exploration`)."""
        if explore is not None:
            self.explore = bool(explore)
        if exploration_config is not None:
            from ray_tpu_torch.rllib.utils.exploration import build_exploration

            build_exploration(exploration_config)  # validate eagerly
            self.exploration_config = exploration_config
        return self

    def learners(self, num_learners: Optional[int] = None,
                 num_gpus_per_learner: Optional[float] = None) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        if num_gpus_per_learner is not None:
            self.num_gpus_per_learner = float(num_gpus_per_learner)
        return self

    def callbacks(self, callbacks_class) -> "AlgorithmConfig":
        # Reference: `AlgorithmConfig.callbacks` — set the DefaultCallbacks
        # subclass driving lifecycle hooks.
        from ray_tpu_torch.rllib.callbacks import DefaultCallbacks

        if not (isinstance(callbacks_class, type)
                and issubclass(callbacks_class, DefaultCallbacks)):
            raise ValueError(
                "callbacks_class must be a DefaultCallbacks subclass"
            )
        self.callbacks_class = callbacks_class
        return self

    def multi_agent(
        self,
        *,
        policies=None,
        policy_mapping_fn: Optional[Callable[[str], str]] = None,
        policies_to_train: Optional[List[str]] = None,
    ) -> "AlgorithmConfig":
        """Configure the policy map (reference: `AlgorithmConfig.multi_agent`).

        `policies` is a dict policy_id -> None or an iterable of policy ids;
        module specs are inferred from the MultiAgentEnv's per-agent spaces.
        `policy_mapping_fn(agent_id) -> policy_id` routes agents; default maps
        every agent to the sole policy (valid only with one policy).
        """
        if policies is not None:
            if isinstance(policies, dict):
                self.policies = dict(policies)
            else:
                self.policies = {pid: None for pid in policies}
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        if policies_to_train is not None:
            self.policies_to_train = list(policies_to_train)
        return self

    @property
    def is_multi_agent(self) -> bool:
        return bool(self.policies)

    def offline_data(self, *, input_=None) -> "AlgorithmConfig":
        """Configure the offline input source (reference:
        `AlgorithmConfig.offline_data`). See `input_` in `__init__`."""
        if input_ is not None:
            self.input_ = input_
        return self

    def build_input_reader(self, batch_size: int, seed: int = 0):
        """Resolve `input_` into an InputReader (the offline plugin seam)."""
        from ray_tpu_torch.rllib.offline import DatasetReader, InputReader, JsonReader

        src = self.input_
        if src is None:
            raise ValueError("offline training requires config.offline_data(input_=...)")
        if isinstance(src, InputReader):
            return src
        if isinstance(src, (str, list, tuple)):
            return JsonReader(src, batch_size=batch_size, seed=seed)
        if hasattr(src, "iter_batches"):  # a Dataset, known by its interface
            return DatasetReader(src, batch_size=batch_size)
        if callable(src):
            return src()
        raise TypeError(f"unsupported offline input source: {type(src)}")

    def framework(self, framework: str) -> "AlgorithmConfig":
        if framework != "torch":
            raise ValueError("this build is the PyTorch port; framework must be 'torch'")
        self.framework_str = framework
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build(self) -> "Algorithm":
        from ray_tpu_torch._private import usage

        usage.record_library_usage("rllib")
        algo_cls = getattr(self, "_algo_cls", None) or Algorithm
        algo = algo_cls(self.copy())
        # After the SUBCLASS finished constructing (buffers, targets, ...).
        algo.callbacks.on_algorithm_init(algorithm=algo)
        return algo

    def env_creator(self) -> Callable[[], Any]:
        env, cfg = self.env, self.env_config
        if callable(env):
            return lambda: env(cfg) if cfg else env()
        if isinstance(env, str):
            return lambda: gym_make(env, **cfg)
        raise ValueError("config.environment(env=...) is required")


def gym_make(env_id: str, **kwargs):
    """``gymnasium.make(env_id, **kwargs)``: the port's one gymnasium import,
    reached only when an env is made from a string id."""
    import gymnasium as gym

    return gym.make(env_id, **kwargs)


class Algorithm:
    """Base driver; subclasses implement make_loss() + training_step()."""

    # Whether runners record the obs-sized final_obs buffer at truncation
    # boundaries (replay algorithms bootstrap through it; PPO uses
    # runner-side bootstrap VALUES instead and opts out of the payload).
    _record_final_obs = True
    # Whether runners record value/dist buffers (values, behavior_logits,
    # bootstrap_values, last_values); logp is always recorded for
    # policy-gradient modules.
    _record_value_extras = True

    def __init__(self, config: AlgorithmConfig):
        from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
        from ray_tpu_torch.rllib.utils.exploration import build_exploration

        if config.num_learners == 0 and config.num_gpus_per_learner > 0:
            default_device()  # no GPU: raise before any env or actor is made
        self.config = config
        self.iteration = 0
        # Cumulative sampled env steps, maintained on EVERY algorithm: replay
        # algorithms (DQN) advance it inside training_step; for the rest,
        # train() folds in the per-iteration num_env_steps_sampled metric.
        # Exploration schedules anneal against this.
        self.env_steps = 0
        self.callbacks = config.callbacks_class()
        # Driver-side strategy instance: owns the annealing schedule whose
        # values are pushed to runners each iteration (`exploration_push`).
        self.exploration = build_exploration(config.exploration_config)
        creator = config.env_creator()
        if config.is_multi_agent:
            self._init_multi_agent(creator)
            return
        probe = creator()
        obs_space, act_space = probe.observation_space, probe.action_space
        probe.close()
        obs_dim = int(np.prod(obs_space.shape))
        if is_discrete(act_space):
            self.module = self.make_module(obs_dim, int(act_space.n))
        else:
            self.module = self.make_module_continuous(obs_dim, act_space)
        self.learner_group = LearnerGroup(
            self.module,
            self.make_loss(),
            num_learners=config.num_learners,
            learning_rate=config.lr,
            optimizer=self.make_optimizer(),
            seed=config.seed,
            extra_update_fn=self.make_extra_update(),
            num_gpus_per_learner=config.num_gpus_per_learner,
        )
        if not self._needs_env_runners:
            # Offline algorithms train from an InputReader; the env exists
            # only for spaces and evaluation.
            self.env_runners: List[Any] = []
            return
        self.env_runners = self._make_env_runners(
            creator, config.num_env_runners, seed_base=config.seed
        )

    def _make_env_runners(self, creator, n: int, seed_base: int) -> List[Any]:
        import ray_tpu_torch
        from ray_tpu_torch.rllib.env.env_runner import EnvRunner

        config = self.config
        runner_cls = ray_tpu_torch.remote(EnvRunner)
        return [
            runner_cls.options(num_cpus=RUNNER_CPUS).remote(
                creator,
                self.module,
                num_envs=config.num_envs_per_runner,
                rollout_length=config.rollout_fragment_length,
                seed=seed_base + 1000 * (i + 1),
                gamma=config.gamma,
                record_final_obs=self._record_final_obs,
                record_value_extras=self._record_value_extras,
                obs_connector=config.env_to_module_connector,
                action_connector=config.module_to_env_connector,
                exploration=config.exploration_config,
                default_explore=config.explore,
                callbacks=config.callbacks_class,
                num_cpus=RUNNER_CPUS,
            )
            for i in range(n)
        ]

    def exploration_push(self, env_steps: int):
        """What to push to runners this iteration: the configured strategy's
        schedule dict, or None when there is nothing to anneal."""
        if self.exploration is None:
            return None
        sched = self.exploration.schedule(env_steps)
        return sched or None

    # ------------------------------------------------------------- multi-agent
    # Whether this algorithm supports policy maps (PPO, DQN and SAC opt in),
    # as in the JAX package.
    _supports_multi_agent = False
    # Offline algorithms (MARWIL, BC, CQL) set False: no sampling actors.
    _needs_env_runners = True

    def _init_multi_agent(self, creator) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.rllib.core.learner_group import LearnerGroup

        config = self.config
        if not self._supports_multi_agent:
            raise ValueError(
                f"{type(self).__name__} does not support multi-agent training"
            )
        if config.exploration_config is not None:
            # MultiAgentEnvRunner routes exploration through per-policy
            # module forwards (epsilon push only); silently ignoring a
            # configured strategy would misreport what trained.
            raise ValueError(
                "exploration_config strategies are single-agent only; "
                "multi-agent policies use their modules' built-in exploration"
            )
        mapping = config.policy_mapping_fn
        if mapping is None:
            if len(config.policies) != 1:
                raise ValueError(
                    "policy_mapping_fn is required with more than one policy"
                )
            only = next(iter(config.policies))
            mapping = lambda aid: only  # noqa: E731
            config.policy_mapping_fn = mapping
        probe = creator()
        try:
            obs_spaces, act_spaces = probe.observation_space, probe.action_space
            if not isinstance(obs_spaces, dict):
                raise ValueError(
                    "multi-agent training requires a MultiAgentEnv with dict "
                    "observation/action spaces (see make_multi_agent)"
                )
            # One representative agent per policy defines its module spec.
            # Every agent must map INTO the policy map — an unmapped agent
            # would die with a bare KeyError inside the runner actor later.
            agent_of: Dict[str, str] = {}
            for aid in obs_spaces:
                pid = mapping(aid)
                if pid not in config.policies:
                    raise ValueError(
                        f"policy_mapping_fn({aid!r}) -> {pid!r}, which is not "
                        f"in policies {sorted(config.policies)}"
                    )
                agent_of.setdefault(pid, aid)
            missing = set(config.policies) - set(agent_of)
            if missing:
                raise ValueError(
                    f"no agent maps to policies {sorted(missing)}; check "
                    "policy_mapping_fn against the env's agent ids"
                )
            self.modules: Dict[str, Any] = {}
            for pid, aid in agent_of.items():
                act_space = act_spaces[aid]
                obs_dim = int(np.prod(obs_spaces[aid].shape))
                if is_discrete(act_space):
                    self.modules[pid] = self.make_module(obs_dim, int(act_space.n))
                else:
                    self.modules[pid] = self.make_module_continuous(obs_dim, act_space)
        finally:
            probe.close()
        if config.num_learners > 0 and config.num_gpus_per_learner > 0:
            # Every policy's group holds num_learners x num_gpus_per_learner
            # of GPU; the runtime would wait forever to place what does not
            # fit, so refuse it here.
            asked = len(self.modules) * config.num_learners * config.num_gpus_per_learner
            node_gpu = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            if asked > node_gpu:
                raise ValueError(
                    f"{len(self.modules)} policies x {config.num_learners} learners x "
                    f"{config.num_gpus_per_learner} GPU each ask for {asked} GPU, but the "
                    f"cluster has {node_gpu}: lower num_gpus_per_learner"
                )
        self.module = None
        self.learner_group = None
        self.learner_groups: Dict[str, LearnerGroup] = {
            pid: LearnerGroup(
                mod,
                self.make_loss(),
                num_learners=config.num_learners,
                learning_rate=config.lr,
                optimizer=self.make_optimizer(),
                seed=config.seed + 31 * i,
                extra_update_fn=self.make_extra_update(),
                num_gpus_per_learner=config.num_gpus_per_learner,
            )
            for i, (pid, mod) in enumerate(self.modules.items())
        }
        self.env_runners = self._make_multi_agent_runners(
            creator, config.num_env_runners, seed_base=config.seed
        )

    def _make_multi_agent_runners(self, creator, n: int, seed_base: int) -> List[Any]:
        import ray_tpu_torch
        from ray_tpu_torch.rllib.env.multi_agent_env_runner import MultiAgentEnvRunner

        config = self.config
        runner_cls = ray_tpu_torch.remote(MultiAgentEnvRunner)
        return [
            runner_cls.options(num_cpus=RUNNER_CPUS).remote(
                creator,
                self.modules,
                config.policy_mapping_fn,
                num_envs=config.num_envs_per_runner,
                rollout_length=config.rollout_fragment_length,
                seed=seed_base + 1000 * (i + 1),
                gamma=config.gamma,
                lambda_=getattr(config, "lambda_", 0.95),
                default_explore=config.explore,
                callbacks=config.callbacks_class,
                num_cpus=RUNNER_CPUS,
            )
            for i in range(n)
        ]

    @property
    def is_multi_agent(self) -> bool:
        return self.config.is_multi_agent

    def policy_weights(self) -> Dict[str, Any]:
        """Every policy's weights, as numpy trees (what runners are sent)."""
        return {pid: lg.get_weights() for pid, lg in self.learner_groups.items()}

    # -------------------------------------------------------------- interface
    # What the base module kind is for Discrete action spaces; value-based
    # algorithms (DQN) override to "q". Routed through the ModelCatalog so
    # `config.model` (hiddens/activation/custom_module) drives architecture
    # (reference: `rllib/models/catalog.py:197`).
    _module_kind = "pi_vf"

    def make_module(self, obs_dim: int, num_actions: int):
        """The RLModule for this algorithm, built by the catalog from
        `config.model`."""
        from ray_tpu_torch.rllib.models.catalog import ModelCatalog

        return ModelCatalog.get_module(
            self._module_kind, obs_dim, types.SimpleNamespace(n=num_actions), self.config.model,
        )

    def make_module_continuous(self, obs_dim: int, act_space):
        """RLModule for Box action spaces (continuous-control algorithms
        override, e.g. SAC's squashed-Gaussian actor + twin critics)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support continuous action spaces"
        )

    def make_loss(self) -> Callable:
        raise NotImplementedError

    def make_optimizer(self):
        """Optional optimizer; None -> the learner's default adam(lr)."""
        return None

    def make_extra_update(self) -> Optional[Callable]:
        """Optional (new_params, extra) -> new_extra applied after each
        learner step (e.g. SAC's polyak target blend)."""
        return None

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def collect_episode_metrics(self, out: Dict[str, Any]) -> Dict[str, Any]:
        """Fetch per-runner episode stats and fold the episode-weighted means
        into `out` (shared by every algorithm's training_step)."""
        import ray_tpu_torch

        stats = ray_tpu_torch.get([r.episode_stats.remote() for r in self.env_runners])
        episodes = [s for s in stats if s.get("episodes", 0) > 0]
        if episodes:
            weights = [s["episodes"] for s in episodes]
            out["episode_return_mean"] = float(
                np.average([s["episode_return_mean"] for s in episodes], weights=weights)
            )
            if all("episode_len_mean" in s for s in episodes):
                out["episode_len_mean"] = float(
                    np.average([s["episode_len_mean"] for s in episodes], weights=weights)
                )
            out["episodes_this_iter"] = int(sum(weights))
        return out

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch

        t0 = time.time()
        self.iteration += 1
        # Annealed strategy state (epsilon/scale/pure_random) is pushed to
        # every algorithm's runners here. One-iteration lag on env_steps is
        # inherent (steps count after sampling).
        push = self.exploration_push(self.env_steps)
        if push is not None and self.env_runners:
            ray_tpu_torch.get(
                [r.set_exploration.remote(push) for r in self.env_runners]
            )
        steps_before = self.env_steps
        metrics = self.training_step()
        if self.env_steps == steps_before:
            # Replay algorithms advance env_steps themselves (and report the
            # cumulative total as the metric); everyone else reports the
            # per-iteration count — fold it into the schedule counter here.
            self.env_steps = steps_before + int(
                metrics.get("num_env_steps_sampled") or 0
            )
        if push is not None:
            metrics.update(
                {f"exploration/{k}": float(np.asarray(v)) for k, v in push.items()}
            )
        cfg = self.config
        if (
            cfg.evaluation_interval
            and self.iteration % cfg.evaluation_interval == 0
        ):
            metrics["evaluation"] = self.evaluate()["evaluation"]
        metrics["training_iteration"] = self.iteration
        metrics["time_this_iter_s"] = time.time() - t0
        self.callbacks.on_train_result(algorithm=self, result=metrics)
        return metrics

    # ------------------------------------------------------------- evaluation
    def _ensure_eval_runners(self) -> List[Any]:
        """Dedicated eval-runner fleet, built lazily on first evaluate()
        (reference: `Algorithm.evaluate` + `evaluation_num_env_runners` —
        evaluation never samples through the training runners)."""
        if getattr(self, "_eval_runners", None):
            return self._eval_runners
        config = self.config
        n = max(1, config.evaluation_num_env_runners)
        if self.is_multi_agent:
            # Seeds config.seed + 555_000 + 1000 * i, as the JAX package's.
            self._eval_runners = self._make_multi_agent_runners(
                config.env_creator(), n, seed_base=config.seed + 554_000)
        else:
            self._eval_runners = self._make_env_runners(
                config.env_creator(), n, seed_base=config.seed + 555_000)
        return self._eval_runners

    def evaluate(self) -> Dict[str, Any]:
        """Run a dedicated evaluation pass and return {"evaluation": metrics}
        (reference: `rllib/algorithms/algorithm.py:847 def evaluate`).
        Samples `evaluation_duration` episodes (or timesteps) on the eval
        fleet with `evaluation_explore` (deterministic by default), entirely
        separate from training rollouts."""
        import ray_tpu_torch

        cfg = self.config
        self.callbacks.on_evaluate_start(algorithm=self)
        runners = self._ensure_eval_runners()
        if self.is_multi_agent:
            weights = self.policy_weights()
        else:
            weights = self.learner_group.get_weights()
        sync = [r.set_weights.remote(weights) for r in runners]
        # Exploration schedules live in the driver: push the current annealed
        # value so evaluation_explore=True measures the schedule's policy, not
        # a fresh runner's initial-state default (epsilon=1.0 / scale=1.0).
        if cfg.evaluation_explore:
            if self.exploration is not None:
                push = self.exploration_push(self.env_steps)
                if push is not None:
                    sync += [r.set_exploration.remote(push) for r in runners]
            elif callable(getattr(self, "epsilon", None)):
                sync += [r.set_exploration.remote(self.epsilon()) for r in runners]
        # Eval runners adopt the training runners' connector state, frozen,
        # so normalization matches training without polluting its stats.
        if not self.is_multi_agent and self.env_runners and cfg.env_to_module_connector:
            state = ray_tpu_torch.get(self.env_runners[0].get_connector_state.remote())
            sync += [
                r.set_connector_state.remote(state, freeze=True) for r in runners
            ]
        ray_tpu_torch.get(sync)
        # Drop episodes left over from a previous evaluate() round.
        ray_tpu_torch.get([r.episode_stats.remote(clear=True) for r in runners])

        episodes = 0
        steps = 0
        ret_sum = 0.0
        len_sum = 0.0
        ret_min, ret_max = float("inf"), float("-inf")
        target = max(1, cfg.evaluation_duration)
        by_episodes = cfg.evaluation_duration_unit == "episodes"
        rounds = 0
        while True:
            rounds += 1
            samples = ray_tpu_torch.get(
                [r.sample.remote(explore=cfg.evaluation_explore) for r in runners]
            )
            stats = ray_tpu_torch.get([r.episode_stats.remote(clear=True) for r in runners])
            for ro in samples:
                if "rewards" in ro and not isinstance(ro.get("rewards"), dict):
                    steps += int(np.asarray(ro["rewards"]).size)
                else:
                    # Multi-agent: per-policy column dicts. PG maps carry
                    # advantages; replay maps carry rewards — count whichever
                    # exists.
                    steps += sum(
                        int(np.asarray(cols["rewards"] if "rewards" in cols
                                       else cols["advantages"]).size)
                        for cols in ro.values()
                    )
            for s in stats:
                n = int(s.get("episodes", 0))
                if n:
                    episodes += n
                    ret_sum += s["episode_return_mean"] * n
                    len_sum += s.get("episode_len_mean", 0.0) * n
                    ret_min = min(ret_min, s.get("episode_return_min", s["episode_return_mean"]))
                    ret_max = max(ret_max, s.get("episode_return_max", s["episode_return_mean"]))
            if by_episodes:
                if episodes >= target:
                    break
            elif steps >= target:
                break
            if rounds >= 100:
                # A degenerate env that never finishes an episode must not
                # hang evaluation forever.
                break
        metrics: Dict[str, Any] = {
            "num_episodes": episodes,
            "num_env_steps_sampled": steps,
        }
        if episodes:
            metrics["episode_return_mean"] = ret_sum / episodes
            metrics["episode_len_mean"] = len_sum / episodes
            metrics["episode_return_min"] = ret_min
            metrics["episode_return_max"] = ret_max
        out = {"evaluation": metrics}
        self.callbacks.on_evaluate_end(algorithm=self, evaluation_metrics=out)
        return out

    # ------------------------------------------------------------ checkpoints
    def _extra_state(self) -> Dict[str, Any]:
        """Algorithm-specific state beyond learner weights (e.g. PPO kl_coeff)."""
        return {}

    def _load_extra_state(self, state: Dict[str, Any]) -> None:
        pass

    def save(self, path: str) -> str:
        """Pickle the iteration, the learner state and the algorithm's own
        state, all numpy: a checkpoint written on the GPU loads on the CPU."""
        os.makedirs(path, exist_ok=True)
        if self.is_multi_agent:
            learner_state = {pid: lg.state() for pid, lg in self.learner_groups.items()}
        else:
            learner_state = self.learner_group.state()
        with open(os.path.join(path, "algo_state.pkl"), "wb") as fh:
            pickle.dump(
                {
                    "iteration": self.iteration,
                    "learner": learner_state,
                    "extra": self._extra_state(),
                },
                fh,
            )
        return path

    def restore(self, path: str) -> None:
        with open(os.path.join(path, "algo_state.pkl"), "rb") as fh:
            state = pickle.load(fh)
        self.iteration = state["iteration"]
        if self.is_multi_agent:
            for pid, s in state["learner"].items():
                self.learner_groups[pid].load_state(s)
        else:
            self.learner_group.load_state(state["learner"])
        self._load_extra_state(state.get("extra", {}))

    def stop(self) -> None:
        """Kill the env runners and the remote learners."""
        import ray_tpu_torch

        for r in list(self.env_runners) + list(getattr(self, "_eval_runners", [])):
            ray_tpu_torch.kill(r)
        self.env_runners, self._eval_runners = [], []
        groups = self.learner_groups.values() if self.is_multi_agent else [self.learner_group]
        for group in groups:
            group.stop()
