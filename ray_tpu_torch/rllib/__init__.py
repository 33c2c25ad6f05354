"""ray_tpu_torch.rllib: reinforcement learning on the port's actor runtime.

The counterpart of ``ray_tpu/rllib``; reference: `rllib/` —
`Algorithm(Trainable)` (`algorithms/algorithm.py:149`), sampling workers
(`evaluation/rollout_worker.py:166`) and the Learner stack
(`core/learner/learner.py:100`, `learner_group.py:48`, `core/rl_module/`).

Single-agent RLlib trains through ``Algorithm.train()``: env runners sample
on CPU actors and the ``TorchLearner`` updates on the GPU. On-policy: PPO,
A2C, PG, IMPALA and APPO (V-trace inside the loss). Online off-policy: DQN
(with its double-Q, n-step, dueling, C51 and prioritized-replay knobs), SAC,
TD3/DDPG and Ape-X DQN (replay shards on CPU actors). Offline, from JSON
input (``offline``): MARWIL, BC and CQL. Multi-agent: ``MultiAgentEnv`` and
``make_multi_agent``, and policy maps (``.multi_agent()``) for PPO, DQN and
SAC, one learner per policy on the GPU and ``MultiAgentEnvRunner`` CPU actors.
Offline input may also be a ``ray_tpu_torch.data`` Dataset
(``offline.DatasetReader``). The JAX package's ``JaxLearner`` is
``TorchLearner`` here.
"""

from ray_tpu_torch.rllib.algorithms.a2c import A2C, A2CConfig
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.apex_dqn import ApexDQN, ApexDQNConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig, Impala, ImpalaConfig
from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.pg import PG, PGConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.algorithms.td3 import TD3, DDPGConfig, TD3Config
from ray_tpu_torch.rllib.callbacks import DefaultCallbacks, Episode
from ray_tpu_torch.rllib.connectors import (
    ClipActions,
    ClipObs,
    Connector,
    ConnectorPipeline,
    FlattenObs,
    NormalizeObs,
    UnsquashActions,
)
from ray_tpu_torch.rllib.core.distributional import (
    DistributionalQModule,
    DuelingQMLPModule,
)
from ray_tpu_torch.rllib.core.learner import TorchLearner
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import (
    DeterministicContinuousModule,
    MLPModule,
    RLModule,
    SquashedGaussianModule,
)
from ray_tpu_torch.rllib.env.env_runner import EnvRunner
from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnv, make_multi_agent
from ray_tpu_torch.rllib.env.multi_agent_env_runner import MultiAgentEnvRunner
from ray_tpu_torch.rllib.models import MODEL_DEFAULTS, ModelCatalog, register_custom_module
from ray_tpu_torch.rllib.utils.exploration import Exploration, build_exploration
from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer, ReplayBuffer

__all__ = [
    "A2C",
    "A2CConfig",
    "APPO",
    "APPOConfig",
    "Algorithm",
    "AlgorithmConfig",
    "ApexDQN",
    "ApexDQNConfig",
    "BC",
    "BCConfig",
    "CQL",
    "CQLConfig",
    "ClipActions",
    "ClipObs",
    "Connector",
    "ConnectorPipeline",
    "DDPGConfig",
    "DQN",
    "DQNConfig",
    "DefaultCallbacks",
    "DeterministicContinuousModule",
    "DistributionalQModule",
    "DuelingQMLPModule",
    "EnvRunner",
    "Episode",
    "Exploration",
    "FlattenObs",
    "IMPALA",
    "IMPALAConfig",
    "Impala",
    "ImpalaConfig",
    "LearnerGroup",
    "MARWIL",
    "MARWILConfig",
    "MLPModule",
    "MODEL_DEFAULTS",
    "ModelCatalog",
    "MultiAgentEnv",
    "MultiAgentEnvRunner",
    "NormalizeObs",
    "PG",
    "PGConfig",
    "PPO",
    "PPOConfig",
    "PrioritizedReplayBuffer",
    "RLModule",
    "ReplayBuffer",
    "SAC",
    "SACConfig",
    "SquashedGaussianModule",
    "TD3",
    "TD3Config",
    "TorchLearner",
    "UnsquashActions",
    "build_exploration",
    "make_multi_agent",
    "register_custom_module",
]
