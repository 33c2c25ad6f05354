"""ray_tpu_torch.rllib: reinforcement learning on the port's actor runtime.

The counterpart of ``ray_tpu/rllib``; reference: `rllib/` —
`Algorithm(Trainable)` (`algorithms/algorithm.py:149`), sampling workers
(`evaluation/rollout_worker.py:166`) and the Learner stack
(`core/learner/learner.py:100`, `learner_group.py:48`, `core/rl_module/`).

PPO and DQN (with its double-Q, n-step, dueling, C51 and prioritized-replay
knobs) train through ``Algorithm.train()``: env runners sample on CPU actors,
the ``TorchLearner`` updates on the GPU. Multi-agent training, offline data
and the other algorithms are not ported yet (ROADMAP.md Queue 1 item 7).
"""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
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
    QMLPModule,
    RLModule,
    SquashedGaussianModule,
)
from ray_tpu_torch.rllib.env.env_runner import EnvRunner
from ray_tpu_torch.rllib.models import MODEL_DEFAULTS, ModelCatalog, register_custom_module
from ray_tpu_torch.rllib.utils.exploration import Exploration, build_exploration
from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer, ReplayBuffer

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "ClipActions",
    "ClipObs",
    "Connector",
    "ConnectorPipeline",
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
    "LearnerGroup",
    "MLPModule",
    "MODEL_DEFAULTS",
    "ModelCatalog",
    "NormalizeObs",
    "PPO",
    "PPOConfig",
    "PrioritizedReplayBuffer",
    "QMLPModule",
    "RLModule",
    "ReplayBuffer",
    "SquashedGaussianModule",
    "TorchLearner",
    "UnsquashActions",
    "build_exploration",
    "register_custom_module",
]
