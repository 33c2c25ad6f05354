"""RLlib utility subpackage: exploration strategies + replay buffers.

The counterpart of ``ray_tpu/rllib/utils/``; reference:
`rllib/utils/exploration/` and `rllib/utils/replay_buffers/`.
"""

from ray_tpu_torch.rllib.utils.exploration import (
    EpsilonGreedy,
    Exploration,
    GaussianNoise,
    OrnsteinUhlenbeckNoise,
    ParameterNoise,
    Random,
    SoftQ,
    StochasticSampling,
    build_exploration,
)
from ray_tpu_torch.rllib.utils.replay_buffers import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
)

__all__ = [
    "Exploration",
    "EpsilonGreedy",
    "SoftQ",
    "StochasticSampling",
    "Random",
    "GaussianNoise",
    "OrnsteinUhlenbeckNoise",
    "ParameterNoise",
    "build_exploration",
    "ReplayBuffer",
    "PrioritizedReplayBuffer",
]
