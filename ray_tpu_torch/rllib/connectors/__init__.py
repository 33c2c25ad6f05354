from ray_tpu_torch.rllib.connectors.connector import (
    Connector,
    ConnectorPipeline,
    build_connector,
)
from ray_tpu_torch.rllib.connectors.env_to_module import (
    ClipObs,
    FlattenObs,
    NormalizeObs,
)
from ray_tpu_torch.rllib.connectors.module_to_env import ClipActions, UnsquashActions

__all__ = [
    "Connector",
    "ConnectorPipeline",
    "build_connector",
    "FlattenObs",
    "ClipObs",
    "NormalizeObs",
    "ClipActions",
    "UnsquashActions",
]
