from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    gpu_slice_placement_group,
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

__all__ = [
    "ActorPool",
    "PlacementGroup",
    "placement_group",
    "remove_placement_group",
    "gpu_slice_placement_group",
    "NodeAffinitySchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
]
