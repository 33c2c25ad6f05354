"""Run-level config dataclasses shared by Train and Tune.

Reference: `python/ray/air/config.py` (`ScalingConfig`, `RunConfig`,
`FailureConfig:512`, `CheckpointConfig`).

GPU delta: `use_gpu` puts `GPU` in each worker's resources, as in the
reference. `num_workers` is the number of *processes*, one device each; a
`mesh` lays them out over the six mesh axes (a torch `DeviceMesh`,
`session.get_mesh()`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union


@dataclass
class ScalingConfig:
    """How to scale training: worker gang size and resources."""

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    # SPMD mesh layout for the training step: a MeshSpec or a dict of axis
    # sizes, e.g. {"data": 4} or {"data": 2, "tensor": 2}, over the gang's
    # processes. Pipeline, context and expert axes > 1 raise (not ported).
    mesh: Optional[Union[Dict[str, int], Any]] = None
    # GPUs each worker process holds (default 1 when use_gpu); the same as
    # resources_per_worker={"GPU": n}, so setting both raises.
    gpus_per_worker: Optional[float] = None
    # Elastic gang membership: on a worker/node loss the gang
    # drains survivors at a step boundary and re-forms at the new world size
    # instead of failing the run (resizes do NOT consume FailureConfig's
    # max_failures budget), then re-expands toward num_workers when capacity
    # returns. Elastic gangs are scheduled by plain resources, not an
    # all-or-nothing placement group.
    elastic: bool = False
    # Floor below which a resize is impossible and the loss is treated as an
    # ordinary gang failure. Defaults to 1.
    min_workers: Optional[int] = None

    def __post_init__(self):
        if self.mesh is not None:
            self.mesh_spec()  # a dict naming an axis MeshSpec lacks raises here
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if self.gpus_per_worker is not None and "GPU" in (self.resources_per_worker or {}):
            raise ValueError("set gpus_per_worker or resources_per_worker['GPU'], not both")
        if self.min_workers is not None and not (
            1 <= self.min_workers <= self.num_workers
        ):
            raise ValueError("min_workers must be in [1, num_workers]")

    @property
    def _resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = float(self.gpus_per_worker or 1.0)
        if not self.use_gpu:
            res.pop("GPU", None)
        res.setdefault("CPU", 1.0)
        return res

    def as_placement_group_bundles(self) -> list:
        return [dict(self._resources) for _ in range(self.num_workers)]

    def mesh_spec(self):
        """The mesh layout: ``mesh`` as a ``MeshSpec``, by default pure data
        parallelism over the workers."""
        from ray_tpu_torch.parallel.mesh import MeshSpec

        if self.mesh is None:
            return MeshSpec.for_data_parallel(self.num_workers)
        if isinstance(self.mesh, MeshSpec):
            return self.mesh
        return MeshSpec.from_dict(self.mesh)


@dataclass
class FailureConfig:
    """Retry policy for a run (reference: `air/config.py:512`).

    max_failures: total restarts-from-last-checkpoint allowed; 0 disables,
    -1 is unlimited.
    """

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """Checkpoint retention policy (reference `air/config.py` CheckpointConfig)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: bool = False

    def __post_init__(self):
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive or None")
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclass
class RunConfig:
    """Experiment-level settings: name, storage, failure + checkpoint policy."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    # Metric-threshold dict, a `ray_tpu_torch.tune.Stopper`, or a
    # `(trial_id, result) -> bool` callable.
    stop: Optional[Any] = None
    verbose: int = 1
    log_to_file: bool = False
    # Tune experiment-lifecycle hooks (`ray_tpu_torch.tune.Callback` instances).
    callbacks: Optional[List[Any]] = None
