"""Placement groups: gang resource reservation across nodes.

Reference: `python/ray/util/placement_group.py` (`PlacementGroup:33`,
`placement_group():136`, strategies incl. STRICT_PACK at `:152`), backed by the GCS
placement-group manager + bundle scheduling policies
(`gcs_placement_group_manager.h:223`, `bundle_scheduling_policy.cc`).

This is the gang scheduler used for GPU slices: `gpu_slice_placement_group`
below reserves one bundle per host, and the `GPU_SLICE` strategy takes every
host of a gang from one NVLink domain (`util/gpu_topology_policy.py`), the
counterpart of the JAX package's ICI-aware `TPU_SLICE`. Asking for `TPU_SLICE`
raises ValueError naming `GPU_SLICE`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.scheduler import Bundle, PGRecord
from ray_tpu_torch._private.worker import _auto_init, global_worker

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD", "GPU_SLICE")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]], strategy: str):
        self._id = pg_id
        self.bundle_specs = bundles
        self.strategy = strategy

    @property
    def id(self) -> str:
        return self._id.hex()

    def ready(self, timeout: Optional[float] = None) -> bool:
        """Block until all bundles are reserved (or timeout). The reference returns
        an ObjectRef here; we return the readiness directly and also support
        `wait()` for parity."""
        return global_worker.context.pg_ready(self._id, timeout)

    def wait(self, timeout_seconds: Optional[float] = None) -> bool:
        return self.ready(timeout_seconds)

    def __reduce__(self):
        return (PlacementGroup, (self._id, self.bundle_specs, self.strategy))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    if strategy == "TPU_SLICE":
        raise ValueError(
            "the TPU_SLICE strategy places TPU hosts; on GPUs use GPU_SLICE, which "
            "takes a gang's hosts from one NVLink domain"
        )
    _auto_init()
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"Invalid strategy {strategy}; must be one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement group requires at least one bundle")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"Invalid bundle: {b}")
    pg_id = PlacementGroupID.from_random()
    rec = PGRecord(
        pg_id=pg_id,
        bundles=[
            Bundle(index=i, resources={k: float(v) for k, v in b.items()})
            for i, b in enumerate(bundles)
        ],
        strategy=strategy,
        name=name,
    )
    global_worker.context.create_pg(rec)
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    global_worker.context.remove_pg(pg._id)



def gpu_slice_placement_group(
    num_hosts: int,
    gpus_per_host: int = 8,
    cpus_per_host: float = 1.0,
    strategy: str = "GPU_SLICE",
) -> PlacementGroup:
    """Gang-reserve a GPU slice: one bundle per host, each holding that host's
    GPUs. The GPU_SLICE strategy places the bundles on distinct hosts of one
    NVLink domain (`util/gpu_topology_policy.py`), falling back to
    STRICT_SPREAD placement on clusters without `gpu_nvlink_domain` labels.
    The counterpart of the JAX package's `tpu_slice_placement_group`."""
    bundles = [{"CPU": cpus_per_host, "GPU": float(gpus_per_host)} for _ in range(num_hosts)]
    return placement_group(bundles, strategy=strategy)
