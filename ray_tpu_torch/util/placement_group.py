"""Placement groups: gang resource reservation across nodes.

Reference: `python/ray/util/placement_group.py` (`PlacementGroup:33`,
`placement_group():136`, strategies incl. STRICT_PACK at `:152`), backed by the GCS
placement-group manager + bundle scheduling policies
(`gcs_placement_group_manager.h:223`, `bundle_scheduling_policy.cc`).

The JAX package's topology-aware `TPU_SLICE` strategy has no GPU counterpart
yet (ROADMAP.md Queue 1 item 8): asking for it raises NotImplementedError. GPU
gangs pack with STRICT_PACK.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.scheduler import Bundle, PGRecord
from ray_tpu_torch._private.worker import _auto_init, global_worker

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


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
        raise NotImplementedError(
            "the TPU_SLICE strategy has no GPU counterpart yet: ROADMAP.md Queue 1 item 8"
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

