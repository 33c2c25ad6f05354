"""Scheduling strategies (reference: `python/ray/util/scheduling_strategies.py:15,41`)."""

from __future__ import annotations

from typing import Optional


class PlacementGroupSchedulingStrategy:
    """Pin a task/actor to a placement group (optionally a specific bundle)."""

    def __init__(
        self,
        placement_group,
        placement_group_bundle_index: int = -1,
        placement_group_capture_child_tasks: bool = False,
    ):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    """Pin a task/actor to a node by id; `soft` allows fallback if infeasible."""

    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


class NodeLabelSchedulingStrategy:
    def __init__(self, hard: Optional[dict] = None, soft: Optional[dict] = None):
        self.hard = hard or {}
        self.soft = soft or {}
