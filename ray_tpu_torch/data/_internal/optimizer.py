"""Rule-based logical-plan optimizer.

Reference: `python/ray/data/_internal/logical/optimizers.py` (`LogicalOptimizer`
applying a rule list) with the two load-bearing rules re-implemented for this
plan shape:

- `ReorderRandomizeBlocksRule`
  (`logical/rules/randomize_blocks.py`): `randomize_block_order` is
  order-only — per-block transforms commute with it — so the rule lifts it
  out of the op chain into a SOURCE permutation. Left in place it would
  split an otherwise-fusable map chain in two.
- `OperatorFusionRule` (`logical/rules/operator_fusion.py`): consecutive
  per-block ops collapse into one task (or fuse into the read task /
  actor-pool call) — one serialization per block instead of one per op.

The plan here is deliberately small: a Dataset is `source + [logical ops]`,
so rules transform an `OptimizedPlan` of that shape and record their
application for observability (`applied_rules` — tests and EXPLAIN-style
debugging read it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


@dataclass
class OptimizedPlan:
    """What the optimizer hands physical compilation."""

    # Logical per-block op chain (post-rule).
    ops: List[Tuple[str, Any]]
    # Seeds of lifted randomize_block_order ops, applied to the source's
    # entry/bundle order before execution (composition collapses to applying
    # each permutation in sequence).
    source_permute_seeds: List[Optional[int]] = field(default_factory=list)
    # Rule names that changed the plan, in application order.
    applied_rules: List[str] = field(default_factory=list)
    # Fused segments produced by OperatorFusionRule: each entry is
    # ("map", [ops...]) or ("actors", (payload, tail_ops)).
    segments: List[Tuple[str, Any]] = field(default_factory=list)


class Rule:
    """One plan-rewriting rule (reference: `logical/interfaces.py Rule`)."""

    name = "rule"

    def apply(self, plan: OptimizedPlan) -> OptimizedPlan:
        raise NotImplementedError


class ReorderRandomizeBlocksRule(Rule):
    name = "ReorderRandomizeBlocks"

    def apply(self, plan: OptimizedPlan) -> OptimizedPlan:
        kept = []
        lifted = False
        for kind, payload in plan.ops:
            if kind == "randomize_block_order":
                plan.source_permute_seeds.append(payload)
                lifted = True
            else:
                kept.append((kind, payload))
        if lifted:
            plan.ops = kept
            plan.applied_rules.append(self.name)
        return plan


class OperatorFusionRule(Rule):
    name = "OperatorFusion"

    def apply(self, plan: OptimizedPlan) -> OptimizedPlan:
        segments: List[Tuple[str, Any]] = []
        segment: List = []
        fused = False

        def flush():
            nonlocal segment, fused
            if segment:
                if len(segment) > 1:
                    fused = True
                segments.append(("map", segment))
                segment = []

        i = 0
        ops = plan.ops
        while i < len(ops):
            kind, payload = ops[i]
            if kind == "map_batches_actors":
                flush()
                # Fuse the fusable per-block tail into the actor call.
                tail: List = []
                j = i + 1
                while j < len(ops) and ops[j][0] != "map_batches_actors":
                    tail.append(ops[j])
                    j += 1
                if tail:
                    fused = True
                segments.append(("actors", (payload, tail)))
                i = j
            else:
                segment.append(ops[i])
                i += 1
        flush()
        plan.segments = segments
        if fused:
            plan.applied_rules.append(self.name)
        return plan


DEFAULT_RULES: List[Rule] = [ReorderRandomizeBlocksRule(), OperatorFusionRule()]


def optimize(ops: List[Tuple[str, Any]], rules: Optional[List[Rule]] = None) -> OptimizedPlan:
    plan = OptimizedPlan(ops=list(ops))
    for rule in rules if rules is not None else DEFAULT_RULES:
        plan = rule.apply(plan)
    return plan
