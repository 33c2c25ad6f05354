"""Ownership discipline: owner-path modules must not reach into the head's
task/object tables directly.

  O1 head-table-access   an owner-path module (`_private/ownership.py`,
                         `_private/worker.py`, `remote_function.py`,
                         `actor.py`) reads or writes a scheduler-owned table
                         (`tasks`, `object_table`, `holders`, `pins`,
                         `lineage_consumers`, `object_waiters`, `pending`)
                         through a scheduler reference

Why: the decentralization contract is that the OWNER process resolves its
objects from its OwnershipTable and everything else goes through the command
queue / request protocol. A direct `scheduler.tasks[...]` from the API layer
would (a) race the loop thread (those tables are loop-thread-only state) and
(b) quietly re-centralize bookkeeping the ownership redesign moved out of
the head. The scheduler's own module — and the devtools themselves — are
exempt by construction.

Detection is name-based on purpose (pure stdlib AST, no imports): an
attribute access `X.<table>` where the receiver expression mentions a
scheduler binding (`scheduler`, `sched`, or the `Scheduler` class) in one of
the owner-path modules.
"""

from __future__ import annotations

import ast
from typing import List

from ray_tpu_torch.devtools.astutil import Package, Violation, make_key

OWNER_PATH_MODULES = (
    "._private.ownership",
    "._private.worker",
    ".remote_function",
    ".actor",
)

HEAD_TABLES = {
    "tasks", "object_table", "holders", "pins", "lineage_consumers",
    "object_waiters", "pending",
}

_SCHED_TOKENS = ("scheduler", "sched", "Scheduler")


def _mentions_scheduler(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and any(t in sub.id for t in _SCHED_TOKENS):
            return True
        if isinstance(sub, ast.Attribute) and any(
            t in sub.attr for t in _SCHED_TOKENS
        ):
            return True
    return False


def run(pkg: Package) -> List[Violation]:
    violations: List[Violation] = []
    for module, tree in pkg.modules.items():
        if not module.endswith(OWNER_PATH_MODULES):
            continue
        path = pkg.paths[module]
        for node in ast.walk(tree):
            if not isinstance(node, ast.Attribute):
                continue
            if node.attr not in HEAD_TABLES:
                continue
            if not _mentions_scheduler(node.value):
                continue
            violations.append(
                Violation(
                    pass_id="ownership",
                    path=path,
                    line=node.lineno,
                    key=make_key("ownership", path, f"head_table.{node.attr}"),
                    message=(
                        f"owner-path module accesses the head's `{node.attr}` "
                        "table directly; go through the command queue / "
                        "request protocol (or the OwnershipTable) instead — "
                        "those tables are scheduler-loop-thread state"
                    ),
                )
            )
    return violations
