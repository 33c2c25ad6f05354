"""The lifecycle-machine spec shared by rt-state's two verifier sides.

``LIFECYCLE_SPEC`` declares every core state machine the control plane
runs as string-compare transitions: which states exist, which edges are
legal, which module is allowed to drive each edge, the initial state, and
the terminal states. It is a PURE LITERAL, like ``protocol.MESSAGE_GRAMMAR``
— the static pass (``devtools/pass_lifecycle.py``) extracts it with
``ast.literal_eval`` and never imports this module, so linting the tree
cannot execute it.

Two consumers:

 - **Static** (`rt-lint`, pass ``lifecycle``): every state *write* in a
   covered module must go through :func:`step` (so the machine and target
   state are statically visible) and name a declared transition target from
   an authorized module; every state *comparison* must name a declared
   state. See ``devtools/pass_lifecycle.py`` for the full check list.
 - **Runtime** (this module): :func:`step` is the annotation the drive
   sites use::

       rec.state = lifecycle.step("task", rec.state, "RUNNING")

   Disarmed (the default), it is one module-attribute load and a branch —
   the ``session_monitor``/``failpoints`` zero-overhead pattern. Armed by
   ``RAY_TPU_TORCH_DEBUG_INVARIANTS=1``, it checks the ACTUAL old -> new edge
   (which the static pass cannot see) against the spec and raises
   AssertionError on an undeclared transition. Self-loops (old == new) are
   implicitly legal everywhere: hot paths re-assert the current state
   unconditionally (e.g. the heartbeat handlers' ``health = "ALIVE"``).

Machine notes (why some less-obvious edges are declared):

 - task: RUNNING -> PENDING is the retry requeue (worker death with
   retries left, or a blocked worker's queued successors going back to the
   scheduler). FAILED -> CANCELLED: every cancel path seals the error
   results first (``_store_error_results`` sets FAILED) and then stamps
   CANCELLED; the one direct PENDING -> CANCELLED is the kill-actor
   backlog sweep, which seals through the same helper *before* the stamp.
 - worker: blocked -> idle is a blocked head finishing with no pipelined
   successor; busy/blocked -> dying is the OOM killer taking the worker
   out of rotation before its process exits.
 - node_health: ALIVE -> DEAD without SUSPECT is legal — with
   ``health_check_failure_threshold`` small, the DEAD grace can be shorter
   than the two-period SUSPECT threshold.
 - placement_group: PENDING -> RESCHEDULING is a node death retracting a
   *partially* reserved group (placed bundles persist across a failed
   reserve pass).
 - transfer: ``_settle_locked`` writes a dynamic target; the runtime
   monitor still sees every actual edge.
"""

from __future__ import annotations

import threading
from typing import Dict, FrozenSet, List, Optional, Tuple

from ray_tpu_torch._private.concurrency import DEBUG_INVARIANTS

# Module strings below are spelled out rather than hoisted into named
# constants: the spec must stay ast.literal_eval-able.
LIFECYCLE_SPEC = {
    # ------------------------------------------------------------- tasks
    "task": {
        "attr": "state",
        "classes": ("TaskRecord",),
        "receivers": ("rec", "qrec", "crec"),
        "modules": ("ray_tpu_torch._private.scheduler",),
        "initial": "PENDING",
        "terminal": ("FINISHED", "CANCELLED"),
        "transitions": {
            "PENDING": {
                "RUNNING": ("ray_tpu_torch._private.scheduler",),
                "FAILED": ("ray_tpu_torch._private.scheduler",),
                "CANCELLED": ("ray_tpu_torch._private.scheduler",),
            },
            "RUNNING": {
                "FINISHED": ("ray_tpu_torch._private.scheduler",),
                "FAILED": ("ray_tpu_torch._private.scheduler",),
                "PENDING": ("ray_tpu_torch._private.scheduler",),
            },
            "FAILED": {
                "CANCELLED": ("ray_tpu_torch._private.scheduler",),
            },
        },
    },
    # ----------------------------------------------------------- workers
    "worker": {
        "attr": "state",
        "classes": ("WorkerHandle",),
        "receivers": ("wh", "w"),
        "modules": ("ray_tpu_torch._private.scheduler",),
        "initial": "idle",
        "terminal": ("dying",),
        "transitions": {
            "idle": {
                "busy": ("ray_tpu_torch._private.scheduler",),
            },
            "busy": {
                "idle": ("ray_tpu_torch._private.scheduler",),
                "blocked": ("ray_tpu_torch._private.scheduler",),
                "dying": ("ray_tpu_torch._private.scheduler",),
            },
            "blocked": {
                "busy": ("ray_tpu_torch._private.scheduler",),
                "idle": ("ray_tpu_torch._private.scheduler",),
                "dying": ("ray_tpu_torch._private.scheduler",),
            },
        },
    },
    "worker_health": {
        "attr": "health",
        "classes": ("WorkerHandle",),
        "receivers": ("wh", "w"),
        "modules": ("ray_tpu_torch._private.scheduler",),
        "initial": "ALIVE",
        "terminal": (),
        "transitions": {
            "ALIVE": {"SUSPECT": ("ray_tpu_torch._private.scheduler",)},
            "SUSPECT": {"ALIVE": ("ray_tpu_torch._private.scheduler",)},
        },
    },
    # ------------------------------------------------------------- nodes
    "node_health": {
        "attr": "health",
        "classes": ("NodeState",),
        "receivers": ("node", "n"),
        "modules": ("ray_tpu_torch._private.scheduler",),
        "initial": "ALIVE",
        "terminal": ("DEAD",),
        "transitions": {
            "ALIVE": {
                "SUSPECT": ("ray_tpu_torch._private.scheduler",),
                "DEAD": ("ray_tpu_torch._private.scheduler",),
            },
            "SUSPECT": {
                "ALIVE": ("ray_tpu_torch._private.scheduler",),
                "DEAD": ("ray_tpu_torch._private.scheduler",),
            },
        },
    },
    # ------------------------------------------------------------ actors
    "actor": {
        "attr": "state",
        "classes": ("ActorRecord", "ActorInfo"),
        "receivers": ("ar", "info"),
        "modules": ("ray_tpu_torch._private.scheduler", "ray_tpu_torch._private.gcs"),
        "initial": "PENDING",
        "terminal": ("DEAD",),
        "transitions": {
            "PENDING": {
                "ALIVE": ("ray_tpu_torch._private.scheduler",),
                "RESTARTING": ("ray_tpu_torch._private.scheduler",),
                "DEAD": ("ray_tpu_torch._private.scheduler",),
            },
            "ALIVE": {
                "RESTARTING": ("ray_tpu_torch._private.scheduler",),
                "DEAD": ("ray_tpu_torch._private.scheduler",),
            },
            "RESTARTING": {
                "ALIVE": ("ray_tpu_torch._private.scheduler",),
                "DEAD": ("ray_tpu_torch._private.scheduler",),
            },
        },
    },
    # -------------------------------------------------- placement groups
    "placement_group": {
        "attr": "state",
        "classes": ("PGRecord",),
        "receivers": ("pg",),
        "modules": ("ray_tpu_torch._private.scheduler",),
        "initial": "PENDING",
        "terminal": ("REMOVED",),
        "transitions": {
            "PENDING": {
                "CREATED": ("ray_tpu_torch._private.scheduler",),
                "RESCHEDULING": ("ray_tpu_torch._private.scheduler",),
                "REMOVED": ("ray_tpu_torch._private.scheduler",),
            },
            "CREATED": {
                "RESCHEDULING": ("ray_tpu_torch._private.scheduler",),
                "REMOVED": ("ray_tpu_torch._private.scheduler",),
            },
            "RESCHEDULING": {
                "CREATED": ("ray_tpu_torch._private.scheduler",),
                "REMOVED": ("ray_tpu_torch._private.scheduler",),
            },
        },
    },
    # ------------------------------------------- data-plane pull requests
    "transfer": {
        "attr": "state",
        "classes": ("_PullRequest",),
        "receivers": ("req", "cand"),
        "modules": ("ray_tpu_torch._private.object_transfer",),
        "initial": "queued",
        "terminal": ("done", "failed", "cancelled"),
        "transitions": {
            "queued": {
                "inflight": ("ray_tpu_torch._private.object_transfer",),
                "done": ("ray_tpu_torch._private.object_transfer",),
                "failed": ("ray_tpu_torch._private.object_transfer",),
                "cancelled": ("ray_tpu_torch._private.object_transfer",),
            },
            "inflight": {
                "done": ("ray_tpu_torch._private.object_transfer",),
                "failed": ("ray_tpu_torch._private.object_transfer",),
                "cancelled": ("ray_tpu_torch._private.object_transfer",),
            },
        },
    },
    # ------------------------------------------------------------- alerts
    "alert": {
        "attr": "state",
        "classes": ("AlertRule",),
        "receivers": ("rule",),
        "modules": ("ray_tpu_torch._private.timeseries",),
        "initial": "ok",
        "terminal": (),
        "transitions": {
            "ok": {"pending": ("ray_tpu_torch._private.timeseries",)},
            "pending": {
                "firing": ("ray_tpu_torch._private.timeseries",),
                "ok": ("ray_tpu_torch._private.timeseries",),
            },
            "firing": {"ok": ("ray_tpu_torch._private.timeseries",)},
        },
    },
    # -------------------------------------------------------------- serve
    "serve_replica": {
        "attr": "state",
        "classes": ("ReplicaInfo",),
        "receivers": ("rep", "r"),
        "modules": (
            "ray_tpu_torch.serve._private.controller",
            "ray_tpu_torch.serve._private.common",
        ),
        "initial": "STARTING",
        "terminal": ("STOPPED",),
        "transitions": {
            "STARTING": {
                "RUNNING": ("ray_tpu_torch.serve._private.controller",),
                "STOPPED": ("ray_tpu_torch.serve._private.controller",),
            },
            "RUNNING": {
                "DRAINING": ("ray_tpu_torch.serve._private.controller",),
                "STOPPED": ("ray_tpu_torch.serve._private.controller",),
            },
            "DRAINING": {
                "STOPPED": ("ray_tpu_torch.serve._private.controller",),
            },
        },
    },
    "serve_proxy": {
        "attr": "state",
        "classes": ("ProxyInfo",),
        "receivers": ("p",),
        "modules": (
            "ray_tpu_torch.serve._private.controller",
            "ray_tpu_torch.serve._private.common",
        ),
        "initial": "STARTING",
        "terminal": ("STOPPED",),
        "transitions": {
            "STARTING": {
                "RUNNING": ("ray_tpu_torch.serve._private.controller",),
                "STOPPED": ("ray_tpu_torch.serve._private.controller",),
            },
            "RUNNING": {
                "DRAINING": ("ray_tpu_torch.serve._private.controller",),
                "STOPPED": ("ray_tpu_torch.serve._private.controller",),
            },
            "DRAINING": {
                "STOPPED": ("ray_tpu_torch.serve._private.controller",),
            },
        },
    },
}


def machine_states(machine: dict) -> frozenset:
    """Every state the machine's spec entry mentions (initial, terminal,
    transition sources and targets)."""
    states = {machine["initial"]}
    states.update(machine.get("terminal", ()))
    for old, outs in machine.get("transitions", {}).items():
        states.add(old)
        states.update(outs)
    return frozenset(states)


# --------------------------------------------------------- runtime monitor
ENABLED = DEBUG_INVARIANTS

_MAX_VIOLATIONS = 256

_lock = threading.Lock()
_violations: List[str] = []
# machine -> (states, legal (old, new) edge set); compiled lazily on the
# first armed step() so the disarmed path never pays for it.
_tables: Optional[Dict[str, Tuple[FrozenSet[str], FrozenSet[Tuple[str, str]]]]] = None


def _compile() -> Dict[str, Tuple[FrozenSet[str], FrozenSet[Tuple[str, str]]]]:
    global _tables
    with _lock:
        if _tables is None:
            tables = {}
            for name, machine in LIFECYCLE_SPEC.items():
                edges = set()
                for old, outs in machine["transitions"].items():
                    for new in outs:
                        edges.add((old, new))
                tables[name] = (machine_states(machine), frozenset(edges))
            _tables = tables
    return _tables


def violations() -> List[str]:
    with _lock:
        return list(_violations)


def reset() -> None:
    with _lock:
        _violations.clear()


def _flag(msg: str) -> None:
    with _lock:
        if len(_violations) < _MAX_VIOLATIONS:
            _violations.append(msg)
    raise AssertionError(f"lifecycle-machine violation: {msg}")


def step(machine: str, old: str, new: str) -> str:
    """Annotate a state transition: ``x.state = step("task", x.state, "RUNNING")``.

    Returns ``new`` unchanged. Disarmed, that attribute load + branch is the
    entire cost. Armed, the actual ``old -> new`` edge is checked against
    LIFECYCLE_SPEC (self-loops implicitly legal) and an undeclared edge
    raises AssertionError, recorded in :func:`violations`.
    """
    if ENABLED:
        tables = _tables
        if tables is None:
            tables = _compile()
        entry = tables.get(machine)
        if entry is None:
            _flag(f"step() for unknown machine {machine!r}")
            return new
        if old != new:
            states, edges = entry
            if (old, new) not in edges:
                if new not in states:
                    _flag(f"{machine}: transition to undeclared state {new!r} "
                          f"(from {old!r})")
                elif old not in states:
                    _flag(f"{machine}: transition from undeclared state "
                          f"{old!r} (to {new!r})")
                else:
                    _flag(f"{machine}: illegal transition {old!r} -> {new!r}")
    return new
