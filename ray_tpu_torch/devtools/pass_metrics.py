"""Metrics discipline.

  M1 bad-name        a Counter/Gauge/Histogram constructed with a name not
                     matching ``ray_tpu_[a-z0-9_]+``
  M2 undocumented    an exported metric name missing from the COMPONENTS.md
                     Observability table (the doc is the metrics contract)
  M3 hot-path        a hot-path module (scheduler/batching/object store/
                     worker/wire layers) importing util.metrics or calling
                     Metric methods (.inc/.observe) directly — hot paths bump
                     plain ints; materialization belongs in telemetry.py at
                     snapshot cadence
  M4 alert-rule      a DEFAULT_ALERT_RULES entry (timeseries.py, parsed as a
                     pure literal) whose rule name or referenced metric name
                     is missing from the COMPONENTS.md Observability tables —
                     a stale rule name fails the run (the failpoint-table
                     discipline, applied to the alert pack)
  M5 event-kind      a cluster-event kind that is either used at an emit
                     site (emit_event / _emit_event / append_cluster_event
                     with a literal kind) without being registered in
                     events.EVENT_KINDS, or registered but missing from the
                     COMPONENTS.md events table

`.set()` is not policed: the name collides with threading.Event.set, and the
import ban (M3) already keeps Metric objects out of hot modules entirely.
"""

from __future__ import annotations

import ast
import os
import re
from typing import List, Optional, Set

from ray_tpu_torch.devtools.astutil import (
    Package, Violation, call_name, const_str, make_key,
)

METRIC_CTORS = {"Counter", "Gauge", "Histogram"}
NAME_RE = re.compile(r"^ray_tpu_[a-z0-9_]+$")

# Modules on the task hot path: one frame per message/object flows through
# these, so Metric-object work (dict lookups, lock, float math) is banned.
DEFAULT_HOT_MODULES = (
    "ray_tpu_torch._private.scheduler",
    "ray_tpu_torch._private.batching",
    "ray_tpu_torch._private.object_store",
    "ray_tpu_torch._private.object_transfer",
    "ray_tpu_torch._private.worker",
    "ray_tpu_torch._private.worker_main",
    "ray_tpu_torch._private.serialization",
    "ray_tpu_torch._private.protocol",
    "ray_tpu_torch._private.gcs",
)

_METRIC_METHODS = {"inc", "observe"}

# Cluster-event emit sites whose first positional arg (the kind) is checked
# against events.EVENT_KINDS. Variable-kind forwarding (GCS.kv_event, the
# alert engine's sink) passes non-literals and is skipped by construction.
_EVENT_EMIT_FUNCS = {"emit_event", "_emit_event", "append_cluster_event"}


def _literal_assign(tree: ast.AST, var: str):
    """The pure-literal value assigned to module-level `var`, or None. Same
    contract as protocol.MESSAGE_GRAMMAR: parsed with ast.literal_eval so
    the linter never imports the runtime."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if isinstance(target, ast.Name) and target.id == var:
                try:
                    return ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    return None
    return None


def _doc_text(doc_path: Optional[str]) -> Optional[str]:
    if doc_path and os.path.exists(doc_path):
        with open(doc_path, "r", encoding="utf-8") as fh:
            return fh.read()
    return None


def run(pkg: Package, hot_modules=DEFAULT_HOT_MODULES,
        doc_text: Optional[str] = None,
        doc_path: Optional[str] = None) -> List[Violation]:
    violations: List[Violation] = []
    if doc_text is None:
        doc_text = _doc_text(doc_path)

    # Registries for M4/M5, parsed as literals from their home modules
    # (absent in fixture packages: the checks simply don't arm).
    alert_rules = None
    event_kinds = None
    for module, tree in pkg.modules.items():
        if module.endswith("_private.timeseries"):
            alert_rules = _literal_assign(tree, "DEFAULT_ALERT_RULES")
            _ts_path = pkg.paths[module]
        if module.endswith("_private.events"):
            event_kinds = _literal_assign(tree, "EVENT_KINDS")
            _ev_path = pkg.paths[module]
    if alert_rules and doc_text is not None:
        for rule in alert_rules:
            if not isinstance(rule, dict):
                continue
            rname = rule.get("name", "?")
            if rname not in doc_text:
                violations.append(Violation(
                    "metrics", _ts_path, 1,
                    make_key("metrics", _ts_path, f"alert-rule.{rname}"),
                    f"default alert rule {rname!r} is not listed in the "
                    f"COMPONENTS.md alert-pack table",
                ))
            metric = rule.get("metric", "")
            if metric and metric not in doc_text:
                violations.append(Violation(
                    "metrics", _ts_path, 1,
                    make_key("metrics", _ts_path, f"alert-metric.{metric}"),
                    f"alert rule {rname!r} references metric {metric!r}, "
                    f"which is not in the COMPONENTS.md Observability table",
                ))
    if event_kinds and doc_text is not None:
        for kind in event_kinds:
            if kind not in doc_text:
                violations.append(Violation(
                    "metrics", _ev_path, 1,
                    make_key("metrics", _ev_path, f"event-kind.{kind}"),
                    f"event kind {kind!r} is registered in EVENT_KINDS but "
                    f"missing from the COMPONENTS.md events table",
                ))

    reported: Set[str] = set()
    for module, tree in pkg.modules.items():
        path = pkg.paths[module]
        hot = module in hot_modules
        for node in ast.walk(tree):
            if isinstance(node, ast.Import) and hot:
                for alias in node.names:
                    if "util.metrics" in alias.name:
                        violations.append(Violation(
                            "metrics", path, node.lineno,
                            make_key("metrics", path, "hot-import"),
                            f"hot-path module {module} imports {alias.name}: "
                            f"hot paths bump plain ints, Metric objects live "
                            f"in telemetry.py",
                        ))
                continue
            if isinstance(node, ast.ImportFrom) and hot:
                if node.module and "util.metrics" in node.module:
                    violations.append(Violation(
                        "metrics", path, node.lineno,
                        make_key("metrics", path, "hot-import"),
                        f"hot-path module {module} imports {node.module}: "
                        f"hot paths bump plain ints, Metric objects live in "
                        f"telemetry.py",
                    ))
                continue
            if not isinstance(node, ast.Call):
                continue
            recv, meth = call_name(node)
            if (
                event_kinds is not None
                and meth in _EVENT_EMIT_FUNCS
                and node.args
                and not module.endswith("_private.events")
            ):
                kind = const_str(node.args[0])
                if kind is not None and kind not in event_kinds:
                    key = make_key("metrics", path,
                                   f"event-unregistered.{kind}")
                    if key not in reported:
                        reported.add(key)
                        violations.append(Violation(
                            "metrics", path, node.lineno, key,
                            f"event kind {kind!r} is not registered in "
                            f"events.EVENT_KINDS (register it there AND in "
                            f"the COMPONENTS.md events table)",
                        ))
            if hot and meth in _METRIC_METHODS and recv is not None:
                key = make_key("metrics", path, f"hot-call.{recv}.{meth}")
                if key not in reported:
                    reported.add(key)
                    violations.append(Violation(
                        "metrics", path, node.lineno, key,
                        f"hot-path module {module} calls {recv}.{meth}(): "
                        f"metric materialization belongs in telemetry.py "
                        f"collectors, not on the hot path",
                    ))
            if meth in METRIC_CTORS and recv is None and node.args:
                name = const_str(node.args[0])
                if name is None:
                    continue
                if not NAME_RE.match(name):
                    violations.append(Violation(
                        "metrics", path, node.lineno,
                        make_key("metrics", path, f"name.{name}"),
                        f"metric name {name!r} does not match "
                        f"ray_tpu_[a-z0-9_]+",
                    ))
                elif doc_text is not None and name not in doc_text:
                    violations.append(Violation(
                        "metrics", path, node.lineno,
                        make_key("metrics", path, f"undocumented.{name}"),
                        f"metric {name!r} is not listed in the COMPONENTS.md "
                        f"Observability table",
                    ))
    return violations
