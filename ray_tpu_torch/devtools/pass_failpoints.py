"""Failpoint discipline.

  F1 bad-name       a failpoint name not matching ``[a-z0-9_.]+``
  F2 undocumented   a failpoint name (or dynamic-name prefix) used in code
                    that is missing from the COMPONENTS.md "Robustness"
                    failpoint table — the doc is the chaos-schedule contract:
                    a name you cannot look up is a name you cannot arm

Checked call sites: ``failpoints.fire / maybe_crash / inject_send /
inject_recv / inject_handle_send`` (and their bare-imported forms) with a
first argument that is
either a string literal or a ``"prefix." + expr`` concatenation. For the
concatenated form the documented table must contain the literal prefix (the
doc spells the family as e.g. ``sched.cmd.<method>``). Non-constant names
(internal forwarding inside failpoints.py itself) are skipped — the public
hook sites all use literals by convention.
"""

from __future__ import annotations

import ast
import os
import re
from typing import List, Optional, Set

from ray_tpu_torch.devtools.astutil import (
    Package, Violation, call_name, const_str, make_key,
)

FIRE_FUNCS = {"fire", "maybe_crash", "inject_send", "inject_recv",
              "inject_handle_send"}
NAME_RE = re.compile(r"^[a-z0-9_.]+$")


def _doc_text(doc_path: Optional[str]) -> Optional[str]:
    if doc_path and os.path.exists(doc_path):
        with open(doc_path, "r", encoding="utf-8") as fh:
            return fh.read()
    return None


def _name_of(arg: ast.AST):
    """(name, is_prefix) for a literal or a ``"lit." + expr`` concat; (None,
    False) when the name cannot be resolved statically."""
    s = const_str(arg)
    if s is not None:
        return s, False
    if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Add):
        left = const_str(arg.left)
        if left is not None:
            return left, True
    return None, False


def run(pkg: Package, doc_text: Optional[str] = None,
        doc_path: Optional[str] = None) -> List[Violation]:
    violations: List[Violation] = []
    if doc_text is None:
        doc_text = _doc_text(doc_path)
    reported: Set[str] = set()
    for module, tree in pkg.modules.items():
        path = pkg.paths[module]
        if module.endswith("failpoints"):
            continue  # the registry's internal forwarding, not a hook site
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            recv, meth = call_name(node)
            if meth not in FIRE_FUNCS:
                continue
            if recv is not None and not recv.endswith("failpoints"):
                continue
            name, is_prefix = _name_of(node.args[0])
            if name is None:
                continue
            bare = name.rstrip(".")
            if not NAME_RE.match(bare):
                key = make_key("failpoints", path, f"name.{name}")
                if key not in reported:
                    reported.add(key)
                    violations.append(Violation(
                        "failpoints", path, node.lineno, key,
                        f"failpoint name {name!r} does not match "
                        f"[a-z0-9_.]+",
                    ))
                continue
            if doc_text is not None and name not in doc_text:
                key = make_key("failpoints", path, f"undocumented.{name}")
                if key not in reported:
                    reported.add(key)
                    what = "prefix" if is_prefix else "name"
                    violations.append(Violation(
                        "failpoints", path, node.lineno, key,
                        f"failpoint {what} {name!r} is not listed in the "
                        f"COMPONENTS.md Robustness failpoint table",
                    ))
    return violations
