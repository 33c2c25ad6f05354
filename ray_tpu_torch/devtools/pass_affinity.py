"""Thread-affinity race detection, anchored on the `_private/concurrency.py`
annotations.

  A1 any->loop call      an `@any_thread` function directly calls a
                         `@loop_thread_only` function (same-or-looser rule:
                         loop-only code may call anything; any-thread code
                         may only call any-thread / unannotated code)
  A2 unlocked shared     an instance attribute STORED (assign/augassign/
     state               subscript-store/delete) by both a loop-only method
                         and an any-thread method of the same class, where
                         either side's store is not under a `with self.<lock>`
                         block (attr names containing "lock") — and the
                         any-thread method is not `@lock_guarded`

Reads are deliberately out of scope (too many benign racy reads are part of
the design — e.g. BatchedSender's timer peeking at `_buf`); stores from both
affinities are where lost updates and torn state come from.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.astutil import (
    FuncInfo, Package, Violation, ancestors, call_name, make_key, walk_body,
)

LOOP = "loop_thread_only"
ANY = "any_thread"
LOCKED = "lock_guarded"


def _affinity(info: FuncInfo) -> Optional[str]:
    if LOOP in info.decorators:
        return LOOP
    if ANY in info.decorators:
        return ANY
    return None


def _under_self_lock(node: ast.AST) -> bool:
    """True if an ancestor `with` holds an attribute whose name mentions
    "lock" (self._lock, self._wake_lock, cls-level locks...)."""
    for anc in ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                for sub in ast.walk(item.context_expr):
                    if isinstance(sub, ast.Attribute) and "lock" in sub.attr.lower():
                        return True
                    if isinstance(sub, ast.Name) and "lock" in sub.id.lower():
                        return True
    return False


def _self_stores(info: FuncInfo) -> Dict[str, bool]:
    """attr -> all_stores_locked for attributes of `self` this function
    stores to."""
    out: Dict[str, bool] = {}

    def note(attr: str, locked: bool) -> None:
        out[attr] = out.get(attr, True) and locked

    # walk_body, not ast.walk: a nested closure runs when (and on whatever
    # thread) it is called, so its stores must not inherit this function's
    # affinity (e.g. _cmd_pull_object's _read_and_respond pull-read thread).
    for node in walk_body(info.node):
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = list(node.targets)
        for tgt in targets:
            attr = _self_attr_of_target(tgt)
            if attr is not None:
                note(attr, _under_self_lock(node))
    return out


def _self_attr_of_target(tgt: ast.AST) -> Optional[str]:
    # self.x = ... / self.x += ...
    if isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name) \
            and tgt.value.id == "self":
        return tgt.attr
    # self.x[k] = ... / del self.x[k]
    if isinstance(tgt, ast.Subscript):
        return _self_attr_of_target(tgt.value)
    # (a, self.x) = ...
    if isinstance(tgt, (ast.Tuple, ast.List)):
        for e in tgt.elts:
            got = _self_attr_of_target(e)
            if got is not None:
                return got
    return None


def run(pkg: Package, modules: Optional[Set[str]] = None) -> List[Violation]:
    infos = [
        f for f in pkg.functions.values()
        if modules is None or f.module in modules
    ]
    annotated = [f for f in infos if _affinity(f) is not None]
    violations: List[Violation] = []

    # A1: any_thread -> loop_thread_only direct calls (same class or module).
    loop_keys: Dict[Tuple[str, Optional[str], str], FuncInfo] = {
        (f.module, f.cls, f.name): f for f in annotated if _affinity(f) == LOOP
    }
    for f in annotated:
        if _affinity(f) != ANY:
            continue
        for node in walk_body(f.node):
            if not isinstance(node, ast.Call):
                continue
            recv, meth = call_name(node)
            target = None
            if recv == "self" and f.cls:
                target = loop_keys.get((f.module, f.cls, meth))
            elif recv is None:
                target = loop_keys.get((f.module, None, meth))
            if target is not None:
                violations.append(Violation(
                    "affinity", f.path, node.lineno,
                    make_key("affinity", f.path, f.qualname, f"calls={target.qualname}"),
                    f"@any_thread {f.qualname} calls @loop_thread_only "
                    f"{target.qualname} — off-thread callers would mutate "
                    f"loop-owned state",
                ))

    # A2: shared instance state stored from both affinities without locks.
    by_class: Dict[Tuple[str, str], List[FuncInfo]] = {}
    for f in annotated:
        if f.cls:
            by_class.setdefault((f.module, f.cls), []).append(f)
    for (module, cls), funcs in sorted(by_class.items()):
        stores: Dict[str, Dict[str, List[Tuple[FuncInfo, bool]]]] = {}
        for f in funcs:
            aff = _affinity(f)
            locked_ok = LOCKED in f.decorators
            for attr, all_locked in _self_stores(f).items():
                stores.setdefault(attr, {}).setdefault(aff, []).append(
                    (f, all_locked or locked_ok)
                )
        for attr, by_aff in sorted(stores.items()):
            if LOOP not in by_aff or ANY not in by_aff:
                continue
            offenders = [
                f for lst in by_aff.values() for (f, locked) in lst if not locked
            ]
            if not offenders:
                continue
            f0 = offenders[0]
            violations.append(Violation(
                "affinity", f0.path, f0.node.lineno,
                make_key("affinity", f0.path, f"{cls}.{attr}", "unlocked-shared"),
                f"{cls}.{attr} is stored by both @loop_thread_only and "
                f"@any_thread methods, and {', '.join(sorted(set(f.qualname for f in offenders)))} "
                f"store(s) it outside any self.<lock> block",
            ))
    return violations
