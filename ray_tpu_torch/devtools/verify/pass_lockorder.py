"""Lock-order pass: acquisition-graph cycle detection over the control
plane's locks.

PRs 6-7 put four independently-locked components on the same hot paths
(PullManager, PushManager, OwnershipTable, BatchedSender — plus the
scheduler's send/wake locks and the module-level locate registry). A
deadlock needs two threads taking two of those locks in opposite orders;
no per-site lint can see it, but the ACQUISITION GRAPH can: every
`with <lock>:` body (and every `@lock_guarded` method, whose whole body
runs under its named lock) contributes held->acquired edges, calls inside
a held region contribute edges to every lock the callee may transitively
acquire, and any cycle in the resulting graph is a potential deadlock.

Lock identity is static and class-scoped (`PullManager._lock`,
`BatchedSender._lock`, `object_transfer._locate_lock`): two instances of
one class share a node, so a self-edge means "holds an instance's lock
while taking the same lock of a (possibly different) instance" — the
same-instance case is an instant deadlock with plain Locks, the
cross-instance case is an ordering hazard; both deserve a look, and a
justified allowlist entry if deliberate.

Resolution (same under-approximation contract as the blocking pass):
`self.X` locks bind to the enclosing class; `alias.X` follows one local
`alias = self.attr` hop through the class's attr-type map (built from
`self.attr = ClassName(...)` assignments and annotated __init__ params);
module-level `with _lock:` binds to the module; anything else becomes an
`?.X` node (kept distinct by attribute name, never merged with a resolved
class). Calls resolve like the blocking pass: self-methods, local/imported
functions, then unique bare names.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.astutil import (
    FuncInfo, Package, Violation, call_name, dotted, imported_names, make_key,
    walk_body,
)

DEFAULT_GRAPH_MODULES = (
    "ray_tpu_torch._private.scheduler",
    "ray_tpu_torch._private.batching",
    "ray_tpu_torch._private.object_transfer",
    "ray_tpu_torch._private.ownership",
    "ray_tpu_torch._private.object_store",
    "ray_tpu_torch._private.worker",
    "ray_tpu_torch._private.worker_main",
    "ray_tpu_torch._private.node_daemon",
    "ray_tpu_torch._private.gcs",
    "ray_tpu_torch._private.telemetry",
    "ray_tpu_torch._private.session_monitor",
    "ray_tpu_torch._private.failpoints",
    "ray_tpu_torch._private.tracing_runtime",
    "ray_tpu_torch.util.metrics",
)

# Bare names too generic for unique-name call resolution.
_SKIP_RESOLVE = {
    "get", "put", "pop", "append", "add", "remove", "send", "close", "items",
    "values", "keys", "update", "clear", "copy", "extend", "set", "start",
    "stop", "run", "join", "wait", "result", "acquire", "release", "submit",
    "flush", "note", "read", "write",
}


def _is_lockish(name: str) -> bool:
    return "lock" in name.lower()


class _Analysis:
    def __init__(self, pkg: Package, modules: Set[str]) -> None:
        self.pkg = pkg
        self.infos = [f for f in pkg.functions.values() if f.module in modules]
        self.by_key = {f.key: f for f in self.infos}
        by_name: Dict[str, List[FuncInfo]] = {}
        for f in self.infos:
            by_name.setdefault(f.name, []).append(f)
        self.by_name = by_name
        self.imports = {
            m: imported_names(tree)
            for m, tree in pkg.modules.items() if m in modules
        }
        self.class_names = {f.cls for f in self.infos if f.cls}
        self.module_locks: Dict[str, Set[str]] = {}
        for m in modules:
            tree = pkg.modules.get(m)
            if tree is None:
                continue
            locks: Set[str] = set()
            for node in tree.body:
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                    _, meth = call_name(node.value)
                    if meth in ("Lock", "RLock", "Condition"):
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Name):
                                locks.add(tgt.id)
            self.module_locks[m] = locks
        # (module, class) -> {attr: ClassName} from `self.attr = ClassName(...)`
        # and annotated __init__ params assigned to self.attr.
        self.attr_types: Dict[Tuple[str, str], Dict[str, str]] = {}
        for f in self.infos:
            if not f.cls:
                continue
            amap = self.attr_types.setdefault((f.module, f.cls), {})
            ann: Dict[str, str] = {}
            args = getattr(f.node, "args", None)
            if args is not None:
                for a in list(args.args) + list(args.kwonlyargs):
                    t = a.annotation
                    if isinstance(t, ast.Name):
                        ann[a.arg] = t.id
                    elif isinstance(t, ast.Constant) and isinstance(t.value, str):
                        ann[a.arg] = t.value.strip('"')
                    elif isinstance(t, ast.Attribute):
                        ann[a.arg] = t.attr
            for node in walk_body(f.node):
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        v = node.value
                        if isinstance(v, ast.Call):
                            _, ctor = call_name(v)
                            if ctor in self.class_names:
                                amap.setdefault(tgt.attr, ctor)
                        elif isinstance(v, ast.Name) and v.id in ann:
                            amap.setdefault(tgt.attr, ann[v.id])

    # ------------------------------------------------------------ lock ids
    def lock_id(self, expr: ast.AST, info: FuncInfo,
                local_aliases: Dict[str, str]) -> Optional[str]:
        d = dotted(expr)
        if d is None:
            return None
        parts = d.split(".")
        leaf = parts[-1]
        if not _is_lockish(leaf):
            return None
        if len(parts) == 1:
            if leaf in self.module_locks.get(info.module, ()):
                return f"{info.module.rsplit('.', 1)[-1]}.{leaf}"
            return f"?.{leaf}"
        owner = parts[0]
        if owner == "self" and info.cls:
            if len(parts) == 2:
                return f"{info.cls}.{leaf}"
            # self.attr._lock: resolve attr's class if known.
            t = self.attr_types.get((info.module, info.cls), {}).get(parts[1])
            return f"{t or '?' + parts[1]}.{leaf}"
        # alias.X where alias = self.attr earlier in this function.
        src_attr = local_aliases.get(owner)
        if src_attr is not None and info.cls:
            t = self.attr_types.get((info.module, info.cls), {}).get(src_attr)
            return f"{t or '?' + src_attr}.{leaf}"
        return f"?{owner}.{leaf}"

    def local_aliases(self, info: FuncInfo) -> Dict[str, str]:
        """name -> self-attr for `x = self.attr` assignments in the body."""
        out: Dict[str, str] = {}
        for node in walk_body(info.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                v = node.value
                if isinstance(v, ast.Attribute) and \
                        isinstance(v.value, ast.Name) and v.value.id == "self":
                    out[node.targets[0].id] = v.attr
        return out

    # ------------------------------------------------------- call resolution
    def callees(self, info: FuncInfo, node: ast.Call) -> List[FuncInfo]:
        recv, meth = call_name(node)
        if not meth:
            return []
        if recv == "self" and info.cls:
            got = self.by_key.get(f"{info.module}:{info.cls}.{meth}")
            return [got] if got else []
        if recv is None:
            got = self.by_key.get(f"{info.module}:{meth}")
            if got:
                return [got]
            src = self.imports.get(info.module, {}).get(meth)
            if src:
                mod, _, name = src.rpartition(".")
                got = self.by_key.get(f"{mod}:{name}")
                if got:
                    return [got]
        if meth in _SKIP_RESOLVE:
            return []
        cands = self.by_name.get(meth, ())
        return list(cands) if len(cands) == 1 else []

    # ----------------------------------------------------- per-function data
    def guard_locks(self, info: FuncInfo) -> Set[str]:
        """Locks this function requires held at ENTRY (@lock_guarded)."""
        out: Set[str] = set()
        for dec in info.node.decorator_list:
            if isinstance(dec, ast.Call):
                _, name = call_name(dec)
                if name == "lock_guarded" and dec.args:
                    arg = dec.args[0]
                    if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                            and info.cls:
                        out.add(f"{info.cls}.{arg.value}")
        return out

    def direct_acquisitions(self, info: FuncInfo) -> List[Tuple[str, ast.With]]:
        out: List[Tuple[str, ast.With]] = []
        aliases = self.local_aliases(info)
        for node in walk_body(info.node):
            if isinstance(node, ast.With):
                for item in node.items:
                    lid = self.lock_id(item.context_expr, info, aliases)
                    if lid is not None:
                        out.append((lid, node))
        return out


def _walk_no_defs(root: ast.AST):
    """Walk below `root` without descending into nested defs/lambdas."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _acq_fixpoint(an: _Analysis) -> Dict[str, Set[str]]:
    """key -> every lock the function may (transitively) acquire."""
    acq: Dict[str, Set[str]] = {}
    calls: Dict[str, Set[str]] = {}
    for f in an.infos:
        acq[f.key] = {lid for lid, _ in an.direct_acquisitions(f)}
        callee_keys: Set[str] = set()
        for node in walk_body(f.node):
            if isinstance(node, ast.Call):
                callee_keys.update(c.key for c in an.callees(f, node))
        calls[f.key] = callee_keys
    changed = True
    while changed:
        changed = False
        for key, callee_keys in calls.items():
            cur = acq[key]
            for ck in callee_keys:
                extra = acq.get(ck, ())
                for lid in extra:
                    if lid not in cur:
                        cur.add(lid)
                        changed = True
    return acq


def run(pkg: Package, graph_modules=DEFAULT_GRAPH_MODULES) -> List[Violation]:
    modules = {m for m in graph_modules if m in pkg.modules}
    # Fixture packages use bare module names: fall back to "everything".
    if not modules:
        modules = set(pkg.modules)
    an = _Analysis(pkg, modules)
    acq = _acq_fixpoint(an)

    # held -> acquired edges, with one sample site each.
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    def add_edge(held: str, taken: str, info: FuncInfo, line: int,
                 why: str) -> None:
        if held == taken:
            # Self-edge: report directly (cycle detection would hide which
            # site) — same-instance re-acquisition deadlocks a plain Lock.
            key = make_key("lockorder", info.path, info.qualname,
                           f"self-cycle={taken}")
            if key not in _self_seen:
                _self_seen[key] = Violation(
                    "lockorder", info.path, line, key,
                    f"{info.qualname} may acquire {taken} while already "
                    f"holding it ({why}) — deadlock if both are the same "
                    f"instance, ordering hazard otherwise",
                )
            return
        edges.setdefault((held, taken), (info.path, line, info.qualname))

    _self_seen: Dict[str, Violation] = {}

    for f in an.infos:
        held_at_entry = an.guard_locks(f)
        directs = an.direct_acquisitions(f)
        # Entry-held locks cover the whole body.
        for held in held_at_entry:
            for lid, wnode in directs:
                add_edge(held, lid, f, wnode.lineno, "@lock_guarded entry")
            for node in walk_body(f.node):
                if isinstance(node, ast.Call):
                    for callee in an.callees(f, node):
                        for lid in acq.get(callee.key, ()):
                            add_edge(held, lid, f, node.lineno,
                                     f"calls {callee.qualname}")
        # With-block regions. Nested defs/lambdas are excluded: code inside
        # them runs when CALLED (often on another thread, after the with
        # exits), not while this lock is held.
        aliases = an.local_aliases(f)
        for lid, wnode in directs:
            for inner in _walk_no_defs(wnode):
                if isinstance(inner, ast.With):
                    for item in inner.items:
                        ilid = an.lock_id(item.context_expr, f, aliases)
                        if ilid is not None:
                            add_edge(lid, ilid, f, inner.lineno, "nested with")
                elif isinstance(inner, ast.Call):
                    for callee in an.callees(f, inner):
                        for ilid in acq.get(callee.key, ()):
                            add_edge(lid, ilid, f, inner.lineno,
                                     f"calls {callee.qualname}")

    violations: List[Violation] = list(_self_seen.values())

    # Cycle detection over the edge graph (DFS with stack coloring).
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in graph}
    stack: List[str] = []
    cycles: List[List[str]] = []

    def dfs(n: str) -> None:
        color[n] = GREY
        stack.append(n)
        for nxt in sorted(graph[n]):
            if color[nxt] == GREY:
                cyc = stack[stack.index(nxt):] + [nxt]
                cycles.append(cyc)
            elif color[nxt] == WHITE:
                dfs(nxt)
        stack.pop()
        color[n] = BLACK

    for n in sorted(graph):
        if color[n] == WHITE:
            dfs(n)

    seen_cycles: Set[frozenset] = set()
    for cyc in cycles:
        ident = frozenset(cyc)
        if ident in seen_cycles:
            continue
        seen_cycles.add(ident)
        sites = []
        for a, b in zip(cyc, cyc[1:]):
            path, line, qual = edges[(a, b)]
            sites.append(f"{a}->{b} at {os.path.basename(path)}:{line} ({qual})")
        violations.append(Violation(
            "lockorder", "lock-graph", 0,
            make_key("lockorder", "lock-graph",
                     "cycle=" + ">".join(sorted(set(cyc)))),
            "lock-order cycle: " + "; ".join(sites),
        ))
    return violations
