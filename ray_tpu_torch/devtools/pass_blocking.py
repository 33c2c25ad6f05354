"""Event-loop blocking-call detection.

Builds a call graph rooted at the scheduler's loop-thread entry points
(`Scheduler._loop`, every `_cmd_*`/`_req_*` handler — the loop dispatches to
them via getattr, which no AST resolver can follow — and anything annotated
`@loop_thread_only`) and flags reachable blocking primitives:

  time.sleep / select / socket connects        (unconditional stalls)
  .recv / .recv_bytes / .accept                (unless poll()-guarded)
  .result() / .wait() / .join() / .acquire()   (when un-timed)
  zero-arg .get()                              (queue waits; dict.get has args)
  open() / shutil.copyfile / shutil.rmtree     (data-plane file I/O — spills,
                                                log files; metadata syscalls
                                                like os.unlink stay out of
                                                scope deliberately)
  subprocess.Popen / run / check_output        (process spawn)
  ray_tpu_torch.get / ray_tpu_torch.wait                   (re-entrant blocking API)

Edges resolved: self.method(), local/imported package functions, and —
conservatively — attribute calls whose bare name is defined exactly once in
the scanned modules (skipping common collision-prone names). Unresolvable
calls are ignored; this pass under-approximates reachability by design and
exists to catch the obvious regressions cheaply.

A violation's key is (enclosing function, primitive), line-number free; the
message carries one sample root chain for debugging.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.astutil import (
    FuncInfo, Package, Violation, ancestors, call_name, has_timeout_arg,
    imported_names, make_key, walk_body,
)

# Modules whose functions participate in the call graph (what the scheduler
# loop can actually reach; scanning all of rllib would only add name-collision
# noise).
DEFAULT_GRAPH_MODULES = (
    "ray_tpu_torch._private.scheduler",
    "ray_tpu_torch._private.batching",
    "ray_tpu_torch._private.telemetry",
    "ray_tpu_torch._private.gcs",
    "ray_tpu_torch._private.object_store",
    "ray_tpu_torch._private.serialization",
    "ray_tpu_torch._private.memory_monitor",
    "ray_tpu_torch._private.runtime_env",
    "ray_tpu_torch._private.config",
    "ray_tpu_torch._private.ids",
    "ray_tpu_torch._private.protocol",
    "ray_tpu_torch._private.concurrency",
    "ray_tpu_torch.util.metrics",
)

# Bare method names never resolved through the unique-name fallback: too
# generic, collisions guaranteed.
_SKIP_RESOLVE = {
    "get", "put", "pop", "append", "add", "remove", "send", "close", "items",
    "values", "keys", "update", "clear", "copy", "extend", "set", "start",
    "stop", "run", "join", "wait", "result", "acquire", "release", "submit",
    "hex", "binary", "encode", "decode", "read", "write", "flush", "push",
}

_TIMED_WAIT_METHODS = {"result", "wait", "join", "acquire"}
_RECV_METHODS = {"recv", "recv_bytes", "recv_bytes_into", "accept"}
_FILE_IO_FUNCS = {"open"}
_FILE_IO_ATTRS = {("shutil", "copyfile"), ("shutil", "rmtree")}
_SUBPROCESS_ATTRS = {"Popen", "run", "call", "check_call", "check_output", "communicate"}


def _poll_guarded(node: ast.AST) -> bool:
    """True if an ancestor While/If test polls readiness — the standard
    `while conn.poll(): conn.recv_bytes()` drain shape."""
    for anc in ancestors(node):
        if isinstance(anc, (ast.While, ast.If)):
            for sub in ast.walk(anc.test):
                if isinstance(sub, ast.Call) and call_name(sub)[1] == "poll":
                    return True
    return False


def _blocking_primitive(node: ast.Call, imports: Dict[str, str]) -> Optional[str]:
    """Name of the blocking primitive this call is, or None."""
    recv, meth = call_name(node)
    base = recv.split(".")[-1] if recv else None
    # time.sleep / imported sleep
    if meth == "sleep" and (base == "time" or imports.get("sleep", "").endswith("time.sleep")):
        return "time.sleep"
    if recv == "select" and meth == "select":
        return "select.select"
    if meth == "create_connection" or (meth == "Client" and not recv) or \
            (base == "socket" and meth == "connect"):
        return f"{meth} (connect)"
    if meth in _RECV_METHODS:
        if _poll_guarded(node):
            return None
        return f".{meth}()"
    if meth in _TIMED_WAIT_METHODS:
        if meth == "join" and node.args:
            return None  # str.join / os.path.join
        # acquire(blocking=False) is a try-lock; blocking=True (or any other
        # value) still needs a timeout to count as bounded.
        if meth == "acquire" and any(
            kw.arg == "blocking"
            and isinstance(kw.value, ast.Constant) and kw.value.value is False
            for kw in node.keywords
        ):
            return None
        if has_timeout_arg(node):
            return None
        return f".{meth}() [no timeout]"
    if meth == "get" and not node.args and not node.keywords and recv is not None:
        return ".get() [queue wait]"
    if meth in _FILE_IO_FUNCS and recv is None:
        return "open (file I/O)"
    if (base, meth) in _FILE_IO_ATTRS:
        return f"{base}.{meth} (file I/O)"
    if base == "subprocess" and meth in _SUBPROCESS_ATTRS:
        return f"subprocess.{meth}"
    if meth == "communicate":
        return ".communicate()"
    if base == "ray_tpu_torch" and meth in ("get", "wait"):
        return f"ray_tpu_torch.{meth}"
    return None


class _Graph:
    def __init__(self, pkg: Package, modules) -> None:
        self.pkg = pkg
        self.infos: List[FuncInfo] = [
            f for f in pkg.functions.values() if f.module in modules
        ]
        self.by_key = {f.key: f for f in self.infos}
        by_name: Dict[str, List[FuncInfo]] = {}
        for f in self.infos:
            by_name.setdefault(f.name, []).append(f)
        self.by_name = by_name
        self.imports: Dict[str, Dict[str, str]] = {
            m: imported_names(tree)
            for m, tree in pkg.modules.items() if m in modules
        }

    def edges(self, info: FuncInfo) -> Set[str]:
        out: Set[str] = set()
        imports = self.imports.get(info.module, {})
        for node in walk_body(info.node):
            if not isinstance(node, ast.Call):
                continue
            recv, meth = call_name(node)
            if not meth:
                continue
            if recv == "self" and info.cls:
                key = f"{info.module}:{info.cls}.{meth}"
                if key in self.by_key:
                    out.add(key)
                    continue
            if recv is None:
                # Local or imported function.
                key = f"{info.module}:{meth}"
                if key in self.by_key:
                    out.add(key)
                    continue
                src = imports.get(meth)
                if src:
                    mod, _, name = src.rpartition(".")
                    key = f"{mod}:{name}"
                    if key in self.by_key:
                        out.add(key)
                        continue
            if meth in _SKIP_RESOLVE:
                continue
            cands = self.by_name.get(meth, ())
            if len(cands) == 1:
                out.add(cands[0].key)
        return out


def run(pkg: Package, roots: Optional[List[str]] = None,
        graph_modules=DEFAULT_GRAPH_MODULES) -> List[Violation]:
    graph = _Graph(pkg, set(graph_modules))
    if roots is None:
        roots = []
        for f in graph.infos:
            if "loop_thread_only" in f.decorators:
                roots.append(f.key)
            elif f.cls == "Scheduler" and (
                f.name == "_loop" or f.name.startswith("_cmd_")
                or f.name.startswith("_req_")
            ):
                roots.append(f.key)
    # BFS, remembering one sample path to each function.
    came_from: Dict[str, Optional[str]] = {}
    queue: List[str] = []
    for r in roots:
        if r in graph.by_key and r not in came_from:
            came_from[r] = None
            queue.append(r)
    while queue:
        cur = queue.pop()
        for nxt in graph.edges(graph.by_key[cur]):
            if nxt not in came_from:
                came_from[nxt] = cur
                queue.append(nxt)

    violations: List[Violation] = []
    seen_keys: Set[str] = set()
    for key in came_from:
        info = graph.by_key[key]
        imports = graph.imports.get(info.module, {})
        for node in walk_body(info.node):
            if not isinstance(node, ast.Call):
                continue
            prim = _blocking_primitive(node, imports)
            if prim is None:
                continue
            vkey = make_key("blocking", info.path, info.qualname,
                            prim.split(" ")[0].strip(".()"))
            if vkey in seen_keys:
                continue
            seen_keys.add(vkey)
            chain = _chain(came_from, key)
            violations.append(Violation(
                "blocking", info.path, node.lineno, vkey,
                f"{info.qualname} calls blocking primitive {prim} on the "
                f"scheduler loop thread (reachable via {' -> '.join(chain)})",
            ))
    return violations


def _chain(came_from: Dict[str, Optional[str]], key: str) -> List[str]:
    out = []
    cur: Optional[str] = key
    while cur is not None:
        out.append(cur.split(":", 1)[1])
        cur = came_from.get(cur)
    return list(reversed(out))
