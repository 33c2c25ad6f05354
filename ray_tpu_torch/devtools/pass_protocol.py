"""Protocol-conformance pass: cross-check every control-plane sender site and
reader dispatch loop against protocol.MESSAGE_GRAMMAR.

Senders: calls whose callee name is one of SENDER_METHODS and whose message
argument is a tuple literal with a string tag head — including dynamically
extended tuples like ``("done",) + payload`` (tag registers, arity unchecked)
— plus handshake frames written as ``serialization.dumps((<tuple>))`` and
frames cut by ``serialization.frames(<msg>)`` (the coalescing sender's
``frames(m if one else ("batch", msgs))``: each branch of a conditional
message counts).

Readers: the dispatch loops named in protocol.DISPATCHERS. Within each, the
pass collects tags from comparisons against a subscript-0 binding (``kind =
msg[0]; kind == "exec"`` or ``msg[0] == "batch"``), including `in`-tuple
membership tests.

Checks:
  P1 unknown-tag         sender uses a tag absent from the grammar
  P2 arity-mismatch      literal tuple length outside the grammar's range
  P3 unhandled-tag       a grammar tag a required dispatcher does not handle
  P4 phantom-tag         a dispatcher handles a tag the grammar doesn't know
  P5 never-sent          a grammar tag with no sender site anywhere
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.astutil import (
    Package, Violation, ancestors, call_name, const_str, dotted, make_key,
)

# Methods through which control messages leave a process. `_send_to` and
# `_send` take the message as the LAST positional arg; the rest take it
# first. `buffer`/`send_async` are the BatchedSender enqueues.
SENDER_METHODS = {
    "send": 0, "send_async": 0, "buffer": 0, "_send": -1, "_send_to": -1,
}

# Modules scanned for sender sites (control-plane only: elsewhere `.send()`
# means sockets/generators, not wire messages).
DEFAULT_SENDER_MODULES = (
    "ray_tpu_torch._private.scheduler",
    "ray_tpu_torch._private.worker",
    "ray_tpu_torch._private.worker_main",
    "ray_tpu_torch._private.node_daemon",
    "ray_tpu_torch._private.batching",
    "ray_tpu_torch._private.head",
    "ray_tpu_torch._private.worker_entry",
    "ray_tpu_torch._private.object_transfer",
)


def _grammar_from_source(pkg: Package) -> Tuple[Optional[dict], Optional[dict]]:
    """ast.literal_eval MESSAGE_GRAMMAR / DISPATCHERS out of protocol.py's
    AST — no runtime import."""
    tree = pkg.module_of("ray_tpu_torch._private.protocol") or pkg.module_of("protocol.py")
    if tree is None:
        return None, None
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id in ("MESSAGE_GRAMMAR", "DISPATCHERS"):
                    try:
                        out[tgt.id] = ast.literal_eval(node.value)
                    except ValueError:
                        pass
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            tgt = node.target
            if isinstance(tgt, ast.Name) and tgt.id in ("MESSAGE_GRAMMAR", "DISPATCHERS"):
                try:
                    out[tgt.id] = ast.literal_eval(node.value)
                except ValueError:
                    pass
    return out.get("MESSAGE_GRAMMAR"), out.get("DISPATCHERS")


def _message_arg(call: ast.Call, recv: Optional[str], meth: str) -> Optional[ast.AST]:
    idx = SENDER_METHODS[meth]
    if not call.args:
        return None
    if meth in ("send", "send_async", "buffer"):
        # Exclude non-wire senders: socket.send(bytes), generator.send —
        # those never pass a tuple literal, which the caller filters on.
        return call.args[0]
    return call.args[idx]


def _tuple_tag_arity(node: ast.AST) -> Optional[Tuple[str, Optional[int]]]:
    """(tag, arity_or_None) for a message expression: a tuple literal with a
    string head, or ``(<tuple>) + rest`` (arity unknown)."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        inner = _tuple_tag_arity(node.left)
        if inner is not None:
            return inner[0], None
        return None
    if not isinstance(node, ast.Tuple) or not node.elts:
        return None
    tag = const_str(node.elts[0])
    if tag is None:
        return None
    if any(isinstance(e, ast.Starred) for e in node.elts):
        return tag, None
    return tag, len(node.elts)


def _collect_senders(pkg: Package, sender_modules) -> List[Tuple[str, Optional[int], str, int, str]]:
    """[(tag, arity, path, line, enclosing_qualname)] over all sender sites."""
    out = []
    for module in sender_modules:
        tree = pkg.module_of(module)
        if tree is None:
            continue
        path = pkg.paths.get(module, module)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            recv, meth = call_name(node)
            msg_node = None
            if meth in SENDER_METHODS:
                msg_node = _message_arg(node, recv, meth)
            elif meth in ("dumps", "frames") and recv is not None and \
                    recv.split(".")[-1] in ("serialization", "_ser"):
                msg_node = node.args[0] if node.args else None
            if msg_node is None:
                continue
            branches = [msg_node]
            while branches and isinstance(branches[-1], ast.IfExp):
                cond = branches.pop()
                branches += [cond.body, cond.orelse]
            for branch in branches:
                got = _tuple_tag_arity(branch)
                if got is not None:
                    out.append((got[0], got[1], path, node.lineno, _enclosing_qualname(node)))
    return out


def _enclosing_qualname(node: ast.AST) -> str:
    fn = None
    cls = None
    for anc in ancestors(node):
        if fn is None and isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = anc.name
        if cls is None and isinstance(anc, ast.ClassDef):
            cls = anc.name
    if cls and fn:
        return f"{cls}.{fn}"
    return fn or "<module>"


def _handled_tags(fn_node: ast.AST) -> Set[str]:
    """Tags a dispatch function routes on: string comparisons against names
    bound from a ``<x>[0]`` subscript (or direct ``msg[0] == ...``)."""
    sub0_names: Set[str] = set()
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Assign) and _is_sub0(node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    sub0_names.add(tgt.id)
    tags: Set[str] = set()
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Compare):
            continue
        left_is_kind = (
            _is_sub0(node.left)
            or (isinstance(node.left, ast.Name) and node.left.id in sub0_names)
        )
        if not left_is_kind:
            continue
        for comp in node.comparators:
            s = const_str(comp)
            if s is not None:
                tags.add(s)
            elif isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                for e in comp.elts:
                    es = const_str(e)
                    if es is not None:
                        tags.add(es)
    return tags


def _is_sub0(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Subscript)
        and isinstance(node.slice, ast.Constant)
        and node.slice.value == 0
    )


def run(pkg: Package, grammar: Optional[dict] = None,
        dispatchers: Optional[Dict[str, str]] = None,
        sender_modules=DEFAULT_SENDER_MODULES) -> List[Violation]:
    violations: List[Violation] = []
    if grammar is None or dispatchers is None:
        g, d = _grammar_from_source(pkg)
        grammar = grammar if grammar is not None else g
        dispatchers = dispatchers if dispatchers is not None else d
    if not grammar:
        return [Violation("protocol", "<grammar>", 0,
                          make_key("protocol", "protocol.py", "missing-grammar"),
                          "MESSAGE_GRAMMAR not found / not a literal in protocol.py")]
    dispatchers = dispatchers or {}

    senders = _collect_senders(pkg, sender_modules)
    sent_tags: Set[str] = set()
    for tag, arity, path, line, qual in senders:
        spec = grammar.get(tag)
        if spec is None:
            violations.append(Violation(
                "protocol", path, line,
                make_key("protocol", path, qual, f"tag={tag}", "unknown"),
                f"{qual} sends tag {tag!r} which is not in MESSAGE_GRAMMAR",
            ))
            continue
        sent_tags.add(tag)
        lo, hi = spec["arity"]
        if arity is not None and not (lo <= arity <= hi):
            violations.append(Violation(
                "protocol", path, line,
                make_key("protocol", path, qual, f"tag={tag}", "arity"),
                f"{qual} sends {tag!r} with arity {arity}, grammar says "
                f"[{lo}, {hi}]",
            ))

    # Reader coverage.
    handled_by: Dict[str, Set[str]] = {}
    for disp_key, ref in dispatchers.items():
        module, _, qual = ref.partition(":")
        info = pkg.lookup(f"{module}:{qual}")
        if info is None:
            # Fixture packages use bare module names; fall back to matching
            # on the qualname alone.
            cands = [f for f in pkg.functions.values() if f.qualname == qual]
            info = cands[0] if len(cands) == 1 else None
        if info is None:
            violations.append(Violation(
                "protocol", module, 0,
                make_key("protocol", module, disp_key, "missing-dispatcher"),
                f"dispatcher {disp_key} -> {ref} not found in the tree",
            ))
            continue
        handled_by[disp_key] = _handled_tags(info.node)
        # P4: tags handled that the grammar doesn't know.
        for tag in sorted(handled_by[disp_key] - set(grammar)):
            violations.append(Violation(
                "protocol", info.path, info.node.lineno,
                make_key("protocol", info.path, info.qualname, f"tag={tag}", "phantom"),
                f"{info.qualname} handles tag {tag!r} which is not in "
                f"MESSAGE_GRAMMAR (dead branch or missing registry entry)",
            ))

    for tag, spec in sorted(grammar.items()):
        for disp_key in spec.get("readers", ()):
            if disp_key not in handled_by:
                continue  # dispatcher itself already reported missing
            if tag not in handled_by[disp_key]:
                ref = dispatchers.get(disp_key, disp_key)
                violations.append(Violation(
                    "protocol", ref.partition(":")[0], 0,
                    make_key("protocol", ref.partition(":")[0], disp_key, f"tag={tag}", "unhandled"),
                    f"grammar tag {tag!r} is not handled by required "
                    f"dispatcher {disp_key} ({ref})",
                ))
        # P5: never sent anywhere.
        if tag not in sent_tags:
            violations.append(Violation(
                "protocol", "protocol.py", 0,
                make_key("protocol", "protocol.py", f"tag={tag}", "never-sent"),
                f"grammar tag {tag!r} has no sender site in the tree "
                f"(docstring drift or dead protocol surface)",
            ))
    return violations
