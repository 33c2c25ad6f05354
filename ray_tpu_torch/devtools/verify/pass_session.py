"""Session-machine pass: check the stateful protocol rules that per-site
arity checks (rt-lint `protocol`) cannot see.

Reads protocol.SESSION_SPEC + MESSAGE_GRAMMAR as literals straight from the
AST (never imports the runtime) and checks:

  S1 spec-tag-unknown   a pair/stream tag in SESSION_SPEC that MESSAGE_GRAMMAR
                        does not define (spec drift)
  S2 pair-direction     a reply whose wire direction is not the reverse of
                        its request's (token pairing across mismatched
                        connections can never work)
  S3 role-violation     a sender site in module M emitting a tag whose
                        grammar direction names a role M does not speak
                        (e.g. worker code sending a head->worker tag)
  S4 module-unmapped    a module with sender sites but no module_roles entry
                        (new protocol speakers must declare their role)
  S5 stream-coverage    a grammar tag that shares a stream's tag prefix
                        ("transfer_") but is not part of the stream spec —
                        a streaming frame outside the machine is unmonitored
  S6 reply-unread       a pair whose reply tag has no required reader: the
                        token would be sent into a void

The "dir" field of MESSAGE_GRAMMAR is thereby ENFORCED, not documentation:
its sender side ("worker" of "worker->head"; "worker+driver" splits on "+";
"any"/"handshake" always allowed) must cover every real sender site.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ray_tpu_torch.devtools.astutil import Package, Violation, make_key
from ray_tpu_torch.devtools.pass_protocol import (
    DEFAULT_SENDER_MODULES, _collect_senders, _grammar_from_source,
)


def _literal_from_source(pkg: Package, names) -> Dict[str, object]:
    """ast.literal_eval module-level assignments out of protocol.py."""
    tree = pkg.module_of("ray_tpu_torch._private.protocol") or pkg.module_of("protocol.py")
    out: Dict[str, object] = {}
    if tree is None:
        return out
    for node in ast.walk(tree):
        targets = ()
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = (node.target,), node.value
        for tgt in targets:
            if isinstance(tgt, ast.Name) and tgt.id in names:
                try:
                    out[tgt.id] = ast.literal_eval(value)
                except ValueError:
                    pass
    return out


def sender_roles(direction: str) -> Set[str]:
    """The role set allowed to SEND a tag with this grammar direction."""
    if direction in ("handshake", "any"):
        return {"any"}
    src = direction.split("->", 1)[0]
    return set(src.split("+"))


def run(pkg: Package, grammar: Optional[dict] = None,
        spec: Optional[dict] = None,
        sender_modules=DEFAULT_SENDER_MODULES) -> List[Violation]:
    violations: List[Violation] = []
    if grammar is None:
        grammar, _ = _grammar_from_source(pkg)
    if spec is None:
        spec = _literal_from_source(pkg, ("SESSION_SPEC",)).get("SESSION_SPEC")
    if not grammar:
        return []  # pass_protocol already reports the missing grammar
    if not isinstance(spec, dict):
        return [Violation(
            "session", "protocol.py", 0,
            make_key("session", "protocol.py", "missing-spec"),
            "SESSION_SPEC not found / not a literal in protocol.py",
        )]

    pairs = spec.get("pairs", {})
    streams = spec.get("streams", {})
    module_roles = spec.get("module_roles", {})

    # S1 + S2 + S6: pair coherence.
    for req_tag, pair in sorted(pairs.items()):
        reply_tag = pair.get("reply")
        for tag in (req_tag, reply_tag):
            if tag not in grammar:
                violations.append(Violation(
                    "session", "protocol.py", 0,
                    make_key("session", "protocol.py", f"tag={tag}", "spec-unknown"),
                    f"SESSION_SPEC pair {req_tag!r}->{reply_tag!r} names tag "
                    f"{tag!r} which is not in MESSAGE_GRAMMAR",
                ))
        if req_tag not in grammar or reply_tag not in grammar:
            continue
        req_dir = grammar[req_tag].get("dir", "any")
        rep_dir = grammar[reply_tag].get("dir", "any")
        if not _direction_reverses(req_dir, rep_dir):
            violations.append(Violation(
                "session", "protocol.py", 0,
                make_key("session", "protocol.py", f"pair={req_tag}", "direction"),
                f"pair {req_tag!r} ({req_dir}) -> {reply_tag!r} ({rep_dir}): "
                f"reply direction does not reverse the request's",
            ))
        if not grammar[reply_tag].get("readers"):
            violations.append(Violation(
                "session", "protocol.py", 0,
                make_key("session", "protocol.py", f"pair={req_tag}", "reply-unread"),
                f"pair {req_tag!r}: reply tag {reply_tag!r} has no required "
                f"reader in MESSAGE_GRAMMAR",
            ))

    # S1 + S5: stream coherence and coverage.
    for name, st in sorted(streams.items()):
        tags = [st.get("open")] + list(st.get("data", ())) + list(st.get("close", ()))
        for tag in tags:
            if tag not in grammar:
                violations.append(Violation(
                    "session", "protocol.py", 0,
                    make_key("session", "protocol.py", f"tag={tag}", "spec-unknown"),
                    f"SESSION_SPEC stream {name!r} names tag {tag!r} which is "
                    f"not in MESSAGE_GRAMMAR",
                ))
        prefix = f"{name}_"
        for tag in sorted(grammar):
            if tag.startswith(prefix) and tag not in tags:
                violations.append(Violation(
                    "session", "protocol.py", 0,
                    make_key("session", "protocol.py", f"tag={tag}", "stream-coverage"),
                    f"grammar tag {tag!r} matches stream {name!r}'s prefix but "
                    f"is not part of its SESSION_SPEC sequence",
                ))

    # S3 + S4: role conformance of every sender site.
    senders = _collect_senders(pkg, sender_modules)
    unmapped: Set[str] = set()
    import os

    for tag, _arity, path, line, qual in senders:
        base = os.path.basename(path)
        roles = module_roles.get(base)
        if roles is None:
            if base not in unmapped:
                unmapped.add(base)
                violations.append(Violation(
                    "session", path, line,
                    make_key("session", path, "module-unmapped"),
                    f"{base} has wire sender sites but no SESSION_SPEC "
                    f"module_roles entry",
                ))
            continue
        spec_entry = grammar.get(tag)
        if spec_entry is None:
            continue  # pass_protocol reports unknown tags
        allowed = sender_roles(spec_entry.get("dir", "any"))
        if "any" in allowed or "any" in roles:
            continue
        if not allowed.intersection(roles):
            violations.append(Violation(
                "session", path, line,
                make_key("session", path, qual, f"tag={tag}", "role"),
                f"{qual} ({base}: {'/'.join(roles)}) sends {tag!r}, which "
                f"only {'/'.join(sorted(allowed))} may speak "
                f"(dir {spec_entry.get('dir')!r})",
            ))
    return violations


def _direction_reverses(req_dir: str, rep_dir: str) -> bool:
    """True when the reply flows opposite to the request. "any" on either
    side of either direction matches everything on that side."""
    if req_dir in ("handshake", "any") or rep_dir in ("handshake", "any"):
        return True
    if "->" not in req_dir or "->" not in rep_dir:
        return False
    req_src, req_dst = req_dir.split("->", 1)
    rep_src, rep_dst = rep_dir.split("->", 1)

    def _m(a: str, b: str) -> bool:
        sa, sb = set(a.split("+")), set(b.split("+"))
        return "any" in sa or "any" in sb or bool(sa & sb)

    return _m(req_src, rep_dst) and _m(req_dst, rep_src)
