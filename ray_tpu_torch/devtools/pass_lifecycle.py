"""Lifecycle-machine pass: cross-check every state write/comparison site in
the covered modules against lifecycle.LIFECYCLE_SPEC (rt-state's static side).

The spec is a pure literal (the MESSAGE_GRAMMAR pattern): it is extracted
from ``_private/lifecycle.py``'s AST with ``ast.literal_eval`` — linting
never imports the runtime. A *site* is attributed to a machine three ways,
most-specific first:

 - the ``lifecycle.step("machine", old, new)`` call's literal machine arg;
 - the enclosing class, when it is one of the machine's ``classes``
   (dataclass defaults, ``self.<attr> = ...`` in ``__init__``);
 - the receiver name: ``(module, receiver, attr)`` against the machine's
   ``receivers`` (``rec.state``, ``wh.health``, ...).

Checks:
  L1 write-bypasses-step   attributed transition write not going through
                           lifecycle.step() (initial assignments exempt)
  L2 initial-mismatch      a machine class's default/__init__ assignment is
                           not the spec's initial state
  L3 unknown-state         step() targets a state (or names a machine) the
                           spec does not declare
  L4 unauthorized-module   step() driven from a module the spec does not
                           authorize for any edge into that target state;
                           also covers a step() whose receiver maps to a
                           DIFFERENT machine than its literal machine arg
  L5 unknown-state-compare comparison of an attributed receiver's state
                           against a name the spec does not declare
  L6 unreachable-state     a spec state no code ever writes or compares
                           (machines with a dynamic-target step() write are
                           exempt — their targets are not statically visible)
  L7 unattributed-write    a write to a covered attr in a covered module
                           that no machine claims (new machine or typo'd
                           receiver; allowlist with a justification if the
                           attr genuinely is not a lifecycle machine)
  L8 spec-incoherent       terminal state with outgoing edges, two machines
                           claiming one (class, attr) or (module, receiver,
                           attr), or a step() whose old-state arg is not the
                           written attribute itself
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.astutil import (
    Package, Violation, ancestors, call_name, const_str, dotted,
    imported_names, make_key,
)

_PASS = "lifecycle"


def _spec_from_source(pkg: Package) -> Optional[dict]:
    """ast.literal_eval LIFECYCLE_SPEC out of lifecycle.py's AST."""
    tree = pkg.module_of("ray_tpu_torch._private.lifecycle") or pkg.module_of("lifecycle.py")
    if tree is None:
        return None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "LIFECYCLE_SPEC":
                    try:
                        return ast.literal_eval(node.value)
                    except ValueError:
                        return None
    return None


def _machine_states(machine: dict) -> Set[str]:
    states = {machine["initial"]}
    states.update(machine.get("terminal", ()))
    for old, outs in machine.get("transitions", {}).items():
        states.add(old)
        states.update(outs)
    return states


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
    return fn or cls or "<module>"


def _enclosing_class(node: ast.AST) -> Optional[str]:
    for anc in ancestors(node):
        if isinstance(anc, ast.ClassDef):
            return anc.name
    return None


def _enclosing_func_name(node: ast.AST) -> Optional[str]:
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc.name
    return None


def _is_step_call(node: ast.AST, imports: Dict[str, str]) -> bool:
    if not isinstance(node, ast.Call):
        return False
    recv, meth = call_name(node)
    if meth != "step":
        return False
    if recv is not None:
        return recv == "lifecycle" or recv.endswith(".lifecycle")
    return imports.get("step", "").endswith("lifecycle.step")


def _state_literals(node: ast.AST) -> Optional[List[str]]:
    """Literal state names a to-state expression can evaluate to: a string
    constant, or an IfExp whose arms are both literal (the
    ``"FINISHED" if ok else "FAILED"`` idiom). None = dynamic."""
    s = const_str(node)
    if s is not None:
        return [s]
    if isinstance(node, ast.IfExp):
        arms = []
        for arm in (node.body, node.orelse):
            got = _state_literals(arm)
            if got is None:
                return None
            arms.extend(got)
        return arms
    return None


class _SpecTables:
    def __init__(self, spec: dict):
        self.spec = spec
        self.states: Dict[str, Set[str]] = {}
        self.targets: Dict[str, Set[str]] = {}          # states with an in-edge
        self.drivers_into: Dict[str, Dict[str, Set[str]]] = {}  # machine -> state -> modules
        self.by_class: Dict[Tuple[str, str], str] = {}  # (class, attr) -> machine
        self.by_recv: Dict[Tuple[str, str, str], str] = {}  # (module, recv, attr) -> machine
        self.module_attrs: Dict[str, Set[str]] = {}     # module -> covered attrs
        self.ambiguous: List[str] = []
        for name, m in spec.items():
            self.states[name] = _machine_states(m)
            tgt: Set[str] = set()
            into: Dict[str, Set[str]] = {}
            for old, outs in m.get("transitions", {}).items():
                for new, mods in outs.items():
                    tgt.add(new)
                    into.setdefault(new, set()).update(mods)
            self.targets[name] = tgt
            self.drivers_into[name] = into
            for cls in m.get("classes", ()):
                key = (cls, m["attr"])
                if key in self.by_class and self.by_class[key] != name:
                    self.ambiguous.append(
                        f"class {cls}.{m['attr']} claimed by both "
                        f"{self.by_class[key]!r} and {name!r}")
                self.by_class[key] = name
            for mod in m.get("modules", ()):
                self.module_attrs.setdefault(mod, set()).add(m["attr"])
                for recv in m.get("receivers", ()):
                    rkey = (mod, recv, m["attr"])
                    if rkey in self.by_recv and self.by_recv[rkey] != name:
                        self.ambiguous.append(
                            f"receiver {mod}:{recv}.{m['attr']} claimed by "
                            f"both {self.by_recv[rkey]!r} and {name!r}")
                    self.by_recv[rkey] = name


def run(pkg: Package, spec: Optional[dict] = None) -> List[Violation]:
    violations: List[Violation] = []
    if spec is None:
        spec = _spec_from_source(pkg)
    if not spec:
        return [Violation(_PASS, "<spec>", 0,
                          make_key(_PASS, "lifecycle.py", "missing-spec"),
                          "LIFECYCLE_SPEC not found / not a literal in "
                          "_private/lifecycle.py")]

    tables = _SpecTables(spec)

    # L8: spec-level coherence.
    for msg in tables.ambiguous:
        violations.append(Violation(
            _PASS, "lifecycle.py", 0,
            make_key(_PASS, "lifecycle.py", "spec", "ambiguous"),
            f"LIFECYCLE_SPEC is ambiguous: {msg}"))
    for name, m in spec.items():
        for term in m.get("terminal", ()):
            if m.get("transitions", {}).get(term):
                violations.append(Violation(
                    _PASS, "lifecycle.py", 0,
                    make_key(_PASS, "lifecycle.py", f"machine={name}",
                             f"state={term}", "terminal-out-edge"),
                    f"machine {name!r}: terminal state {term!r} has outgoing "
                    f"transitions"))

    # machine -> states seen written or compared anywhere (for L6), and
    # machines with at least one dynamic-target step (exempt from L6).
    seen_states: Dict[str, Set[str]] = {name: set() for name in spec}
    dynamic_write: Set[str] = set()
    for name, m in spec.items():
        seen_states[name].add(m["initial"])  # defaults checked per class below

    for module, tree in pkg.modules.items():
        attrs = tables.module_attrs.get(module)
        if not attrs:
            continue
        path = pkg.paths.get(module, module)
        imports = imported_names(tree)

        for node in ast.walk(tree):
            # ----------------------------------------------- class defaults
            if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                cls = _enclosing_class(node)
                if cls is None or node.value is None:
                    continue
                machine = tables.by_class.get((cls, node.target.id))
                if machine is None:
                    continue
                qual = f"{cls}.{node.target.id}"
                default = const_str(node.value)
                if default != spec[machine]["initial"]:
                    violations.append(Violation(
                        _PASS, path, node.lineno,
                        make_key(_PASS, path, qual, f"machine={machine}",
                                 "initial-mismatch"),
                        f"{qual} defaults to {default!r}, but machine "
                        f"{machine!r} starts in "
                        f"{spec[machine]['initial']!r} (L2)"))
                continue

            # ------------------------------------------------------ writes
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Attribute) \
                    and node.targets[0].attr in attrs:
                tgt = node.targets[0]
                attr = tgt.attr
                recv = dotted(tgt.value)
                qual = _enclosing_qualname(node)
                encl_cls = _enclosing_class(node)

                recv_machine = None
                if recv == "self" and encl_cls is not None:
                    recv_machine = tables.by_class.get((encl_cls, attr))
                elif recv is not None:
                    recv_machine = tables.by_recv.get((module, recv, attr))

                if _is_step_call(node.value, imports):
                    call = node.value
                    mlit = const_str(call.args[0]) if call.args else None
                    if mlit is None:
                        violations.append(Violation(
                            _PASS, path, node.lineno,
                            make_key(_PASS, path, qual, "step-dynamic-machine"),
                            f"{qual}: lifecycle.step() machine argument must "
                            f"be a string literal (L3)"))
                        continue
                    if mlit not in spec:
                        violations.append(Violation(
                            _PASS, path, node.lineno,
                            make_key(_PASS, path, qual, f"machine={mlit}",
                                     "unknown-machine"),
                            f"{qual}: lifecycle.step() names machine "
                            f"{mlit!r}, not in LIFECYCLE_SPEC (L3)"))
                        continue
                    if recv_machine is not None and recv_machine != mlit:
                        violations.append(Violation(
                            _PASS, path, node.lineno,
                            make_key(_PASS, path, qual, f"machine={mlit}",
                                     "receiver-mismatch"),
                            f"{qual}: step({mlit!r}, ...) written to "
                            f"{recv}.{attr}, which the spec attributes to "
                            f"machine {recv_machine!r} (L4)"))
                    # The old-state arg must be the attribute being written:
                    # step() checks the REAL edge only if it reads the live
                    # value.
                    if len(call.args) >= 2:
                        old_arg = call.args[1]
                        if isinstance(old_arg, ast.Attribute) and (
                            old_arg.attr != attr or dotted(old_arg.value) != recv
                        ):
                            violations.append(Violation(
                                _PASS, path, node.lineno,
                                make_key(_PASS, path, qual, f"machine={mlit}",
                                         "old-arg-mismatch"),
                                f"{qual}: step() old-state arg is "
                                f"{dotted(old_arg.value)}.{old_arg.attr}, not "
                                f"the written {recv}.{attr} (L8)"))
                    news = _state_literals(call.args[2]) if len(call.args) >= 3 else None
                    if news is None:
                        # Dynamic target: the runtime monitor still checks the
                        # real edge; statically only authorization is visible.
                        dynamic_write.add(mlit)
                        if module not in spec[mlit].get("modules", ()):
                            violations.append(Violation(
                                _PASS, path, node.lineno,
                                make_key(_PASS, path, qual, f"machine={mlit}",
                                         "unauthorized-module"),
                                f"{qual}: module {module} drives machine "
                                f"{mlit!r} but is not authorized for it (L4)"))
                        continue
                    for new in news:
                        if new not in tables.states[mlit]:
                            violations.append(Violation(
                                _PASS, path, node.lineno,
                                make_key(_PASS, path, qual, f"machine={mlit}",
                                         f"state={new}", "unknown-state"),
                                f"{qual}: step() targets state {new!r}, which "
                                f"machine {mlit!r} does not declare (L3)"))
                            continue
                        seen_states[mlit].add(new)
                        if new not in tables.targets[mlit]:
                            violations.append(Violation(
                                _PASS, path, node.lineno,
                                make_key(_PASS, path, qual, f"machine={mlit}",
                                         f"state={new}", "undeclared-transition"),
                                f"{qual}: no declared transition of machine "
                                f"{mlit!r} ends in {new!r} (L1)"))
                        elif module not in tables.drivers_into[mlit].get(new, ()):
                            violations.append(Violation(
                                _PASS, path, node.lineno,
                                make_key(_PASS, path, qual, f"machine={mlit}",
                                         f"state={new}", "unauthorized-module"),
                                f"{qual}: module {module} is not authorized "
                                f"to drive machine {mlit!r} into {new!r} (L4)"))
                    continue

                # Plain (non-step) write.
                if recv_machine is None:
                    violations.append(Violation(
                        _PASS, path, node.lineno,
                        make_key(_PASS, path, qual, f"attr={attr}",
                                 "unattributed-write"),
                        f"{qual} writes {recv or '<expr>'}.{attr} in a "
                        f"covered module, but no machine claims it (L7)"))
                    continue
                machine = recv_machine
                initial = spec[machine]["initial"]
                is_init_site = (
                    recv == "self"
                    and encl_cls in spec[machine].get("classes", ())
                    and _enclosing_func_name(node) == "__init__"
                )
                lit = const_str(node.value)
                if is_init_site:
                    if lit != initial:
                        violations.append(Violation(
                            _PASS, path, node.lineno,
                            make_key(_PASS, path, qual, f"machine={machine}",
                                     "initial-mismatch"),
                            f"{qual} initializes {attr} to {lit!r}, but "
                            f"machine {machine!r} starts in {initial!r} (L2)"))
                    else:
                        seen_states[machine].add(lit)
                    continue
                violations.append(Violation(
                    _PASS, path, node.lineno,
                    make_key(_PASS, path, qual, f"machine={machine}",
                             f"state={lit}" if lit else "state=<dynamic>",
                             "bypasses-step"),
                    f"{qual} writes {recv}.{attr} (machine {machine!r}) "
                    f"directly; transition writes must go through "
                    f"lifecycle.step() (L1)"))
                if lit is not None and lit in tables.states[machine]:
                    seen_states[machine].add(lit)
                continue

            # ------------------------------------------------- comparisons
            if isinstance(node, ast.Compare):
                sides = [node.left, *node.comparators]
                attr_side = None
                for side in sides:
                    if isinstance(side, ast.Attribute) and side.attr in attrs:
                        recv = dotted(side.value)
                        encl_cls = _enclosing_class(node)
                        if recv == "self" and encl_cls is not None:
                            m = tables.by_class.get((encl_cls, side.attr))
                        elif recv is not None:
                            m = tables.by_recv.get((module, recv, side.attr))
                        else:
                            m = None
                        if m is not None:
                            attr_side = (side, m)
                            break
                if attr_side is None:
                    continue
                side, machine = attr_side
                qual = _enclosing_qualname(node)
                lits: List[str] = []
                for other in sides:
                    if other is side:
                        continue
                    s = const_str(other)
                    if s is not None:
                        lits.append(s)
                    elif isinstance(other, (ast.Tuple, ast.List, ast.Set)):
                        lits.extend(
                            es for es in (const_str(e) for e in other.elts)
                            if es is not None)
                for s in lits:
                    if s not in tables.states[machine]:
                        violations.append(Violation(
                            _PASS, path, node.lineno,
                            make_key(_PASS, path, qual, f"machine={machine}",
                                     f"state={s}", "unknown-state-compare"),
                            f"{qual} compares {dotted(side.value)}.{side.attr} "
                            f"(machine {machine!r}) against undeclared state "
                            f"{s!r} (L5)"))
                    else:
                        seen_states[machine].add(s)

    # L6: spec states nothing ever writes or compares.
    for name, m in spec.items():
        if name in dynamic_write:
            continue
        for state in sorted(tables.states[name] - seen_states[name]):
            violations.append(Violation(
                _PASS, "lifecycle.py", 0,
                make_key(_PASS, "lifecycle.py", f"machine={name}",
                         f"state={state}", "unreachable"),
                f"machine {name!r} declares state {state!r}, but no covered "
                f"code ever writes or compares it (L6)"))
    return violations
