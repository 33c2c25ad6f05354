"""Shared AST plumbing for the rt-lint passes: package loading, a function
symbol table with decorator info, parent links for ancestor queries, and the
Violation/allowlist model.

Everything here is pure stdlib on purpose — see the package docstring.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple


# --------------------------------------------------------------------- model
@dataclass
class Violation:
    """One finding. `key` is the stable identity used by the allowlist:
    pass id + file basename + symbol(ish) detail, never a line number, so
    entries survive unrelated edits."""

    pass_id: str
    path: str
    line: int
    key: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_id}] {self.message}\n    key: {self.key}"


def make_key(pass_id: str, path: str, *parts: str) -> str:
    return ":".join([pass_id, os.path.basename(path), *parts])


@dataclass
class FuncInfo:
    module: str          # dotted module name, e.g. "ray_tpu_torch._private.scheduler"
    path: str            # file path (as given to the loader)
    cls: Optional[str]   # enclosing class name, if a method
    name: str            # bare function name
    node: ast.AST        # FunctionDef / AsyncFunctionDef
    decorators: Set[str] = field(default_factory=set)

    @property
    def qualname(self) -> str:
        return f"{self.cls}.{self.name}" if self.cls else self.name

    @property
    def key(self) -> str:
        return f"{self.module}:{self.qualname}"


class Package:
    """Parsed view of a set of Python files: module ASTs (with parent links)
    plus a function symbol table."""

    def __init__(self) -> None:
        self.modules: Dict[str, ast.Module] = {}
        self.paths: Dict[str, str] = {}
        self.functions: Dict[str, FuncInfo] = {}        # key -> info
        self.by_name: Dict[str, List[FuncInfo]] = {}    # bare name -> infos

    # ---------------------------------------------------------------- loading
    def add_module(self, module: str, path: str, source: str) -> None:
        tree = ast.parse(source, filename=path)
        link_parents(tree)
        self.modules[module] = tree
        self.paths[module] = path
        for cls, fn in iter_functions(tree):
            info = FuncInfo(
                module=module, path=path, cls=cls, name=fn.name, node=fn,
                decorators={decorator_name(d) for d in fn.decorator_list} - {""},
            )
            self.functions[info.key] = info
            self.by_name.setdefault(fn.name, []).append(info)

    def module_of(self, path_or_module: str) -> Optional[ast.Module]:
        if path_or_module in self.modules:
            return self.modules[path_or_module]
        for mod, p in self.paths.items():
            if p == path_or_module or os.path.basename(p) == path_or_module:
                return self.modules[mod]
        return None

    def lookup(self, ref: str) -> Optional[FuncInfo]:
        """Resolve "module:Class.method" / "module:function"."""
        return self.functions.get(ref)


# One parsed Package per (root, name, excludes) per process, revalidated by
# a cheap per-file (mtime_ns, size) signature walk. Every rt-lint pass, every
# rt-verify pass, and every test that loads the live tree shares ONE parse
# (parsing ~250 files costs ~1s; the suite used to pay it per run_all call
# inside tier-1). Passes treat Package as read-only by contract.
_pkg_cache: dict = {}


def _tree_signature(root: str, exclude: Sequence[str]) -> tuple:
    sig = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames
            if d != "__pycache__"
            and not (os.path.relpath(dirpath, root) == "." and d in exclude)
        )
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                fpath = os.path.join(dirpath, fname)
                try:
                    st = os.stat(fpath)
                except OSError:
                    continue
                sig.append((fpath, st.st_mtime_ns, st.st_size))
    return tuple(sig)


def load_package(root: str, package_name: Optional[str] = None,
                 exclude: Sequence[str] = ("devtools",)) -> Package:
    """Parse every .py under `root` (a package directory or a single file).
    Module names are dotted paths rooted at `package_name` (defaults to the
    directory's basename). `exclude` prunes top-level subpackage names.
    Results are cached per process and revalidated by file stat signature;
    callers must treat the returned Package as read-only."""
    pkg = Package()
    if os.path.isfile(root):
        name = os.path.splitext(os.path.basename(root))[0]
        with open(root, "r", encoding="utf-8") as fh:
            pkg.add_module(name, root, fh.read())
        return pkg
    cache_key = (os.path.abspath(root), package_name, tuple(exclude))
    sig = _tree_signature(root, exclude)
    cached = _pkg_cache.get(cache_key)
    if cached is not None and cached[0] == sig:
        return cached[1]
    base = package_name or os.path.basename(os.path.normpath(root))
    for fpath, _mtime, _size in sig:
        rel = os.path.relpath(fpath, root)
        parts = rel[:-3].split(os.sep)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        module = ".".join([base, *parts]) if parts else base
        try:
            with open(fpath, "r", encoding="utf-8") as fh:
                pkg.add_module(module, fpath, fh.read())
        except SyntaxError:
            # A file the runtime can't import either; not lint's problem.
            continue
        except OSError:
            continue  # vanished between the signature walk and the read
    _pkg_cache[cache_key] = (sig, pkg)
    return pkg


# ----------------------------------------------------------------- AST utils
def link_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._rt_parent = node  # type: ignore[attr-defined]


def ancestors(node: ast.AST) -> Iterable[ast.AST]:
    cur = getattr(node, "_rt_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_rt_parent", None)


def iter_functions(tree: ast.Module):
    """Yield (class_name_or_None, FunctionDef) for every def in the module,
    attributing nested defs to their enclosing class (one level: methods of
    nested classes keep the innermost class name)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cls = None
            for anc in ancestors(node):
                if isinstance(anc, ast.ClassDef):
                    cls = anc.name
                    break
                if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    # Nested function: attribute to the outer def's class so
                    # closure helpers stay reachable in the call graph.
                    continue
            yield cls, node


def walk_body(fn_node: ast.AST) -> Iterable[ast.AST]:
    """Walk a function WITHOUT descending into nested defs or lambdas: code
    in a nested function runs when (and where — often another thread, or a
    deferred callback) it is CALLED, not where it is defined, so its calls
    must not be attributed to the enclosing function."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def decorator_name(node: ast.AST) -> str:
    """Bare name of a decorator: @x, @mod.x, @x(...), @mod.x(...) -> "x"."""
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def call_name(node: ast.Call) -> Tuple[Optional[str], str]:
    """(receiver_dotted_or_None, method_name) for a Call: f() -> (None, "f"),
    a.b.c() -> ("a.b", "c")."""
    fn = node.func
    if isinstance(fn, ast.Name):
        return None, fn.id
    if isinstance(fn, ast.Attribute):
        return dotted(fn.value), fn.attr
    return None, ""


def dotted(node: ast.AST) -> Optional[str]:
    """Render a Name/Attribute chain as "a.b.c"; None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def has_timeout_arg(call: ast.Call) -> bool:
    """True if the call plausibly passes a bound — a positional arg that is
    not literally None/True (``.wait(None)`` and ``.acquire(True)`` are
    unbounded waits spelled with an argument), or a ``timeout=`` keyword
    whose value is not literally None."""
    for a in call.args:
        if isinstance(a, ast.Constant) and (a.value is None or a.value is True):
            continue
        return True
    for kw in call.keywords:
        if kw.arg == "timeout":
            return not (isinstance(kw.value, ast.Constant) and kw.value.value is None)
    return False


def imported_names(tree: ast.Module) -> Dict[str, str]:
    """Map local name -> source ("module" or "module.attr") for top-level
    imports, so passes can resolve `from x import y` call sites."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = f"{node.module}.{alias.name}"
    return out


# ------------------------------------------------------------------ allowlist
@dataclass
class AllowEntry:
    key: str
    justification: str
    line_no: int
    used: bool = False


def load_allowlist(path: str) -> Tuple[List[AllowEntry], List[str]]:
    """Parse the allowlist. Line format::

        <violation key> -- <justification>

    '#' lines and blanks are comments. Returns (entries, format_errors);
    an entry with no justification is a format error — the allowlist is
    line-by-line justified by construction."""
    entries: List[AllowEntry] = []
    errors: List[str] = []
    if not os.path.exists(path):
        return entries, errors
    with open(path, "r", encoding="utf-8") as fh:
        for i, raw in enumerate(fh, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            key, sep, why = line.partition(" -- ")
            if not sep or not why.strip():
                errors.append(
                    f"{path}:{i}: allowlist entry has no ' -- <justification>': {line!r}"
                )
                continue
            entries.append(AllowEntry(key=key.strip(), justification=why.strip(), line_no=i))
    return entries, errors


def apply_allowlist(violations: List[Violation], entries: List[AllowEntry]
                    ) -> Tuple[List[Violation], List[AllowEntry]]:
    """Filter violations through the allowlist. Returns (remaining, unused
    entries). Matching is exact on the stable key."""
    by_key: Dict[str, AllowEntry] = {e.key: e for e in entries}
    remaining: List[Violation] = []
    for v in violations:
        ent = by_key.get(v.key)
        if ent is not None:
            ent.used = True
        else:
            remaining.append(v)
    unused = [e for e in entries if not e.used]
    return remaining, unused
