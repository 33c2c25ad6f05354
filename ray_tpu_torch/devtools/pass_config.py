"""Config-knob discipline.

  C1 undeclared-knob   a runtime Config attribute access that resolves to no
                       declared `Config` dataclass field (typo / removed knob)
  C2 dead-knob         a declared field never read anywhere in the tree
  C3 unknown-env       a RAY_TPU_TORCH_* environment key used (read OR set) that is
                       neither `RAY_TPU_TORCH_<config field>` (the documented
                       override form) nor listed in config.ENV_VARS

Config-access detection (under-approximate on purpose, zero false positives
over precision):
  - `get_config().<attr>` anywhere in the tree;
  - `<name>.<attr>` where <name> was assigned from `get_config()` or from a
    `*.config` chain in the same function;
  - `<expr>.config.<attr>` chains inside the runtime-core modules
    (CONFIG_MODULES) — rllib/serve carry their own unrelated `.config`
    objects, so the chain rule must not see them;
  - `<param>.<attr>` where the enclosing function's parameter is annotated
    `Config`.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.astutil import (
    Package, Violation, ancestors, call_name, const_str, dotted, make_key,
)

# Modules where a bare `*.config.<attr>` chain means the runtime Config.
DEFAULT_CONFIG_MODULES = (
    "ray_tpu_torch._private.scheduler",
    "ray_tpu_torch._private.worker",
    "ray_tpu_torch._private.worker_main",
    "ray_tpu_torch._private.node_daemon",
    "ray_tpu_torch._private.batching",
    "ray_tpu_torch._private.retry",
    "ray_tpu_torch._private.telemetry",
    "ray_tpu_torch._private.timeseries",
    "ray_tpu_torch._private.jobs",
    "ray_tpu_torch._private.object_store",
    "ray_tpu_torch._private.head",
    "ray_tpu_torch._private.launch",
    "ray_tpu_torch._private.config",
)

_CONFIG_METHODS = {"apply_overrides"}


def _declared(pkg: Package) -> Tuple[Optional[Set[str]], Optional[Set[str]], Optional[str]]:
    """(fields, env_vars, path) parsed from the Config dataclass + ENV_VARS
    registry in config.py."""
    tree = pkg.module_of("ray_tpu_torch._private.config") or pkg.module_of("config.py")
    if tree is None:
        return None, None, None
    fields: Optional[Set[str]] = None
    env_vars: Optional[Set[str]] = None
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "Config":
            fields = set()
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
                    fields.add(stmt.target.id)
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "ENV_VARS":
                    try:
                        val = ast.literal_eval(node.value)
                        env_vars = set(val) if not isinstance(val, dict) else set(val.keys())
                    except ValueError:
                        pass
    path = None
    for mod, p in pkg.paths.items():
        if mod.endswith("config") or p.endswith("config.py"):
            path = p
            break
    return fields, env_vars, path


def _config_receivers(fn_node: ast.AST, chain_ok: bool) -> Set[str]:
    """Local names holding the runtime Config inside one function: assigned
    from get_config() (anywhere), or — inside runtime-core modules only
    (`chain_ok`) — assigned from a `... .config` chain, named cfg/config as
    a parameter, or annotated `Config` (rllib/serve have their own config
    objects under the same names, so these rules must not see them)."""
    names: Set[str] = set()
    args = getattr(fn_node, "args", None)
    if args is not None and chain_ok:
        for a in list(args.args) + list(args.kwonlyargs):
            ann = a.annotation
            ann_s = dotted(ann) if ann is not None else None
            if ann_s is None and ann is not None:
                ann_s = const_str(ann)  # "Config" string annotations
            if ann_s and ann_s.split(".")[-1] == "Config":
                names.add(a.arg)
            elif a.arg in ("cfg", "config"):
                names.add(a.arg)
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            src = node.value
            if isinstance(src, ast.Call) and call_name(src)[1] == "get_config":
                names.add(node.targets[0].id)
            elif chain_ok:
                d = dotted(src)
                if d and d.split(".")[-1] == "config":
                    names.add(node.targets[0].id)
    return names


def _enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def _iter_config_accesses(pkg: Package, chain_modules: Set[str]):
    """Yield (module, path, attr_name, lineno) for every detected runtime
    Config attribute access."""
    for module, tree in pkg.modules.items():
        path = pkg.paths[module]
        chain_ok = module in chain_modules
        recv_cache: Dict[ast.AST, Set[str]] = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Attribute) or not isinstance(node.ctx, ast.Load):
                continue
            # Skip the inner `.config` of a longer chain (x.config.attr visits
            # both `x.config.attr` and `x.config`).
            parent = getattr(node, "_rt_parent", None)
            if isinstance(parent, ast.Attribute):
                continue
            base = node.value
            attr = node.attr
            hit = False
            if isinstance(base, ast.Call) and call_name(base)[1] == "get_config":
                hit = True
            elif isinstance(base, ast.Attribute) and base.attr == "config" and chain_ok:
                hit = True
            elif isinstance(base, ast.Name):
                fn = _enclosing_function(node)
                if fn is not None:
                    if fn not in recv_cache:
                        recv_cache[fn] = _config_receivers(fn, chain_ok)
                    if base.id in recv_cache[fn]:
                        hit = True
            if hit:
                yield module, path, attr, node.lineno


def _iter_env_uses(pkg: Package):
    """Yield (module, path, env_key, lineno) for RAY_TPU_TORCH_* keys used with
    os.environ / os.getenv (reads, membership tests, and writes)."""
    for module, tree in pkg.modules.items():
        path = pkg.paths[module]
        for node in ast.walk(tree):
            key = None
            if isinstance(node, ast.Call):
                recv, meth = call_name(node)
                env_call = (
                    (recv and recv.endswith("environ") and meth in ("get", "pop", "setdefault"))
                    or (meth == "getenv")
                )
                if env_call and node.args:
                    key = const_str(node.args[0])
            elif isinstance(node, ast.Subscript):
                base = dotted(node.value)
                if base and (base.endswith("environ") or base in ("env", "envb")):
                    key = const_str(node.slice)
            elif isinstance(node, ast.Compare) and len(node.ops) == 1 \
                    and isinstance(node.ops[0], (ast.In, ast.NotIn)):
                cmp_base = dotted(node.comparators[0])
                if cmp_base and cmp_base.endswith("environ"):
                    key = const_str(node.left)
            if key and key.startswith("RAY_TPU_TORCH_"):
                yield module, path, key, node.lineno


def run(pkg: Package, fields: Optional[Set[str]] = None,
        env_vars: Optional[Set[str]] = None,
        config_modules=DEFAULT_CONFIG_MODULES,
        check_dead: bool = True) -> List[Violation]:
    violations: List[Violation] = []
    d_fields, d_env, cfg_path = _declared(pkg)
    if fields is None:
        fields = d_fields
    if env_vars is None:
        env_vars = d_env if d_env is not None else set()
    if fields is None:
        return [Violation("config", "<config>", 0,
                          make_key("config", "config.py", "missing-config"),
                          "Config dataclass not found in the tree")]

    seen_fields: Set[str] = set()
    reported: Set[str] = set()
    for module, path, attr, lineno in _iter_config_accesses(pkg, set(config_modules)):
        if attr.startswith("__") or attr in _CONFIG_METHODS:
            continue
        if attr in fields:
            seen_fields.add(attr)
            continue
        key = make_key("config", path, f"cfg.{attr}")
        if key in reported:
            continue
        reported.add(key)
        violations.append(Violation(
            "config", path, lineno, key,
            f"access to undeclared config knob cfg.{attr} (no such Config field)",
        ))

    for module, path, env_key, lineno in _iter_env_uses(pkg):
        suffix = env_key[len("RAY_TPU_TORCH_"):]
        if suffix in fields:
            seen_fields.add(suffix)
            continue
        if env_key in env_vars:
            continue
        key = make_key("config", path, f"env.{env_key}")
        if key in reported:
            continue
        reported.add(key)
        violations.append(Violation(
            "config", path, lineno, key,
            f"environment key {env_key} is neither a RAY_TPU_TORCH_<Config field> "
            f"override nor declared in config.ENV_VARS",
        ))

    if check_dead:
        for field_name in sorted(fields - seen_fields):
            violations.append(Violation(
                "config", cfg_path or "config.py", 0,
                make_key("config", cfg_path or "config.py", f"dead.{field_name}"),
                f"Config.{field_name} is declared but never read anywhere "
                f"(dead knob)",
            ))
    return violations
