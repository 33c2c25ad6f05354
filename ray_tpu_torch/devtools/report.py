"""Shared violation reporting for the devtools CLIs (rt-lint, rt-verify,
rt-state): one allowlist loader/applier with stale-entry detection, one
summary formatter, one ``--json`` encoder.

Before this module, lint.py and verify/__init__.py each carried their own
copy of the load → apply → stale-error block, and the two CLIs each carried
their own copy of the render/summary loop; a format change had to be made
twice or the tools drifted. Everything allowlist- and output-shaped now
lives here; the passes stay pure (they return Violations, nothing else).
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

from ray_tpu_torch.devtools.astutil import (
    Violation, apply_allowlist, load_allowlist,
)


def apply_allowlist_file(violations: List[Violation],
                         allowlist_path: str) -> Tuple[List[Violation], List[str]]:
    """Load ``allowlist_path``, suppress matching violations, and report
    format errors plus stale (unused) entries as errors. Returns the
    remaining violations (sorted) and the error strings."""
    errors: List[str] = []
    entries, fmt_errors = load_allowlist(allowlist_path)
    errors.extend(fmt_errors)
    violations, unused = apply_allowlist(violations, entries)
    for e in unused:
        errors.append(
            f"{allowlist_path}:{e.line_no}: allowlist entry no longer "
            f"matches any violation (stale — delete it): {e.key}"
        )
    violations.sort(key=lambda v: (v.pass_id, v.path, v.line))
    return violations, errors


def counts_by_pass(violations: Sequence[Violation]) -> Dict[str, int]:
    by_pass: Dict[str, int] = {}
    for v in violations:
        by_pass[v.pass_id] = by_pass.get(v.pass_id, 0) + 1
    return by_pass


def as_json(tool: str, violations: Sequence[Violation],
            errors: Sequence[str], exit_code: int) -> str:
    """Machine-readable findings: stable shape for CI diffing (tools/check.sh
    can compare runs instead of grepping human text)."""
    return json.dumps({
        "tool": tool,
        "exit_code": exit_code,
        "counts": counts_by_pass(violations),
        "violations": [
            {"pass": v.pass_id, "path": v.path, "line": v.line,
             "key": v.key, "message": v.message}
            for v in violations
        ],
        "allowlist_errors": list(errors),
    }, indent=2, sort_keys=True)


def emit(tool: str, violations: Sequence[Violation], errors: Sequence[str],
         quiet: bool = False, json_out: bool = False) -> int:
    """Print findings the one canonical way; returns the exit code (0 clean,
    1 violations or allowlist errors)."""
    rc = 1 if (violations or errors) else 0
    if json_out:
        print(as_json(tool, violations, errors, rc))
        return rc
    if not quiet:
        for v in violations:
            print(v.render())
        for e in errors:
            print(f"ALLOWLIST ERROR: {e}")
    detail = ", ".join(f"{k}={c}" for k, c in
                       sorted(counts_by_pass(violations).items()))
    status = "FAILED" if rc else "OK"
    print(f"{tool} {status}: {len(violations)} violation(s)"
          + (f" ({detail})" if detail else "")
          + (f", {len(errors)} allowlist error(s)" if errors else ""))
    return rc
