"""rt-lint CLI: run the eight invariant passes over the ray_tpu_torch tree.

Usage::

    python -m ray_tpu_torch.devtools.lint [package_dir] [--allowlist FILE]
        [--passes protocol,blocking,affinity,config,metrics,failpoints,ownership,lifecycle]
        [-q] [--json]

Exit status: 0 = clean (after allowlist), 1 = violations / allowlist format
errors / unused allowlist entries. Designed for CI (tools/check.sh) and for
tests/test_static_analysis.py, which runs it over the live package so any
new violation fails tier-1.

The allowlist (default: lint_allowlist.txt next to this file) suppresses a
violation only with a per-line justification::

    <violation key> -- <why this one is acceptable>

Unused entries fail the run, so the file can only shrink or stay honest.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Dict, List

from ray_tpu_torch.devtools import (
    pass_affinity, pass_blocking, pass_config, pass_failpoints,
    pass_lifecycle, pass_metrics, pass_ownership, pass_protocol, report,
)
from ray_tpu_torch.devtools.astutil import Package, Violation, load_package

PASSES: Dict[str, Callable[[Package], List[Violation]]] = {
    "protocol": pass_protocol.run,
    "blocking": pass_blocking.run,
    "affinity": pass_affinity.run,
    "config": pass_config.run,
    "metrics": pass_metrics.run,
    "failpoints": pass_failpoints.run,
    "ownership": pass_ownership.run,
    "lifecycle": pass_lifecycle.run,
}

_HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_ALLOWLIST = os.path.join(_HERE, "lint_allowlist.txt")


def run_all(package_dir: str, passes=None, doc_path: str = None,
            allowlist_path: str = None):
    """Programmatic entry: returns (violations, allowlist_errors). Used by
    tests and the CLI alike."""
    pkg = load_package(package_dir, package_name="ray_tpu_torch")
    if doc_path is None:
        cand = os.path.join(os.path.dirname(os.path.abspath(package_dir)),
                            "COMPONENTS.md")
        doc_path = cand if os.path.exists(cand) else None
    violations: List[Violation] = []
    for name in passes or PASSES:
        fn = PASSES[name]
        if name == "metrics":
            violations.extend(pass_metrics.run(pkg, doc_path=doc_path))
        elif name == "failpoints":
            violations.extend(pass_failpoints.run(pkg, doc_path=doc_path))
        else:
            violations.extend(fn(pkg))
    errors: List[str] = []
    if allowlist_path:
        violations, errors = report.apply_allowlist_file(violations, allowlist_path)
    violations.sort(key=lambda v: (v.pass_id, v.path, v.line))
    return violations, errors


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("package", nargs="?", default=None,
                        help="package directory to lint (default: the "
                             "ray_tpu_torch package this tool ships in)")
    parser.add_argument("--allowlist", default=DEFAULT_ALLOWLIST,
                        help="allowlist file (use /dev/null to disable)")
    parser.add_argument("--passes", default=None,
                        help="comma-separated subset of: " + ",".join(PASSES))
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="print only the summary line")
    parser.add_argument("--json", action="store_true", dest="json_out",
                        help="emit machine-readable findings (per-pass "
                             "counts + violations + exit code) on stdout")
    ns = parser.parse_args(argv)

    package_dir = ns.package or os.path.dirname(_HERE)
    passes = ns.passes.split(",") if ns.passes else None
    if passes:
        unknown = [p for p in passes if p not in PASSES]
        if unknown:
            print(f"rt-lint: unknown pass(es): {', '.join(unknown)}", file=sys.stderr)
            return 2

    violations, errors = run_all(package_dir, passes=passes,
                                 allowlist_path=ns.allowlist)
    return report.emit("rt-lint", violations, errors, quiet=ns.quiet,
                       json_out=ns.json_out)


if __name__ == "__main__":
    sys.exit(main())
