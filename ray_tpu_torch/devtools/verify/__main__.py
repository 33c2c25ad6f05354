"""rt-verify CLI.

Usage::

    python -m ray_tpu_torch.devtools.verify [package_dir]
        [--passes session,lockorder,native,stale] [--allowlist FILE] [-q]
        [--json] [--fuzz N] [--fuzz-seed S] [--corpus DIR]
        [--explore SCENARIOS] [--explore-budget N] [--explore-seed S]

Default: the four static passes over the shipped package (allowlisted).
``--fuzz N`` additionally runs N structure-aware mutation cases per codec
against both wire decoders (corpus replay first; crashers persisted under
<corpus>/crashers/ and named in the failure). ``--explore`` additionally
runs rt-state's interleaving exploration over the named scenarios (or
``all``): real scheduler handlers, virtual transport, systematic delivery /
crash orderings — corpus replay first, then bounded DFS.

Exit status: 0 clean, 1 violations / allowlist errors / fuzz failure /
exploration failure, 2 usage error.
"""

from __future__ import annotations

import argparse
import os
import sys

from ray_tpu_torch.devtools import report
from ray_tpu_torch.devtools.verify import DEFAULT_ALLOWLIST, PASS_NAMES, run_all

_HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.verify", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("package", nargs="?", default=None)
    parser.add_argument("--allowlist", default=DEFAULT_ALLOWLIST)
    parser.add_argument("--passes", default=None,
                        help="comma-separated subset of: " + ",".join(PASS_NAMES)
                             + " (or 'none' to skip statics, e.g. with --fuzz)")
    parser.add_argument("--fuzz", type=int, default=0, metavar="N",
                        help="also fuzz both wire codecs with N cases each")
    parser.add_argument("--fuzz-seed", type=int, default=20260804)
    parser.add_argument("--corpus", default=None,
                        help="fuzz corpus dir (default: replay tools/fuzz_corpus "
                             "and persist into devtools/verify/fuzz_corpus)")
    parser.add_argument("-q", "--quiet", action="store_true")
    parser.add_argument("--json", action="store_true", dest="json_out",
                        help="emit machine-readable findings on stdout")
    parser.add_argument("--explore", default=None, metavar="SCENARIOS",
                        help="run interleaving exploration over a "
                             "comma-separated scenario list (or 'all')")
    parser.add_argument("--explore-budget", type=int, default=400,
                        help="max schedules explored per scenario")
    parser.add_argument("--explore-seed", type=int, default=20260807)
    ns = parser.parse_args(argv)

    package_dir = ns.package or os.path.dirname(os.path.dirname(_HERE))
    passes = ns.passes.split(",") if ns.passes else None
    if ns.passes == "none":
        passes = []  # fuzz-only / explicit no-op: don't re-run the statics
    elif passes:
        unknown = [p for p in passes if p not in PASS_NAMES]
        if unknown:
            print(f"rt-verify: unknown pass(es): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2

    if passes == []:
        # Fuzz-only mode: no static passes, and no allowlist application
        # (every entry would spuriously count as stale against zero
        # violations).
        violations, errors = [], []
    else:
        violations, errors = run_all(package_dir, passes=passes,
                                     allowlist_path=ns.allowlist)
    rc = report.emit("rt-verify", violations, errors, quiet=ns.quiet,
                     json_out=ns.json_out)

    if ns.fuzz > 0:
        from ray_tpu_torch.devtools.verify import fuzz_wire

        try:
            fuzz_wire.run_fuzz(
                rounds=ns.fuzz, seed=ns.fuzz_seed,
                corpus_dir=ns.corpus or fuzz_wire.DEFAULT_CORPUS,
                quiet=ns.quiet,
            )
        except fuzz_wire.FuzzFailure as e:
            print(f"rt-verify FUZZ FAILED: {e}")
            return 1

    if ns.explore is not None:
        from ray_tpu_torch.devtools.verify import explore

        names = (list(explore.SCENARIOS) if ns.explore == "all"
                 else ns.explore.split(","))
        unknown = [s for s in names if s not in explore.SCENARIOS]
        if unknown:
            print(f"rt-verify: unknown scenario(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2
        ok = explore.run_sweep(names, budget=ns.explore_budget,
                               seed=ns.explore_seed, quiet=ns.quiet)
        if not ok:
            print("rt-verify EXPLORE FAILED")
            return 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
