"""rt-verify: system-level verification for the ray_tpu_torch control plane — the
step up from rt-lint's per-site checks to whole-protocol / whole-binary ones.

Where rt-lint asks "is this call site well-formed?", rt-verify asks "can the
SYSTEM misbehave?": the wire protocol has stateful rules (request/reply token
pairing, transfer_begin -> transfer_chunk* -> transfer_end streams, per-role
tag ownership) that no arity check sees, and the native extensions decode
untrusted network bytes in hand-rolled C where a missed bounds check is a
crash or a multi-GB allocation, not a traceback.

Static passes (pure stdlib, never import the runtime — same contract as
rt-lint; shared parsed-AST cache in devtools.astutil):

  session    -- every sender site's module role and the session spec's own
                coherence checked against protocol.SESSION_SPEC +
                MESSAGE_GRAMMAR (pairs reply in the reverse direction,
                stream tags exist, no module speaks a role it doesn't own)
  lockorder  -- lock-acquisition graph over `with self._lock:` /
                `@lock_guarded` sites across the tree; any cycle (potential
                deadlock between PullManager/PushManager/OwnershipTable/
                BatchedSender/scheduler locks) is a violation
  native     -- C-source checks over _native/wire_native.c + shm_arena.cpp:
                unchecked PyMem_Malloc/Realloc, owned references leaked on
                error-return paths, length fields used in memcpy/allocation
                without a preceding bounds check
  stale      -- the checked-in .so binaries must embed the sha256 of the
                source they were built from (drift fails the run)

Dynamic verification (same CLI):

  fuzz       -- structure-aware mutation fuzzer over BOTH wire codecs (the C
                extension and its pure-Python twin): seeded + replayable,
                the checked-in tools/fuzz_corpus/ replayed (read only),
                asserting typed rejection (WireDecodeError), reject-parity
                between the twins, and bounded time/allocation per case;
                crashing inputs and new finds are written to the port's own
                devtools/verify/fuzz_corpus/ (or the --corpus DIR given)

Runtime conformance (not in this package, but generated from the same spec):
`ray_tpu_torch._private.session_monitor` compiles SESSION_SPEC into per-connection
monitors armed by RAY_TPU_TORCH_DEBUG_INVARIANTS=1 — out-of-state frames raise in
live mini-clusters, so the invariants-armed test suites exercise the session
machine end to end.

Entry point::

    python -m ray_tpu_torch.devtools.verify [package_dir] [--passes ...]
        [--fuzz N] [--allowlist FILE]

Violations use the rt-lint allowlist model (verify_allowlist.txt next to
this package: stable keys, mandatory ` -- justification`, stale entries
fail).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_ALLOWLIST = os.path.join(_HERE, "verify_allowlist.txt")
# The shipped package's native dir — the fallback when run_all is given no
# package_dir-derived location (single definition; pass_native and stale
# import it from here).
DEFAULT_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                                  "_native")


def run_all(package_dir: str, passes: Optional[List[str]] = None,
            allowlist_path: Optional[str] = None,
            native_dir: Optional[str] = None) -> Tuple[list, List[str]]:
    """Run the static verify passes; returns (violations, errors) with the
    allowlist applied — the same contract as lint.run_all, over the same
    shared parsed-AST cache."""
    from ray_tpu_torch.devtools import report
    from ray_tpu_torch.devtools.astutil import load_package
    from ray_tpu_torch.devtools.verify import (
        pass_lockorder, pass_native, pass_session, stale,
    )

    if native_dir is None:
        # Verify the TARGET tree's native sources/binaries, not whichever
        # installation this module was imported from.
        cand = os.path.join(package_dir, "_native")
        native_dir = cand if os.path.isdir(cand) else DEFAULT_NATIVE_DIR

    table: Dict[str, object] = {
        "session": pass_session.run,
        "lockorder": pass_lockorder.run,
        "native": lambda pkg: pass_native.run(pkg, native_dir=native_dir),
        "stale": lambda pkg: stale.run(pkg, native_dir=native_dir),
    }
    pkg = load_package(package_dir, package_name="ray_tpu_torch")
    violations: list = []
    for name in (passes if passes is not None else table):
        violations.extend(table[name](pkg))
    errors: List[str] = []
    if allowlist_path:
        violations, errors = report.apply_allowlist_file(violations, allowlist_path)
    violations.sort(key=lambda v: (v.pass_id, v.path, v.line))
    return violations, errors


PASS_NAMES = ("session", "lockorder", "native", "stale")
