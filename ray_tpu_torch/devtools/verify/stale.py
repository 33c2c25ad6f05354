"""Stale-binary guard: checked-in native binaries must match their source.

A built `.so` committed next to its source gives a fast cold start (no
compile on first import), but nothing else detects drift: edit the .c, ship
the old .so, and every toolchain-less host silently runs the previous
decoder. The port commits none (its loader builds into `_build/` and
rebuilds on a stamp mismatch); this pass checks `_native/` for one that is.
The build flow stamps each binary with the sha256 of the source it was
built from (`-D*_SRC_SHA256`, exported as a greppable
``RAY_TPU_TORCH_*_SRC_SHA256=<hex>`` marker string); this pass re-hashes the
source and compares — pure file reads, no dlopen, no runtime import.

A missing binary is NOT a violation (they build on demand); a binary
without a stamp is (it predates the guard — rebuild it), and a stamp
mismatch is the exact failure this exists for.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

# The marker constants and the scan/hash helpers are the loader's own
# (ray_tpu_torch._native defines the stamp format and self-heals on mismatch);
# importing them keeps the format in exactly ONE place. The import loads no
# .so — builds happen only inside load_arena_lib/load_wire_module.
from ray_tpu_torch._native import (
    ARENA_HASH_MARKER, WIRE_HASH_MARKER, embedded_source_hash, source_sha256,
)
from ray_tpu_torch.devtools.astutil import Violation, make_key
from ray_tpu_torch.devtools.verify import DEFAULT_NATIVE_DIR

# binary -> (source, embedded marker prefix).
BINARIES: Dict[str, Tuple[str, bytes]] = {
    "wire_native.so": ("wire_native.c", WIRE_HASH_MARKER),
    "libshm_arena.so": ("shm_arena.cpp", ARENA_HASH_MARKER),
}


def run(pkg=None, native_dir: Optional[str] = None) -> List[Violation]:
    """`pkg` accepted (ignored) for pass-signature uniformity."""
    d = native_dir or DEFAULT_NATIVE_DIR
    violations: List[Violation] = []
    for so_name, (src_name, marker) in sorted(BINARIES.items()):
        so_path = os.path.join(d, so_name)
        src_path = os.path.join(d, src_name)
        if not os.path.exists(so_path) or not os.path.exists(src_path):
            continue  # binaries build on demand; nothing checked in to drift
        src_hash = source_sha256(src_path)
        got = embedded_source_hash(so_path, marker)
        if got is None:
            violations.append(Violation(
                "stale", so_path, 0,
                make_key("stale", so_path, "unstamped"),
                f"{so_name} carries no {marker.decode()!r} source stamp — "
                f"it predates the stale-binary guard; rebuild and recommit",
            ))
        elif got != src_hash:
            violations.append(Violation(
                "stale", so_path, 0,
                make_key("stale", so_path, "drift"),
                f"{so_name} was built from source {got[:12]}… but "
                f"{src_name} now hashes {src_hash[:12]}… — the checked-in "
                f"binary is stale; rebuild and recommit",
            ))
    return violations
