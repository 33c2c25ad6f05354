"""Live process introspection: all-thread stack capture, out-of-band
faulthandler dumps, and object-store directory scans.

The reference answers "what is my cluster doing RIGHT NOW" with `ray stack`
(py-spy over every worker process) and `ray memory` (the C++ ownership
tables). This build keeps the same two surfaces without external tooling:

 - **In-band stacks** (`thread_stacks`): `sys._current_frames()` formatted
   per thread, served by each process's reader/dispatch thread on a
   ("dump_stacks", token) request — works whenever the process can still
   schedule Python on that thread, i.e. for everything short of a wedged or
   stopped interpreter.
 - **Out-of-band stacks** (`register_oob_dump` / `oob_dump_worker`): a
   SIGUSR1-registered `faulthandler` dump to a per-worker stack file.
   faulthandler's handler is async-signal-safe C that walks thread states
   WITHOUT taking the GIL, so a worker spinning in a C extension or holding
   the GIL in a long compile still produces a dump; the daemon (or the head,
   for head-local workers) signals, waits a beat, and tails the file back.
   A SIGSTOP'd process can't even run the C handler — that case is reported
   as "unavailable" with the reason, which is itself the diagnosis.
 - **Store scans** (`scan_store_dir`): join the on-disk segment files
   against the scheduler's object table so `memory_summary()` can flag
   bytes nothing will ever free (e.g. results a worker stored right before
   it crashed, whose done message never arrived).

Every helper here runs off the scheduler loop thread or is metadata-cheap;
nothing in this module touches the task hot path.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

# Frames deeper than this are truncated (runaway recursion must not turn a
# stack dump into a megabyte payload per thread).
MAX_FRAMES = 64


def thread_stacks(extra: Optional[Dict[str, Any]] = None,
                  executing: Optional[Dict[int, str]] = None,
                  lookup_lines: bool = True) -> Dict[str, Any]:
    """All-thread stack payload for this process. `executing` maps thread
    idents to the task/actor-method name running there (worker runtimes keep
    this map current), so each thread is annotated with the work it is doing
    — the correlation `ray stack` gets from the raylet's task table.

    `lookup_lines=False` skips the linecache source reads (file I/O!) that
    extract_stack otherwise does per frame — required when the caller IS the
    scheduler loop thread (the head's self-dump): file:line:function still
    renders, only the source-text line is omitted."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    threads: List[Dict[str, Any]] = []
    for tid, frame in frames.items():
        t = by_ident.get(tid)
        # extract_stack(frame, limit) without the forced line lookup: walk
        # newest-first, then reverse to the oldest-first display order.
        stack = traceback.StackSummary.extract(
            traceback.walk_stack(frame), limit=MAX_FRAMES,
            lookup_lines=lookup_lines,
        )
        stack.reverse()
        threads.append(
            {
                "thread_id": tid,
                "name": t.name if t is not None else f"thread-{tid}",
                "daemon": bool(t.daemon) if t is not None else None,
                "task": (executing or {}).get(tid),
                "stack": "".join(traceback.format_list(stack)),
                # Leaf-first frame summaries for programmatic matching
                # ("which function is this thread in?") without parsing the
                # formatted text.
                "frames": [
                    f"{fr.name} ({os.path.basename(fr.filename)}:{fr.lineno})"
                    for fr in reversed(stack)
                ],
            }
        )
    payload: Dict[str, Any] = {
        "pid": os.getpid(),
        "transport": "inband",
        "captured_at": time.time(),
        "threads": threads,
    }
    if extra:
        payload.update(extra)
    return payload


# ------------------------------------------------------------- out-of-band
def stack_file_path(shm_dir: str, worker_id_hex: str) -> str:
    """Per-worker faulthandler dump file. Lives INSIDE the node's store dir
    (which both the worker and its managing daemon / the head can reach on a
    shared filesystem) under a subdirectory, so store scans skip it."""
    return os.path.join(shm_dir, "stacks", worker_id_hex + ".stack")


_oob_file = None  # kept open for the process lifetime; faulthandler holds the fd


def register_oob_dump(path: str) -> bool:
    """Register SIGUSR1 -> faulthandler.dump_traceback(all_threads=True) into
    `path`. Called once at worker startup; the open file object must outlive
    the registration (faulthandler writes the raw fd from the signal
    handler). O_APPEND writes compose with the reader-side truncate-before-
    signal protocol in `oob_dump_worker`."""
    global _oob_file
    import faulthandler

    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _oob_file = open(path, "a")
        faulthandler.register(signal.SIGUSR1, file=_oob_file, all_threads=True)
        return True
    except (OSError, ValueError, AttributeError):
        # No faulthandler/signal on this platform: in-band only. Remove any
        # half-created file — its EXISTENCE is the signal-is-safe contract
        # oob_dump_worker checks before sending SIGUSR1.
        try:
            os.unlink(path)
        except OSError:
            pass
        return False


def oob_dump_worker(pid: int, path: str, settle_s: float = 0.4) -> Dict[str, Any]:
    """Signal SIGUSR1 at `pid` and tail back the faulthandler dump from
    `path`. Runs on a helper thread (daemon command thread / head-side dump
    thread), never on the scheduler loop — it sleeps while the handler
    writes."""
    if not os.path.exists(path):
        # The worker never registered a handler (register_oob_dump failed or
        # predates this feature): SIGUSR1's DEFAULT disposition terminates
        # the process — never send it unhandled.
        return {
            "transport": "unavailable", "pid": pid,
            "error": "worker registered no faulthandler dump file; "
                     "not signaling (unhandled SIGUSR1 would kill it)",
        }
    try:
        with open(path, "r+") as f:
            f.truncate(0)  # O_APPEND writers land at the new end: offset 0
    except OSError:
        pass  # raced a concurrent dump; the stale-content risk is benign
    try:
        os.kill(pid, signal.SIGUSR1)
    except (ProcessLookupError, PermissionError, OSError) as e:
        return {"transport": "unavailable", "pid": pid,
                "error": f"signal failed: {e!r}"}
    time.sleep(settle_s)
    try:
        with open(path) as f:
            raw = f.read()
    except OSError as e:
        return {"transport": "unavailable", "pid": pid,
                "error": f"dump file unreadable: {e!r}"}
    if not raw.strip():
        return {
            "transport": "unavailable", "pid": pid,
            "error": "faulthandler wrote nothing within "
                     f"{settle_s}s (process SIGSTOP'd or not scheduling)",
        }
    return {"transport": "oob", "pid": pid, "raw": raw,
            "captured_at": time.time()}


# ------------------------------------------------------------- store scans
def scan_store_dir(shm_dir: str, known_segments, known_oids) -> Dict[str, Any]:
    """Join the on-disk segment files of one store dir against the object
    table. `known_segments` = basenames of segment paths some live meta
    references (real, accounted bytes); `known_oids` = hex ids of every
    object in the table. Files in neither set are **orphans** (bytes with no
    table entry at all — e.g. results stored by a worker that crashed before
    its done message); files named for a table oid whose meta does NOT
    reference them are **stale copies** (error-overwritten results, leftover
    pull caches). Both classes are leaked: nothing will ever free them.

    Metadata-only (scandir + stat on tmpfs): cheap enough for the scheduler
    loop thread."""
    out: Dict[str, Any] = {
        "dir": shm_dir, "files": 0, "file_bytes": 0,
        "arena_file_bytes": None, "leaked": [], "leaked_bytes": 0,
    }
    try:
        entries = list(os.scandir(shm_dir))
    except OSError as e:
        out["error"] = repr(e)
        return out
    from ray_tpu_torch._private.object_store import ARENA_FILENAME

    for ent in entries:
        try:
            if not ent.is_file(follow_symlinks=False):
                continue
            name = ent.name
            if name.endswith((".ready", ".init")) or ".tmp." in name:
                continue  # arena handshake / in-flight writes
            size = ent.stat(follow_symlinks=False).st_size
        except OSError:
            continue  # freed under the scan
        if name == ARENA_FILENAME:
            out["arena_file_bytes"] = size
            continue
        out["files"] += 1
        out["file_bytes"] += size
        if name in known_segments:
            continue
        kind = "stale-copy" if name in known_oids else "orphan"
        out["leaked"].append(
            {"path": os.path.join(shm_dir, name), "bytes": size, "kind": kind}
        )
        out["leaked_bytes"] += size
    return out
