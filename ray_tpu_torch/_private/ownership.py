"""Per-process ownership table: the owner-side record of truth for objects
this process created.

The reference decentralizes object metadata into the SUBMITTING worker
(PAPER.md L0 core_worker: `reference_count.h`, `task_manager.h` — the
ownership model of the distributed-futures design, Wang et al. NSDI'21)
precisely so control-plane throughput scales with the number of drivers
instead of one head loop. This module is that seam here: every process that
calls `.remote()` / `put()` keeps, for the objects it owns,

 - the resolved ObjectMeta (once known), so a `get()` of a locally-resolved
   object answers IN-PROCESS — no head round trip, no scheduler-thread hop;
 - a pending-task entry from submit until the results resolve, so a `get()`
   of a not-yet-finished owned object parks on a process-local per-key
   waiter instead of a head-side one.

The head keeps scheduling, service discovery, and the name->owner/holder
directory: its object table still sees every seal (it drives dependency
resolution, borrower gets, and lineage), but the OWNER's fast paths never
wait on it. Metas flow owner-ward at seal time: the in-process driver gets a
direct (thread-safe) `deliver()` call from the scheduler loop; remote owners
(client drivers, workers that submitted nested tasks) get batched
``("own_meta", meta)`` frames on their existing control connections.

Failure semantics (see also scheduler._fail_tasks_of_dead_owner): when an
owner process dies, the head seals typed ``OwnerDiedError`` results into the
unresolved return objects of its non-terminal tasks, so a dependent `get()`
raises instead of hanging, and lineage reconstruction of a dead owner's
objects refuses to re-execute (`OwnerDiedError`) — re-running a task whose
record-of-truth is gone would produce results nobody accounts for.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

# Sentinel for "owned, result not yet resolved" entries.
_PENDING = object()


class _Waiter:
    """One parked get(): counts down as its pending keys resolve; the event
    fires on zero. Mutated only under the owning table's lock."""

    __slots__ = ("remaining", "event")

    def __init__(self, remaining: int):
        self.remaining = remaining
        self.event = threading.Event()

    def key_resolved(self) -> None:
        self.remaining -= 1
        if self.remaining <= 0:
            self.event.set()


class OwnershipTable:
    """Thread-safe owner-side object table for one process.

    Writers: the submitting thread (`expect`), the delivery path (`deliver` —
    scheduler loop in-process, reader thread for remote owners), and the ref
    tracker's release path (`forget`). Readers: any API thread inside get()/
    wait(). One lock + condition; waiters only block when an owned object is
    still pending, and deliveries only notify while someone waits.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # object id bytes -> ObjectMeta | _PENDING
        self._entries: Dict[bytes, Any] = {}
        # Per-key parked getters: key -> [_Waiter]. Indexed (not a broadcast
        # condition) so a delivery wakes exactly the getters whose LAST key
        # resolved — a condition + full rescan per delivery is O(N^2) for a
        # get() of N pending refs.
        self._key_waiters: Dict[bytes, List["_Waiter"]] = {}

    # ------------------------------------------------------------- submit side
    def expect(self, keys: List[bytes]) -> None:
        """Mark return objects of a just-submitted owned task as pending.
        Called BEFORE the submit reaches the control plane, so a delivery can
        never race an unregistered entry."""
        entries = self._entries
        with self._lock:
            for k in keys:
                if k not in entries:
                    entries[k] = _PENDING

    def expect_one(self, key: bytes) -> None:
        with self._lock:
            if key not in self._entries:
                self._entries[key] = _PENDING

    # ----------------------------------------------------------- delivery side
    def _notify_locked(self, key: bytes) -> None:
        ws = self._key_waiters.pop(key, None)
        if ws:
            for w in ws:
                w.key_resolved()

    def deliver(self, meta) -> None:
        """Record a resolved meta for an owned object (seal forward from the
        head, or a local put). Idempotent; last write wins (reseal after
        reconstruction updates the location)."""
        key = meta.object_id.binary()
        with self._lock:
            self._entries[key] = meta
            self._notify_locked(key)

    def deliver_owned(self, meta) -> None:
        """Seal forward from the head: only updates EXPECTED entries, so
        metas for objects this process never tracked (stream items it hasn't
        consumed, results whose refs were already dropped) don't accrete."""
        key = meta.object_id.binary()
        with self._lock:
            if key in self._entries:
                self._entries[key] = meta
                self._notify_locked(key)

    def forget(self, key: bytes) -> None:
        """Drop an entry once this process released its last reference."""
        with self._lock:
            self._entries.pop(key, None)
            # A parked getter for a forgotten key can never resolve here:
            # count it down so the waiter wakes and takes the head path.
            self._notify_locked(key)

    # ------------------------------------------------------------ resolve side
    def try_get_all(self, keys: List[bytes]) -> Optional[list]:
        """All metas if every key is resolved locally, else None. Lock-free
        reads (GIL-atomic dict gets): entries only ever go meta -> forgotten,
        and a racing deliver just means the caller takes the slow path."""
        entries = self._entries
        out = []
        for k in keys:
            m = entries.get(k)
            if m is None or m is _PENDING:
                return None
            out.append(m)
        return out

    def get_local(self, key: bytes):
        m = self._entries.get(key)
        return None if m is _PENDING else m

    def covers(self, keys: List[bytes]) -> bool:
        """True when every key is owned by this process (resolved or
        pending), i.e. a get() can be answered entirely owner-side."""
        entries = self._entries
        for k in keys:
            if k not in entries:
                return False
        return True

    def wait_all(self, keys: List[bytes], timeout: Optional[float]) -> Optional[list]:
        """Block until every owned key resolves; None on timeout or when a
        key left the table (forgotten under us — the caller takes the head
        path). Deliveries count the parked waiter down per key, so a get()
        of N pending refs costs O(N), not a rescan per delivery."""
        deadline = None if timeout is None else (_monotonic() + timeout)
        while True:
            waiter = None
            pending_keys = None
            with self._lock:
                out = []
                entries = self._entries
                pending = set()
                for k in keys:
                    m = entries.get(k)
                    if m is None:
                        return None  # forgotten: head path owns the answer
                    if m is _PENDING:
                        pending.add(k)
                    else:
                        out.append(m)
                if not pending:
                    return out
                waiter = _Waiter(len(pending))
                pending_keys = pending
                for k in pending:
                    self._key_waiters.setdefault(k, []).append(waiter)
            remaining = None if deadline is None else deadline - _monotonic()
            if remaining is not None and remaining <= 0:
                fired = False
            else:
                fired = waiter.event.wait(remaining)
            if not fired:
                # Timed out: deregister so deliveries stop counting us down.
                with self._lock:
                    for k in pending_keys:
                        ws = self._key_waiters.get(k)
                        if ws is not None:
                            try:
                                ws.remove(waiter)
                            except ValueError:
                                pass
                            if not ws:
                                del self._key_waiters[k]
                return None
            # Woke with every pending key resolved (or forgotten): loop to
            # re-validate and collect in order.

    # ------------------------------------------------------------------ misc
    def stats(self) -> dict:
        with self._lock:
            resolved = sum(1 for v in self._entries.values() if v is not _PENDING)
            return {
                "entries": len(self._entries),
                "resolved": resolved,
                "pending": len(self._entries) - resolved,
            }

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            # Unblock any parked getters (session teardown).
            for ws in self._key_waiters.values():
                for w in ws:
                    w.event.set()
            self._key_waiters.clear()


from time import monotonic as _monotonic  # noqa: E402 (hot-path local alias)
