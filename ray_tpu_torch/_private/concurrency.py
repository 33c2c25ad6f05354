"""Thread-affinity annotations for the control plane, with optional runtime guards.

The scheduler event loop (`scheduler.py:Scheduler._loop`) owns almost all
scheduler state: command handlers, reader drains, and scheduling run on the
loop thread and mutate tables without locks. That invariant is enforced two
ways, both anchored on the decorators below:

 - **statically**: `ray_tpu.devtools.lint` (the affinity pass) verifies that
   `@any_thread` code never calls into `@loop_thread_only` code and that
   instance state mutated from both affinities is lock-protected;
 - **at runtime**: with ``RAY_TPU_TORCH_DEBUG_INVARIANTS=1`` in the environment,
   `@loop_thread_only` asserts the caller IS the owner's registered loop
   thread and `@lock_guarded` asserts the named lock is held. Used under
   tests; when the env var is off (the default) every decorator returns the
   function unchanged — zero per-call overhead by construction.

Ownership convention: a `@loop_thread_only` method's ``self`` exposes the
loop thread's ident as ``_loop_tid`` (None until the loop starts, which
skips the check — e.g. command handlers invoked before `start()`).
"""

from __future__ import annotations

import functools
import os
import threading


def _env_enabled() -> bool:
    return os.environ.get("RAY_TPU_TORCH_DEBUG_INVARIANTS", "0").lower() not in (
        "", "0", "false", "no", "off",
    )


# Read once at import: worker processes inherit the driver's environment, so
# one setting covers the whole cluster. Decoration happens at class-definition
# time, which keeps the off path literally free (no wrapper frame, no branch).
DEBUG_INVARIANTS = _env_enabled()


def loop_thread_only(fn):
    """Marks a method as callable only on its owner's event-loop thread.

    The owner object must carry the loop thread ident in ``_loop_tid``
    (scheduler convention). Checked statically by rt-lint; asserted at call
    time under RAY_TPU_TORCH_DEBUG_INVARIANTS=1."""
    if not DEBUG_INVARIANTS:
        return fn

    @functools.wraps(fn)
    def guard(self, *args, **kwargs):
        tid = getattr(self, "_loop_tid", None)
        if tid is not None and threading.get_ident() != tid:
            raise AssertionError(
                f"{fn.__qualname__} is @loop_thread_only but was called from "
                f"thread {threading.current_thread().name!r} "
                f"(ident {threading.get_ident()}, loop ident {tid})"
            )
        return fn(self, *args, **kwargs)

    return guard


def any_thread(fn):
    """Marks a method as safe to call from any thread (its own locking is
    the caller's contract). Pure annotation: the static pass uses it to
    verify any-thread code never calls into loop-thread-only code."""
    return fn


def lock_guarded(lock_attr: str):
    """Marks a method as requiring ``self.<lock_attr>`` to be held on entry
    (e.g. BatchedSender._flush_locked). Under RAY_TPU_TORCH_DEBUG_INVARIANTS=1 the
    guard asserts ``locked()`` — held by *some* thread, which is the cheap
    debug approximation of "held by me" for plain (non-reentrant) locks."""

    def deco(fn):
        if not DEBUG_INVARIANTS:
            return fn

        @functools.wraps(fn)
        def guard(self, *args, **kwargs):
            lock = getattr(self, lock_attr)
            if not lock.locked():
                raise AssertionError(
                    f"{fn.__qualname__} is @lock_guarded({lock_attr!r}) but "
                    f"the lock is not held"
                )
            return fn(self, *args, **kwargs)

        return guard

    return deco
