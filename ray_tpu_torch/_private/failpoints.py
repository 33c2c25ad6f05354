"""Failpoints: named, seeded, deterministic fault injection at the protocol seam.

The runtime has recovery *mechanisms* (task retries, actor restarts, lineage
reconstruction, daemon rejoin) but until this module the only way to exercise
them was SIGKILLing whole processes — partial failures (a frame dropped on a
live socket, a crash between ``exec_end`` and ``result_stored``, a lost arena
segment under a reader) went untested. FoundationDB's simulation testing and
the ownership paper (Wang et al., NSDI '21) make the same argument: recovery
code not driven through seeded, repeatable fault schedules is recovery code
that does not work.

Design (same zero-overhead-when-off pattern as ``RAY_TPU_TORCH_DEBUG_INVARIANTS``):

 - every hook site guards with ``if failpoints.ENABLED:`` — a module-attribute
   load and a branch when nothing is armed, nothing else;
 - each failpoint is addressable by NAME (the table lives in COMPONENTS.md
   "Robustness" and is lint-checked by ``ray_tpu.devtools`` pass
   ``failpoints``) with a deterministic trigger spec: ``once`` (first hit),
   ``always``, ``nth:N`` (every Nth hit), ``prob:P:SEED`` (seeded per-name
   RNG, so the fire/skip decision sequence replays exactly for the same hit
   sequence);
 - the per-process injection trace (``trace()``: ``(name, hit_index)`` per
   fire) is the replay contract chaos tests assert on.

Configuration:

 - env ``RAY_TPU_TORCH_FAILPOINTS="name=kind[:arg][@trigger];..."`` — parsed at
   import, so spawned workers/daemons inherit the schedule;
 - programmatic ``arm()/disarm()/reset()`` for driver-side schedules.

Action kinds are interpreted by the hook site (the registry only decides
WHETHER a site fires): ``drop`` / ``dup`` / ``delay`` / ``close`` / ``error``
for wire frames, ``crash`` / ``error`` / ``delay`` for worker execution
stages, ``lose`` for object segments, ``error`` for scheduler handlers.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

KINDS = ("drop", "dup", "delay", "close", "error", "crash", "lose")
TRIGGERS = ("once", "always", "nth", "prob")


class FailpointInjected(Exception):
    """Raised at a failpoint armed with the ``error`` action: a typed,
    addressable injected fault (never a bare RuntimeError)."""


class Fired:
    """What a hook site gets back from a firing failpoint."""

    __slots__ = ("name", "kind", "arg")

    def __init__(self, name: str, kind: str, arg: Optional[float]):
        self.name = name
        self.kind = kind
        self.arg = arg

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Fired({self.name}={self.kind}:{self.arg})"


class _Spec:
    __slots__ = ("name", "kind", "arg", "trigger", "n", "p", "rng", "hits", "fires")

    def __init__(self, name: str, kind: str, arg: Optional[float], trigger: str,
                 nth: int, prob: float, seed: int):
        if kind not in KINDS:
            raise ValueError(f"unknown failpoint action {kind!r} (one of {KINDS})")
        if trigger not in TRIGGERS:
            raise ValueError(f"unknown failpoint trigger {trigger!r} (one of {TRIGGERS})")
        self.name = name
        self.kind = kind
        self.arg = arg
        self.trigger = trigger
        self.n = max(1, int(nth))
        self.p = float(prob)
        # Dedicated seeded RNG per failpoint: the fire/skip decision sequence
        # is a pure function of (seed, hit index) — chaos runs replay.
        self.rng = random.Random(seed)
        self.hits = 0
        self.fires = 0

    def _should_fire(self) -> bool:
        # Caller holds _lock.
        self.hits += 1
        if self.trigger == "once":
            return self.fires == 0
        if self.trigger == "always":
            return True
        if self.trigger == "nth":
            return self.hits % self.n == 0
        return self.rng.random() < self.p  # prob


_lock = threading.Lock()
_registry: Dict[str, _Spec] = {}
_trace: List[Tuple[str, int]] = []

# Hook-site fast-path guard: True iff at least one failpoint is armed in this
# process. Sites read this module attribute and branch — when False the whole
# machinery costs one attribute load per site.
ENABLED = False


def _refresh_enabled() -> None:
    global ENABLED
    ENABLED = bool(_registry)


def arm(name: str, kind: str, arg: Optional[float] = None, *,
        trigger: str = "once", nth: int = 1, prob: float = 0.0,
        seed: int = 0) -> None:
    """Arm (or re-arm, resetting counters) one named failpoint."""
    with _lock:
        _registry[name] = _Spec(name, kind, arg, trigger, nth, prob, seed)
        _refresh_enabled()


def disarm(name: str) -> None:
    with _lock:
        _registry.pop(name, None)
        _refresh_enabled()


def reset() -> None:
    """Disarm everything and clear the injection trace (test isolation)."""
    with _lock:
        _registry.clear()
        del _trace[:]
        _refresh_enabled()


def armed() -> List[str]:
    with _lock:
        return sorted(_registry)


def trace() -> List[Tuple[str, int]]:
    """This process's injection trace: ``(name, hit_index)`` per fire, in
    order. With the same schedule (same seeds) and the same hit sequence,
    two runs produce identical traces — the determinism contract."""
    with _lock:
        return list(_trace)


def fire(name: str) -> Optional[Fired]:
    """One hit on failpoint `name`; returns a Fired action when it triggers,
    None otherwise (including when nothing by that name is armed). Pure
    bookkeeping — no sleeping or raising here (the scheduler loop calls this
    directly; blocking belongs to the site helpers below)."""
    with _lock:
        spec = _registry.get(name)
        if spec is None or not spec._should_fire():
            return None
        spec.fires += 1
        _trace.append((name, spec.hits))
        return Fired(name, spec.kind, spec.arg)


# ------------------------------------------------------------------ env spec
def parse_and_arm(specs: str) -> None:
    """Arm from an env-style schedule: ``name=kind[:arg][@trigger];...``
    where trigger is ``once`` | ``always`` | ``nth:N`` | ``prob:P:SEED``.
    Examples::

        conn.send=drop@prob:0.1:42
        worker.crash_after_exec_end=crash@once
        batch.flush=delay:0.02@nth:5
    """
    for part in specs.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, rhs = part.partition("=")
        action, _, trig = rhs.partition("@")
        kind, _, arg_s = action.partition(":")
        arg = float(arg_s) if arg_s else None
        trigger, nth, prob, seed = "once", 1, 0.0, 0
        if trig:
            fields = trig.split(":")
            trigger = fields[0]
            if trigger == "nth":
                nth = int(fields[1])
            elif trigger == "prob":
                prob = float(fields[1])
                seed = int(fields[2]) if len(fields) > 2 else 0
        arm(name.strip(), kind.strip(), arg, trigger=trigger, nth=nth,
            prob=prob, seed=seed)


_env_spec = os.environ.get("RAY_TPU_TORCH_FAILPOINTS", "")
if _env_spec:
    # Workers and daemons inherit the driver's environment at spawn, so one
    # schedule covers the whole cluster deterministically.
    parse_and_arm(_env_spec)


# ------------------------------------------------------------- site helpers
def maybe_crash(name: str) -> None:
    """Worker execution-stage hook: ``crash`` hard-kills the process (the
    partial-failure the done/retry machinery must absorb), ``error`` raises
    the typed FailpointInjected (surfaces through the task-error path),
    ``delay`` stalls the stage."""
    fp = fire(name)
    if fp is None:
        return
    if fp.kind == "crash":
        os._exit(1)
    if fp.kind == "delay":
        time.sleep(fp.arg if fp.arg is not None else 0.02)
        return
    raise FailpointInjected(f"failpoint {name} fired ({fp.kind})")


def inject_handle_send(name: str) -> Optional[bool]:
    """Head-side handle-send injection (scheduler loop calls this, so no
    sleeping/raising here — rt-lint's blocking pass guards that thread).
    None = proceed with the real send; True = pretend the send succeeded
    (silent blackhole, the partition simulation); False = report a send
    failure (the dead-connection death path runs)."""
    fp = fire(name)
    if fp is None:
        return None
    if fp.kind == "drop":
        return True
    if fp.kind == "error":
        return False
    return None


def inject_send(name: str, write: Callable[[bytes], None], data: bytes,
                close_fn: Optional[Callable[[], None]] = None) -> bool:
    """Wire-frame injection for client-side senders (BatchedSender). Returns
    True when the failpoint consumed the write (caller must NOT write);
    ``dup`` writes one extra copy here and lets the caller write the second;
    ``close``/``error`` raise OSError so the caller's dead-connection path
    runs (close additionally closes the connection, so the peer sees a real
    EOF mid-stream — the half-open case)."""
    fp = fire(name)
    if fp is None:
        return False
    if fp.kind == "drop":
        return True
    if fp.kind == "dup":
        write(data)
        return False
    if fp.kind == "delay":
        time.sleep(fp.arg if fp.arg is not None else 0.02)
        return False
    if fp.kind == "close":
        if close_fn is not None:
            try:
                close_fn()
            except OSError:
                pass
        raise OSError(f"failpoint {name}: connection abruptly closed")
    if fp.kind == "error":
        raise OSError(f"failpoint {name}: injected send error")
    return False


def inject_recv(name: str, close_fn: Optional[Callable[[], None]] = None) -> str:
    """Reader-side injection: returns "pass" (deliver the frame) or "drop"
    (discard it); ``close`` hard-closes the connection (both ends see EOF)
    and raises OSError so the reader's EOF path runs; ``error`` raises
    OSError outright."""
    fp = fire(name)
    if fp is None:
        return "pass"
    if fp.kind == "drop":
        return "drop"
    if fp.kind == "delay":
        time.sleep(fp.arg if fp.arg is not None else 0.02)
        return "pass"
    if fp.kind == "close":
        if close_fn is not None:
            try:
                close_fn()
            except OSError:
                pass
        raise OSError(f"failpoint {name}: connection abruptly closed")
    raise OSError(f"failpoint {name}: injected recv error")
