"""Runtime session-conformance monitor, compiled from protocol.SESSION_SPEC.

The static session pass (ray_tpu.devtools.verify, pass `session`) proves
every sender SITE speaks its role; this module checks the part only a live
system exhibits: per-connection state. Armed by ``RAY_TPU_TORCH_DEBUG_INVARIANTS=1``
(the same switch as the thread-affinity guards — one flag arms every debug
invariant), it flags out-of-state frames:

 - a tag arriving at a dispatch loop the grammar does not route it to
   (``check_tag``);
 - a token-paired reply (resp / stacks_data / profile_data /
   object_locations / object_data) whose token was never requested — late
   replies for recently-expired tokens are tolerated via a bounded
   recently-forgotten set, so timeout races don't flap (``expect`` /
   ``resolve`` / ``forget``);
 - a streaming frame out of sequence: ``transfer_chunk``/``transfer_end``
   for a stream id the endpoint never saw opened, or a duplicate
   ``transfer_begin`` for an active one (``stream()`` per endpoint). Late
   data frames for a CLOSED stream stay legal — chunks/acks drain in
   flight after cancel/end by design.

Zero overhead when off: every hook site guards on ``session_monitor.ENABLED``
(a module-attribute load and a branch — the failpoints pattern), and the
spec is compiled lazily on first armed use. A violation is recorded in
``violations()`` and raised as AssertionError, so invariants-armed mini-
cluster suites fail loudly on any frame the session machine rejects.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, FrozenSet, List, Optional, Tuple, Union

from ray_tpu_torch._private.concurrency import DEBUG_INVARIANTS

ENABLED = DEBUG_INVARIANTS

_MAX_VIOLATIONS = 256
_MAX_RECENT = 4096

_lock = threading.Lock()
_violations: List[str] = []
_compiled = False
_allowed: Dict[str, FrozenSet[str]] = {}
_reply_to_req: Dict[str, str] = {}
_stream_open: Dict[str, str] = {}    # open tag -> stream name
_stream_data: Dict[str, str] = {}    # data tag -> stream name
_stream_close: Dict[str, str] = {}   # close tag -> stream name
_MAX_PENDING = 65536
_pending_tokens: "OrderedDict[Tuple[str, object], None]" = OrderedDict()
_recent_tokens: "OrderedDict[Tuple[str, object], None]" = OrderedDict()


def _compile() -> None:
    global _compiled
    if _compiled:
        return
    from ray_tpu_torch._private.protocol import MESSAGE_GRAMMAR, SESSION_SPEC

    with _lock:
        if _compiled:
            return
        for tag, spec in MESSAGE_GRAMMAR.items():
            for reader in spec.get("readers", ()):
                cur = _allowed.get(reader)
                _allowed[reader] = (cur | {tag}) if cur else frozenset({tag})
        for req_tag, pair in SESSION_SPEC.get("pairs", {}).items():
            _reply_to_req[pair["reply"]] = req_tag
        for name, st in SESSION_SPEC.get("streams", {}).items():
            _stream_open[st["open"]] = name
            for t in st.get("data", ()):
                _stream_data[t] = name
            for t in st.get("close", ()):
                _stream_close[t] = name
        _compiled = True


def violations() -> List[str]:
    with _lock:
        return list(_violations)


def reset() -> None:
    with _lock:
        _violations.clear()
        _pending_tokens.clear()
        _recent_tokens.clear()


def _flag(msg: str) -> None:
    with _lock:
        if len(_violations) < _MAX_VIOLATIONS:
            _violations.append(msg)
    raise AssertionError(f"session-machine violation: {msg}")


# ------------------------------------------------------------- tag routing
def check_tag(dispatcher: Union[str, Tuple[str, ...]], tag: str) -> None:
    """Flag a frame arriving at a dispatch loop MESSAGE_GRAMMAR does not
    route it to. `dispatcher` may be a tuple when one physical loop serves
    several dispatcher keys (a remote driver's WorkerConnection routes both
    worker.dispatch and driver.misc tags)."""
    if not _compiled:
        _compile()
    keys = (dispatcher,) if isinstance(dispatcher, str) else dispatcher
    for key in keys:
        allowed = _allowed.get(key)
        if allowed is not None and tag in allowed:
            return
    _flag(f"tag {tag!r} is not routed to dispatcher {dispatcher!r} "
          f"by MESSAGE_GRAMMAR")


# ---------------------------------------------------------- token pairing
def expect(req_tag: str, token) -> None:
    """Record an outstanding request token (call at the send site). Bounded:
    requests abandoned without forget() (a dead peer's) age out oldest-first
    into the tolerated set rather than growing without bound."""
    if not _compiled:
        _compile()
    with _lock:
        _pending_tokens[(req_tag, token)] = None
        while len(_pending_tokens) > _MAX_PENDING:
            aged = _pending_tokens.popitem(last=False)[0]
            _recent_tokens[aged] = None
        while len(_recent_tokens) > _MAX_RECENT:
            _recent_tokens.popitem(last=False)


def forget(req_tag: str, token) -> None:
    """Retire a token (timeout/GC): later replies are tolerated, not
    flagged — the requester gave up, the peer didn't misbehave."""
    with _lock:
        _pending_tokens.pop((req_tag, token), None)
        _recent_tokens[(req_tag, token)] = None
        while len(_recent_tokens) > _MAX_RECENT:
            _recent_tokens.popitem(last=False)


def resolve(reply_tag: str, token) -> None:
    """Validate an arriving reply's token against the outstanding set
    (auto-retires it: a second reply for the same token is tolerated as
    recently-forgotten, e.g. a worker answering both in-band and OOB)."""
    if not _compiled:
        _compile()
    req_tag = _reply_to_req.get(reply_tag)
    if req_tag is None:
        return
    key = (req_tag, token)
    with _lock:
        if key in _pending_tokens:
            del _pending_tokens[key]
            _recent_tokens[key] = None
            while len(_recent_tokens) > _MAX_RECENT:
                _recent_tokens.popitem(last=False)
            return
        if key in _recent_tokens:
            return
    _flag(f"reply {reply_tag!r} carries token {token!r} that was never "
          f"requested via {req_tag!r}")


# ------------------------------------------------------------- streaming
class StreamMonitor:
    """Per-endpoint stream state: one instance per _PeerConnection /
    PushEndpoint (single connection, so keys cannot collide across peers).
    Locked: the pull side notes opens from `@any_thread` begin() callers
    while its reader thread notes chunks/ends on the same monitor."""

    __slots__ = ("_active", "_seen", "_mu")

    def __init__(self) -> None:
        self._active: Dict[object, None] = {}
        self._seen: "OrderedDict[object, None]" = OrderedDict()
        self._mu = threading.Lock()

    def note(self, tag: str, key) -> None:
        if not _compiled:
            _compile()
        msg = None
        with self._mu:
            if tag in _stream_open:
                if key in self._active:
                    msg = (f"{tag!r} re-opens stream key {key!r} that is "
                           f"already active on this connection")
                else:
                    self._active[key] = None
                    self._seen[key] = None
                    # Trim CLOSED streams oldest-first; an ACTIVE key must
                    # never age out (a slow pull outliving 4096 newer
                    # transfers would otherwise see its own legal chunks
                    # flagged "never opened"). Bounded scan: if everything
                    # is active, tolerate temporary overshoot instead.
                    scanned = 0
                    while len(self._seen) > _MAX_RECENT and scanned < _MAX_RECENT:
                        old = next(iter(self._seen))
                        del self._seen[old]
                        scanned += 1
                        if old in self._active:
                            self._seen[old] = None  # re-add newest, keep it
            elif tag in _stream_close:
                if key not in self._seen:
                    msg = (f"{tag!r} closes stream key {key!r} that was "
                           f"never opened on this connection")
                else:
                    self._active.pop(key, None)
            elif tag in _stream_data:
                if key not in self._seen:
                    msg = (f"{tag!r} carries stream key {key!r} that was "
                           f"never opened on this connection")
        if msg is not None:
            _flag(msg)


def stream() -> Optional[StreamMonitor]:
    """A per-endpoint stream monitor, or None when the monitor is off —
    callers keep the None and skip their note() calls for free."""
    return StreamMonitor() if ENABLED else None
