"""Peer-to-peer object data plane: direct node↔node chunked segment transfers.

Until this module, every cross-node object byte relayed through the head
(`scheduler._pull_object` → daemon ``read_object`` → head → reader), so one
Python process capped the cluster's aggregate transfer bandwidth. The
reference solves this at L0 with a dedicated per-node `ObjectManager`
(`src/ray/object_manager/object_manager.cc`: push/pull with
`pull_manager.h` / `push_manager.h` priorities and fixed-size chunked
transfers) where the control plane answers *location* queries only and nodes
stream data to each other directly. This is that layer:

 - **PullManager** (one per reader process): bounded in-flight pulls
   (``transfer_max_inflight_pulls``) drained in priority order (task-args >
   explicit get > prefetch), dedup of concurrent pulls for the same key
   (N readers of one object share one transfer), cancel/retry when the
   sending node dies mid-stream (remaining replicas are tried, then the
   caller falls back to the head relay / lineage reconstruction).
 - **PushManager** (one per node daemon + one in the head for its local
   store): a data listener serving ``transfer_begin``; chunks stream
   straight out of the shm arena via ``read_segment``-style slice reads (no
   whole-object materialization), backpressured by a bounded
   outstanding-chunk window (``transfer_window_chunks``) refilled by
   ``transfer_ack``.
 - The head shrinks to a location directory: readers resolve
   ``locate_object`` → ``object_locations`` (owner + replica addresses) over
   their control connection, then dial the owning node's data address with a
   lazily-established, reused peer connection (puller→pusher control rides a
   BatchedSender, so acks coalesce under load).

Wire grammar (registered in protocol.MESSAGE_GRAMMAR, lint-enforced):
  puller → pusher: ("transfer_begin", req_id, path, offset, length, chunk)
                   ("transfer_ack", req_id, seq)   ("transfer_cancel", req_id)
  pusher → puller: ("transfer_chunk", req_id, seq, nbytes)
                   ("transfer_end", req_id, ok, err_repr)

A ``transfer_chunk`` header frame is immediately followed by one RAW frame
carrying the payload bytes (the pusher is single-threaded per connection, so
the pair can never interleave). Raw framing keeps the payload out of pickle
on both ends — two fewer full-object copies per transfer, worth ~25% of
loopback throughput at 10MB.

Chunks are written into the reader's node-local store cache at
``seq * chunk_bytes`` — reassembly is positional, so duplicated frames are
idempotent and a dropped frame surfaces as a byte-count mismatch at
``transfer_end`` (the transfer fails and the puller retries elsewhere).

Metrics ride the same plain-int pattern as object_store (_STATS bumped on
the hot path, materialized by telemetry.ensure_transfer_metrics).
Failpoints: ``transfer.peer_dial`` (dial error), ``transfer.chunk``
(drop/dup/delay/close/error per chunk frame on the push side).
"""

from __future__ import annotations

import heapq
import os
import queue
import socket as _socket
import threading
import time as _time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import failpoints, lifecycle, serialization, session_monitor
from ray_tpu_torch._private.concurrency import any_thread, lock_guarded


def _tracing_mod():
    # Lazy: the data plane must import without dragging the tracing layer
    # (and its config reads) into worker startup.
    from ray_tpu_torch.util import tracing

    return tracing

# Pull priorities: smaller drains first (reference: pull_manager.h queues
# task-argument pulls ahead of ray.get ahead of wait/prefetch).
PRIORITY_TASK_ARGS = 0
PRIORITY_GET = 1
PRIORITY_PREFETCH = 2


class PullFailed(OSError):
    """Every servable location was tried and the transfer still failed; the
    caller falls back to the head relay (and from there to lineage
    reconstruction)."""


class PullCancelled(PullFailed):
    """The pull was cancelled (explicitly, or its last waiter timed out)."""


# Process-wide data-plane stats, exported as ray_tpu_transfer_* /
# ray_tpu_pull_queue_depth by telemetry.ensure_transfer_metrics. Plain ints
# bumped under the manager lock: the chunk path never touches a Metric.
_STATS = {
    "bytes_in": 0, "bytes_out": 0, "chunks_in": 0, "chunks_out": 0,
    "pulls_started": 0, "pulls_deduped": 0, "pulls_completed": 0,
    "pulls_failed": 0, "pulls_cancelled": 0, "prefetches": 0,
    # Live gauges (inc/dec, not monotonic).
    "queue_depth": 0, "inflight": 0,
}
_stats_installed = False


def _stats_enabled() -> bool:
    global _stats_installed
    try:
        from ray_tpu_torch._private import telemetry

        if not telemetry.metrics_enabled():
            return False
        if not _stats_installed:
            _stats_installed = True
            telemetry.ensure_transfer_metrics()
        return True
    except Exception:  # noqa: BLE001 — stats must never break a transfer
        return False


def _abrupt_close(conn) -> None:
    """shutdown(SHUT_RDWR) on a dup of the connection's fd: the PEER sees a
    real mid-stream EOF (a plain close from a sender thread would leave the
    blocked reader hanging). The failpoint "close" action and dead-peer
    cleanup both use this."""
    try:
        fd = os.dup(conn.fileno())
    except OSError:
        try:
            conn.close()
        except OSError:
            pass
        return
    try:
        s = _socket.socket(fileno=fd)
    except OSError:
        os.close(fd)
        return
    try:
        s.shutdown(_socket.SHUT_RDWR)
    except OSError:
        pass
    finally:
        s.close()
    try:
        conn.close()
    except OSError:
        pass


def _env_authkey() -> Optional[bytes]:
    return bytes.fromhex(os.environ.get("RAY_TPU_TORCH_AUTHKEY_HEX", "")) or None


def set_nodelay(conn) -> None:
    """Disable Nagle on a connection carrying latency-sensitive frames. The
    chunk protocol interleaves small frames (begin/ack) with bulk ones;
    without TCP_NODELAY every small frame after an idle gap sits in the
    kernel until the peer's delayed-ACK timer (~40ms) fires — measured
    204 → 646 MB/s on a loopback 10MB pull. Control connections (req/resp
    roundtrips from TCP drivers/daemons/workers) pay the same stall, so
    their dial/accept sites call this too. No-op for non-TCP transports
    (setsockopt fails, e.g. AF_UNIX)."""
    try:
        s = _socket.socket(fileno=os.dup(conn.fileno()))
    except OSError:
        return
    try:
        s.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
    except OSError:
        pass
    finally:
        s.close()


# --------------------------------------------------------------------------
# locate_object / object_locations plumbing: a tiny token→queue registry so
# any thread can run a blocking batched location query over a control
# connection whose reader routes ("object_locations", token, payload) back
# through deliver_locations. One registry per process (tokens are unique).
# --------------------------------------------------------------------------
_locate_lock = threading.Lock()
_locate_token = 0
_locate_pending: Dict[int, "queue.SimpleQueue"] = {}


@any_thread
def locate_via(send: Callable[[tuple], None], keys: List[bytes],
               timeout: float = 30.0) -> Dict[bytes, tuple]:
    """Batched location query over a control connection speaking the
    locate_object/object_locations tags. Returns {key: (meta, [(node_id,
    address), ...])} for the keys the head knows; unknown keys are absent."""
    global _locate_token
    q: "queue.SimpleQueue" = queue.SimpleQueue()
    with _locate_lock:
        _locate_token += 1
        token = _locate_token
        _locate_pending[token] = q
    if session_monitor.ENABLED:
        session_monitor.expect("locate_object", token)
    try:
        send(("locate_object", token, keys))
        return q.get(timeout=timeout)
    except queue.Empty:
        raise TimeoutError(f"locate_object timed out after {timeout}s") from None
    finally:
        with _locate_lock:
            _locate_pending.pop(token, None)
        if session_monitor.ENABLED:
            session_monitor.forget("locate_object", token)


@any_thread
def deliver_locations(token: int, payload) -> None:
    """Reader-side hook: route an object_locations reply to its waiter."""
    if session_monitor.ENABLED:
        session_monitor.resolve("object_locations", token)
    with _locate_lock:
        q = _locate_pending.get(token)
    if q is not None:
        q.put(payload)


# --------------------------------------------------------------------------
# Pull side
# --------------------------------------------------------------------------
class _PullRequest:
    __slots__ = (
        "key", "meta", "locations", "priority", "state", "event", "error",
        "final_path", "tmp_path", "fh", "conn", "req_id", "got", "received",
        "waiters", "seq",
    )

    def __init__(self, key: bytes, meta, locations, priority: int,
                 final_path: str, seq: int):
        self.key = key
        self.meta = meta
        self.locations = list(locations)  # [(node_id_bytes, "host:port")]
        self.priority = priority
        self.state = "queued"  # queued | inflight | done | failed | cancelled
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self.final_path = final_path
        self.tmp_path: Optional[str] = None
        self.fh = None
        self.conn: Optional["_PeerConnection"] = None
        self.req_id: Optional[int] = None
        self.got: Set[int] = set()
        self.received = 0
        self.waiters = 0
        self.seq = seq  # FIFO tiebreak within a priority class


class _PeerConnection:
    """Pull-side half of one reused peer link: a BatchedSender for
    begin/ack/cancel control frames and a reader thread dispatching the
    pusher's transfer_chunk/transfer_end stream into request state."""

    def __init__(self, manager: "PullManager", address: str, conn):
        from ray_tpu_torch._private.batching import BatchedSender

        self.manager = manager
        self.address = address
        self.conn = conn
        self.sender = BatchedSender(
            conn.send_bytes, close_fn=lambda: _abrupt_close(conn)
        )
        # req_id -> _PullRequest for transfers riding this connection
        # (mutated under the manager lock; read by the reader thread).
        self.active: Dict[int, _PullRequest] = {}
        self._thread: Optional[threading.Thread] = None
        # Session-machine conformance (None unless RAY_TPU_TORCH_DEBUG_INVARIANTS):
        # chunk/end frames must reference a stream this side opened.
        self._smon = session_monitor.stream()

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._reader_loop, daemon=True,
            name=f"transfer-pull-{self.address}",
        )
        self._thread.start()

    @any_thread
    def begin(self, req: _PullRequest, holder_node: bytes) -> None:
        """Register `req` on this connection and ask the pusher to stream.
        Raises OSError on a dead link (caller tries the next location). The
        OWNER serves its segment/arena slice by absolute path; a REPLICA
        holds a plain cache file named by object id in its own store dir, so
        it is asked by store-RELATIVE name (the owner's absolute path means
        nothing — and fails the path jail — on another node)."""
        m = self.manager
        req_id = m._next_req_id()
        tmp = f"{req.final_path}.pull.{os.getpid()}.{req_id}"
        fh = open(tmp, "wb")
        with m._lock:
            req.req_id = req_id
            req.conn = self
            req.tmp_path = tmp
            req.fh = fh
            req.got = set()
            req.received = 0
            self.active[req_id] = req
        meta = req.meta
        if holder_node == meta.node_id:
            path, offset = meta.segment, meta.arena_offset
        else:
            path, offset = meta.object_id.hex(), None
        if self._smon is not None:
            self._smon.note("transfer_begin", req_id)
        try:
            self.sender.send(
                ("transfer_begin", req_id, path, offset,
                 meta.size, m.chunk_bytes)
            )
        except (OSError, ValueError):
            with m._lock:
                self.active.pop(req_id, None)
            _close_discard(fh, tmp)
            raise OSError(f"peer {self.address} is unreachable")

    def _reader_loop(self) -> None:
        try:
            while True:
                msg = serialization.loads(self.conn.recv_bytes())
                kind = msg[0]
                if session_monitor.ENABLED:
                    session_monitor.check_tag("transfer.pull", kind)
                    self._smon.note(kind, msg[1])
                if kind == "transfer_chunk":
                    # Header frame; the payload rides the NEXT frame raw
                    # (never pickled — see the module docstring).
                    _, req_id, seq, _nbytes = msg
                    self._on_chunk(req_id, seq, self.conn.recv_bytes())
                elif kind == "transfer_end":
                    _, req_id, ok, err = msg
                    self._on_end(req_id, ok, err)
        except (EOFError, OSError):
            pass
        finally:
            self.manager._on_peer_dead(self)

    def _on_chunk(self, req_id: int, seq: int, data: bytes) -> None:
        m = self.manager
        with m._lock:
            req = self.active.get(req_id)
            fh = req.fh if req is not None and seq not in req.got else None
            if fh is not None:
                req.got.add(seq)
        if fh is not None:
            # Write OUTSIDE the manager lock: a multi-MB copy must not block
            # unrelated submits/pulls. A concurrent cancel can close fh under
            # us — caught, and _on_end's byte-count check reconciles.
            try:
                fh.seek(seq * m.chunk_bytes)
                fh.write(data)
                with m._lock:
                    req.received += len(data)
                _STATS["chunks_in"] += 1
                _STATS["bytes_in"] += len(data)
            except (OSError, ValueError):
                pass
        # Ack even stale/duplicate frames: the pusher's outstanding window
        # must drain regardless of what the puller kept. Ordered immediate
        # send, NOT send_async: a coalesced ack can sit on the flush timer
        # for tens of ms, and ack latency is exactly what stalls the
        # pusher's window (one tiny frame per >=64KB chunk is cheap).
        try:
            self.sender.send(("transfer_ack", req_id, seq))
        except (OSError, ValueError):
            pass  # link died; the reader's EOF path owns cleanup

    def _on_end(self, req_id: int, ok: bool, err) -> None:
        m = self.manager
        with m._lock:
            req = self.active.pop(req_id, None)
        if req is None:
            return  # cancelled/abandoned transfer
        if ok and req.received == req.meta.size:
            m._complete(req)
        else:
            reason = err if not ok else (
                f"chunk loss: received {req.received} of {req.meta.size} bytes"
            )
            m._retry_or_fail(req, OSError(f"transfer failed: {reason}"))

    def close(self) -> None:
        self.sender.close()
        _abrupt_close(self.conn)


def _close_discard(fh, path: Optional[str]) -> None:
    try:
        if fh is not None:
            fh.close()
    except OSError:
        pass
    if path:
        try:
            os.unlink(path)
        except OSError:
            pass


class PullManager:
    """Reader-process half of the data plane (reference: pull_manager.h):
    priority-ordered admission with a bounded in-flight window, per-key
    dedup, replica failover, and an async prefetch lane."""

    def __init__(self, shm_dir: str, cfg=None, authkey: Optional[bytes] = None):
        if cfg is None:
            from ray_tpu_torch._private.config import get_config

            cfg = get_config()
        self.shm_dir = shm_dir
        self.chunk_bytes = max(16 * 1024, int(cfg.transfer_chunk_bytes))
        self.window = max(1, int(cfg.transfer_window_chunks))
        self.max_inflight = max(1, int(cfg.transfer_max_inflight_pulls))
        self.timeout_s = float(cfg.object_pull_timeout_s)
        self.force_remote = bool(cfg.force_object_pulls)
        self._authkey = authkey if authkey is not None else _env_authkey()
        self._lock = threading.Lock()
        self._reqs: Dict[bytes, _PullRequest] = {}
        self._heap: List[Tuple[int, int, bytes]] = []
        self._seq = 0
        self._req_token = 0
        self._inflight = 0
        self._peers: Dict[str, _PeerConnection] = {}
        # _admit_next drain-loop reentrancy guard (see its docstring).
        self._admitting = False
        self._admit_pending = False
        # Owners that advertised no data server (client drivers): later pulls
        # skip the locate round trip for their objects.
        self.no_peer_nodes: Set[bytes] = set()
        self._closed = False
        # Prefetch lane: (keys, locate_fn) batches drained by one lazy thread
        # so the connection reader never blocks on a locate round trip.
        self._prefetch_q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._prefetch_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- public API
    @any_thread
    def pull(self, meta, locations, priority: int = PRIORITY_GET,
             timeout: Optional[float] = None) -> Optional[str]:
        """Pull `meta`'s bytes into this node's store cache; returns the local
        segment path. None = no location is peer-servable (caller falls back
        to the head relay); PullFailed = every servable location failed.

        When tracing is on, the blocking wait emits a "transfer" span
        parented on the calling thread's context (a task's arg fetch parents
        onto its execute span; a traced get() onto the caller's span), so a
        slow get shows WHICH transfer stalled. Tail-keep eligible: a pull
        breaching trace_keep_latency_s survives head sampling."""
        final_path = os.path.join(self.shm_dir, meta.object_id.hex())
        if os.path.exists(final_path):
            return final_path
        trace_ctx = t0 = None
        if _tracing_mod().is_enabled():
            trace_ctx = _tracing_mod().current_trace_context()
            t0 = _time.time()
        try:
            req, start = self._submit(meta, locations, priority, final_path,
                                      waiters=1)
            if req is None:
                return None
            if start:
                self._start_transfer(req)
            if not req.event.wait(self.timeout_s if timeout is None else timeout):
                self._drop_waiter(req)
                raise PullFailed(
                    f"pull of {meta.object_id.hex()} timed out"
                )
            if req.state == "done":
                self._record_pull_span(meta, priority, trace_ctx, t0, "OK")
                return req.final_path
            raise req.error or PullFailed("pull failed")
        except BaseException:
            self._record_pull_span(meta, priority, trace_ctx, t0, "ERROR")
            raise

    @staticmethod
    def _record_pull_span(meta, priority, trace_ctx, t0, status: str) -> None:
        if t0 is None:
            return
        try:
            _tracing_mod().record_span(
                f"transfer::{meta.object_id.hex()[:8]}", "transfer",
                t0, _time.time(), trace_context=trace_ctx,
                attributes={
                    "object_id": meta.object_id.hex(),
                    "bytes": meta.size,
                    "priority": priority,
                    "source_node": meta.node_id.hex() if meta.node_id else None,
                },
                status=status, tail_keep=True,
            )
        except Exception:  # noqa: BLE001 — a span must never break a pull
            pass

    @any_thread
    def pull_nowait(self, meta, locations,
                    priority: int = PRIORITY_PREFETCH) -> None:
        """Fire-and-forget pull (the prefetch lane): enqueues and returns."""
        final_path = os.path.join(self.shm_dir, meta.object_id.hex())
        if os.path.exists(final_path):
            return
        req, start = self._submit(meta, locations, priority, final_path,
                                  waiters=0)
        if req is not None and start:
            self._start_transfer(req)

    @any_thread
    def cancel(self, key: bytes,
               expect: Optional[_PullRequest] = None) -> bool:
        """Cancel a queued or in-flight pull; its waiters get PullCancelled.
        Used by tests and by owner-death cleanup; queued prefetches for a
        freed object die here instead of wasting a transfer slot. `expect`
        pins the cancel to one request instance: a timed-out waiter's
        deferred cancel must not kill a NEWER pull of the same key that
        slipped in after its own request settled."""
        with self._lock:
            req = self._reqs.get(key)
            if req is None or req.state in ("done", "failed", "cancelled") \
                    or (expect is not None and req is not expect):
                return False
            self._settle_locked(req, "cancelled",
                                PullCancelled(f"pull of {key.hex()} cancelled"))
            if req.conn is not None and req.req_id is not None:
                if req.conn._smon is not None:
                    # Locally-originated close: retire the stream in the
                    # monitor (the peer never echoes a cancel back).
                    req.conn._smon.note("transfer_cancel", req.req_id)
                try:
                    req.conn.sender.send_async(("transfer_cancel", req.req_id))
                except (OSError, ValueError):
                    pass
        self._admit_next()
        return True

    @any_thread
    def prefetch(self, keys_and_metas, locate_fn) -> None:
        """Queue argument metas for background pulling at PREFETCH priority.
        Non-blocking: location queries and admission run on the prefetch
        thread, never on the caller (the connection reader)."""
        wanted = [
            (m.object_id.binary(), m) for m in keys_and_metas
            if m is not None and m.segment is not None
            and m.node_id not in self.no_peer_nodes
            # Same readability rule as resolve_for_read: a segment this
            # process can already open is read in place, so prefetching it
            # would stream bytes we have and leave an orphan duplicate.
            and (self.force_remote or not os.path.exists(m.segment))
            and not os.path.exists(os.path.join(self.shm_dir, m.object_id.hex()))
        ]
        if not wanted or self._closed:
            return
        self._prefetch_q.put((wanted, locate_fn))
        if self._prefetch_thread is None:
            with self._lock:
                if self._prefetch_thread is None:
                    self._prefetch_thread = threading.Thread(
                        target=self._prefetch_loop, daemon=True,
                        name="transfer-prefetch",
                    )
                    self._prefetch_thread.start()

    def close(self) -> None:
        self._closed = True
        with self._lock:
            peers = list(self._peers.values())
            self._peers.clear()
        for pc in peers:
            pc.close()

    # ------------------------------------------------------------ internals
    def _next_req_id(self) -> int:
        with self._lock:
            self._req_token += 1
            return self._req_token

    @any_thread
    def _submit(self, meta, locations, priority: int, final_path: str,
                waiters: int):
        """Register (or join) the pull for meta's key. Returns (req, start):
        req None = nothing servable; start True = caller must kick off the
        transfer (admission slot acquired)."""
        key = meta.object_id.binary()
        usable = [(nid, addr) for nid, addr in (locations or []) if addr]
        with self._lock:
            req = self._reqs.get(key)
            if req is not None:
                # Dedup: N concurrent readers share one transfer. A higher
                # priority re-files the queued entry (lazy heap: stale
                # entries are skipped on pop).
                _STATS["pulls_deduped"] += 1
                req.waiters += waiters
                if priority < req.priority and req.state == "queued":
                    req.priority = priority
                    self._seq += 1
                    heapq.heappush(self._heap, (priority, self._seq, key))
                return req, False
            if not usable:
                # Cache "advertises no data server" (client drivers) — but
                # ONLY off an explicit addr-less entry for the owner: that is
                # a PER-NODE fact. An empty location list is a per-OBJECT
                # transient (owner died, object freed) and must not poison
                # peer pulls of every other object that node owns.
                if meta.node_id and any(
                    nid == meta.node_id and not addr
                    for nid, addr in (locations or [])
                ):
                    self.no_peer_nodes.add(meta.node_id)
                return None, False
            self._seq += 1
            req = _PullRequest(key, meta, usable, priority, final_path, self._seq)
            req.waiters = waiters
            self._reqs[key] = req
            _STATS["pulls_started"] += 1
            if self._inflight < self.max_inflight:
                self._inflight += 1
                _STATS["inflight"] += 1
                req.state = lifecycle.step("transfer", req.state, "inflight")
                return req, True
            heapq.heappush(self._heap, (priority, req.seq, key))
            _STATS["queue_depth"] += 1
            return req, False

    @any_thread
    def _start_transfer(self, req: _PullRequest) -> None:
        """Drive `req` onto the next servable location (dial + begin); on
        exhaustion the request fails and waiters fall back to the relay."""
        while True:
            with self._lock:
                if req.state != "inflight":
                    return
                loc = req.locations.pop(0) if req.locations else None
            if loc is None:
                self._finish_error(req, PullFailed(
                    f"every location for {req.key.hex()} failed"))
                return
            nid, addr = loc
            try:
                pc = self._peer(addr)
                pc.begin(req, nid)
                return
            except Exception:  # noqa: BLE001 — ANY dial/begin failure (refused,
                # AuthenticationError after a head restart, malformed address)
                # means "try the next location", never an error surfaced to the
                # reader: the relay fallback contract requires exhausting peers
                # gracefully.
                self._drop_peer(addr)
                continue

    @any_thread
    def _peer(self, address: str) -> _PeerConnection:
        with self._lock:
            pc = self._peers.get(address)
        if pc is not None:
            return pc
        conn = self._dial(address)
        pc = _PeerConnection(self, address, conn)
        with self._lock:
            cur = self._peers.get(address)
            if cur is not None:
                race_loser = pc
            else:
                self._peers[address] = pc
                race_loser = None
        if race_loser is not None:
            race_loser.close()
            return cur
        pc.start()
        return pc

    @any_thread
    def _dial(self, address: str):
        from multiprocessing.connection import (Connection, answer_challenge,
                                                deliver_challenge)

        if failpoints.ENABLED and failpoints.fire("transfer.peer_dial"):
            raise OSError(f"failpoint transfer.peer_dial: cannot reach {address}")
        host, _, port = address.rpartition(":")
        # Bounded connect (mp's Client blocks for the kernel's full SYN-retry
        # window, minutes, on a silently-dead host — and a dial stall here
        # serializes the admit drain, starving pulls to HEALTHY peers). The
        # auth handshake after accept mirrors mp.connection.Client's.
        s = _socket.create_connection((host, int(port)), timeout=10.0)
        s.settimeout(None)  # Connection does raw fd reads: must be blocking
        conn = Connection(s.detach())
        try:
            if self._authkey is not None:
                answer_challenge(conn, self._authkey)
                deliver_challenge(conn, self._authkey)
        except Exception:
            conn.close()
            raise
        set_nodelay(conn)
        return conn

    @any_thread
    def _drop_peer(self, address: str, pc: Optional[_PeerConnection] = None) -> None:
        with self._lock:
            cur = self._peers.get(address)
            if pc is None or cur is pc:
                self._peers.pop(address, None)

    @any_thread
    def _on_peer_dead(self, pc: _PeerConnection) -> None:
        """The peer link died (pusher crash / abrupt close): re-drive every
        transfer that rode it onto its remaining replicas (the mid-stream
        sender-death failover), else fail to the relay path."""
        self._drop_peer(pc.address, pc)
        with self._lock:
            orphans = list(pc.active.values())
            pc.active.clear()
        for req in orphans:
            self._retry_or_fail(req, ConnectionError(
                f"peer {pc.address} died mid-transfer"))

    @any_thread
    def _retry_or_fail(self, req: _PullRequest, err: BaseException) -> None:
        with self._lock:
            still_inflight = req.state == "inflight"
            fh, tmp = req.fh, req.tmp_path
            req.fh = None
            req.tmp_path = None
            if req.conn is not None and req.req_id is not None:
                req.conn.active.pop(req.req_id, None)
            has_more = bool(req.locations)
        _close_discard(fh, tmp)
        if not still_inflight:
            return
        if has_more:
            self._start_transfer(req)
        else:
            self._finish_error(req, PullFailed(str(err)))

    @lock_guarded("_lock")
    def _settle_locked(self, req: _PullRequest, state: str,
                       err: Optional[BaseException]) -> None:
        """Terminal-state bookkeeping (caller holds the lock): counters,
        request-table removal, waiter wakeup."""
        was_inflight = req.state == "inflight"
        was_queued = req.state == "queued"
        req.state = lifecycle.step("transfer", req.state, state)
        req.error = err
        self._reqs.pop(req.key, None)
        if req.conn is not None and req.req_id is not None:
            req.conn.active.pop(req.req_id, None)
        if was_inflight:
            self._inflight -= 1
            _STATS["inflight"] -= 1
        if was_queued:
            _STATS["queue_depth"] -= 1
        _STATS["pulls_completed" if state == "done" else
               ("pulls_cancelled" if state == "cancelled" else "pulls_failed")] += 1
        fh, tmp = req.fh, req.tmp_path
        req.fh = None
        req.tmp_path = None
        req.event.set()
        if state != "done":
            _close_discard(fh, tmp)

    @any_thread
    def _complete(self, req: _PullRequest) -> None:
        with self._lock:
            # A cancel/timeout racing transfer_end settles the request (and
            # discards fh/tmp) first — finalizing after that would crash the
            # shared peer reader thread on the nulled handles, killing every
            # other transfer on the link.
            if req.state != "inflight":
                return
            fh, tmp = req.fh, req.tmp_path
            req.fh = None
            req.tmp_path = None
        try:
            fh.close()
        except OSError:
            pass
        if not os.path.exists(req.final_path):
            try:
                os.replace(tmp, req.final_path)
            except OSError as e:
                self._finish_error(req, PullFailed(f"finalize failed: {e!r}"))
                return
        else:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        with self._lock:
            if req.state != "inflight":
                return  # cancelled while finalizing; the file stays as cache
            self._settle_locked(req, "done", None)
        self._admit_next()

    @any_thread
    def _finish_error(self, req: _PullRequest, err: BaseException) -> None:
        with self._lock:
            if req.state in ("done", "failed", "cancelled"):
                return
            self._settle_locked(req, "failed", err)
        self._admit_next()

    @any_thread
    def _drop_waiter(self, req: _PullRequest) -> None:
        """A blocking waiter timed out: when it was the last one, cancel the
        whole request so the slot frees up."""
        with self._lock:
            req.waiters = max(0, req.waiters - 1)
            last = req.waiters == 0 and req.state in ("queued", "inflight")
        if last:
            self.cancel(req.key, expect=req)

    @any_thread
    def _admit_next(self) -> None:
        """Pop highest-priority queued requests into freed slots. Reentrancy-
        guarded: an admitted pull that fails SYNCHRONOUSLY (e.g. dial refused
        to a dead node) re-enters here from its error path, which naively
        recurses one level per queued request — a few hundred queued pulls
        aimed at a dead source would blow the stack mid-bookkeeping. The
        active drain loop owns all admissions; re-entrants just flag it to
        re-check before exiting."""
        while True:
            with self._lock:
                if self._admitting:
                    self._admit_pending = True
                    return
                self._admitting = True
            try:
                while True:
                    with self._lock:
                        self._admit_pending = False
                        if self._inflight >= self.max_inflight:
                            break
                        req = None
                        while self._heap:
                            prio, _seq, key = heapq.heappop(self._heap)
                            cand = self._reqs.get(key)
                            # Lazy heap: skip entries whose request finished or
                            # was re-filed at a different priority.
                            if cand is not None and cand.state == "queued" \
                                    and cand.priority == prio:
                                req = cand
                                break
                        if req is None:
                            break
                        req.state = lifecycle.step("transfer", req.state, "inflight")
                        self._inflight += 1
                        _STATS["inflight"] += 1
                        _STATS["queue_depth"] -= 1
                    self._start_transfer(req)
            finally:
                with self._lock:
                    self._admitting = False
                    again = self._admit_pending
            if not again:
                return

    def _prefetch_loop(self) -> None:
        while not self._closed:
            wanted, locate_fn = self._prefetch_q.get()
            keys = [k for k, _m in wanted
                    if k not in self._reqs
                    and not os.path.exists(
                        os.path.join(self.shm_dir, _m.object_id.hex()))]
            if not keys:
                continue
            try:
                located = locate_fn(keys)
            except Exception:  # noqa: BLE001 — prefetch is best-effort
                continue
            for key, _meta in wanted:
                ent = located.get(key) if located else None
                if ent is None:
                    continue
                fresh, locations = ent
                if fresh is None or fresh.segment is None:
                    continue
                _STATS["prefetches"] += 1
                try:
                    self.pull_nowait(fresh, locations, PRIORITY_PREFETCH)
                except Exception:  # noqa: BLE001
                    pass


# --------------------------------------------------------------------------
# Push side
# --------------------------------------------------------------------------
class _PushState:
    __slots__ = ("req_id", "fh", "offset", "length", "chunk", "pos", "outstanding")

    def __init__(self, req_id: int, fh, offset: int, length: int, chunk: int):
        self.req_id = req_id
        self.fh = fh
        self.offset = offset
        self.length = length
        self.chunk = chunk
        self.pos = 0
        self.outstanding = 0


class PushEndpoint:
    """Serves one puller connection (reference: push_manager.h): begins,
    acks, and cancels arrive on the reader thread, which also pumps chunk
    sends — single-threaded per connection, so transfer state needs no
    locks. The outstanding-chunk window bounds both the socket backlog and
    the puller's reorder buffer."""

    def __init__(self, manager: "PushManager", conn):
        self.manager = manager
        self.conn = conn
        self.shm_root = os.path.realpath(manager.shm_dir)
        self.window = manager.window
        self._states: Dict[int, _PushState] = {}
        # Session-machine conformance (None unless RAY_TPU_TORCH_DEBUG_INVARIANTS):
        # ack/cancel frames must reference a stream this side saw begun.
        self._smon = session_monitor.stream()

    def serve(self) -> None:
        try:
            while True:
                msg = serialization.loads(self.conn.recv_bytes())
                self._dispatch(msg)
        except (EOFError, OSError):
            pass
        finally:
            for st in self._states.values():
                try:
                    st.fh.close()
                except OSError:
                    pass
            self._states.clear()
            try:
                self.conn.close()
            except OSError:
                pass

    def _dispatch(self, msg) -> None:
        kind = msg[0]
        if session_monitor.ENABLED:
            session_monitor.check_tag("transfer.push", kind)
            if kind != "batch":
                self._smon.note(kind, msg[1])
        if kind == "batch":
            # Puller-side BatchedSender coalesces acks/begins into one frame.
            for m in msg[1]:
                self._dispatch(m)
        elif kind == "transfer_begin":
            _, req_id, path, offset, length, chunk = msg
            self._begin(req_id, path, offset, length, chunk)
        elif kind == "transfer_ack":
            self._ack(msg[1], msg[2])
        elif kind == "transfer_cancel":
            st = self._states.pop(msg[1], None)
            if st is not None:
                try:
                    st.fh.close()
                except OSError:
                    pass

    def _begin(self, req_id: int, path: str, offset, length: int,
               chunk: int) -> None:
        # Relative names are replica cache files in THIS node's store dir
        # (the puller can't know another node's paths); absolute paths are
        # owner segment/arena files. Either way, only files under this
        # node's store dir are servable — the wire must never become an
        # arbitrary-file-read endpoint.
        if not os.path.isabs(path):
            path = os.path.join(self.shm_root, path)
        real = os.path.realpath(path)
        if not real.startswith(self.shm_root + os.sep) and real != self.shm_root:
            self._send(("transfer_end", req_id, False,
                        f"path outside store dir: {path}"))
            return
        try:
            fh = open(real, "rb")
        except OSError as e:
            self._send(("transfer_end", req_id, False, repr(e)))
            return
        st = _PushState(req_id, fh, int(offset or 0), int(length),
                        max(16 * 1024, int(chunk)))
        self._states[req_id] = st
        self._pump(st)

    def _ack(self, req_id: int, _seq: int) -> None:
        st = self._states.get(req_id)
        if st is not None:
            st.outstanding = max(0, st.outstanding - 1)
            self._pump(st)

    def _pump(self, st: _PushState) -> None:
        """Stream slice reads while the outstanding window has room — chunks
        come straight off the segment/arena file, never a whole-object
        buffer. The final chunk is followed immediately by transfer_end
        (FIFO: it arrives after every chunk)."""
        while st.outstanding < self.window and st.pos < st.length:
            n = min(st.chunk, st.length - st.pos)
            try:
                st.fh.seek(st.offset + st.pos)
                data = st.fh.read(n)
            except OSError as e:
                self._finish(st, False, repr(e))
                return
            if len(data) != n:
                self._finish(st, False,
                             f"short read at {st.pos} ({len(data)} < {n})")
                return
            seq = st.pos // st.chunk
            st.pos += n
            st.outstanding += 1
            _STATS["chunks_out"] += 1
            _STATS["bytes_out"] += n
            self._send_chunk(st.req_id, seq, data)
        if st.pos >= st.length:
            self._finish(st, True, None)

    def _finish(self, st: _PushState, ok: bool, err) -> None:
        if self._states.pop(st.req_id, None) is None:
            return  # already finished/cancelled
        try:
            st.fh.close()
        except OSError:
            pass
        if self._smon is not None:
            # The SENT close retires the stream too — without this, every
            # normally-completed transfer stays "active" in the monitor.
            self._smon.note("transfer_end", st.req_id)
        self._send(("transfer_end", st.req_id, ok, err))

    def _send(self, msg) -> None:
        self.conn.send_bytes(serialization.dumps(msg))

    def _send_chunk(self, req_id: int, seq: int, data: bytes) -> None:
        # Header frame + RAW payload frame (the unit the failpoint drops,
        # dups, or delays — both or neither, so the stream never desyncs).
        header = serialization.dumps(("transfer_chunk", req_id, seq, len(data)))

        def write_pair(_unit: bytes) -> None:
            self.conn.send_bytes(header)
            self.conn.send_bytes(data)

        if failpoints.ENABLED and failpoints.inject_send(
            "transfer.chunk", write_pair, b"", lambda: _abrupt_close(self.conn),
        ):
            return  # pair consumed (dropped) by the failpoint
        write_pair(b"")


class PushManager:
    """Node-side data listener: accepts authenticated peer connections and
    serves chunked segment reads out of this node's store dir. WITHOUT a
    cluster authkey the server does not start (an open listener would be an
    arbitrary-read endpoint); pulls then ride the authenticated relay."""

    def __init__(self, shm_dir: str, cfg=None, authkey: Optional[bytes] = None):
        if cfg is None:
            from ray_tpu_torch._private.config import get_config

            cfg = get_config()
        self.shm_dir = shm_dir
        self.window = max(1, int(cfg.transfer_window_chunks))
        self._authkey = authkey if authkey is not None else _env_authkey()
        self._listener = None
        self._stop = threading.Event()

    def start_listener(self, advertise_host: str) -> Optional[str]:
        if self._authkey is None:
            return None
        from multiprocessing.connection import Listener

        # Bind the ADVERTISE host, exactly like the control listeners: a
        # plain single-machine init() (loopback advertise) must not expose a
        # network-reachable port. backlog: the multiprocessing default of 1
        # silently drops concurrent dials past the first (each dropped
        # puller then hangs in its auth recv) — a fan-in of pullers hitting
        # one holder is the NORMAL case for a hot object, not a burst corner.
        self._listener = Listener((advertise_host or "127.0.0.1", 0),
                                  backlog=64, authkey=self._authkey)
        port = self._listener.address[1]
        threading.Thread(
            target=self._accept_loop, daemon=True, name="transfer-accept"
        ).start()
        return f"{advertise_host}:{port}"

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except Exception:  # noqa: BLE001 — OSError/EOF/AuthenticationError
                if self._stop.is_set():
                    return
                continue
            set_nodelay(conn)
            endpoint = PushEndpoint(self, conn)
            threading.Thread(
                target=endpoint.serve, daemon=True, name="transfer-push"
            ).start()

    def close(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass


# --------------------------------------------------------------------------
# Facade
# --------------------------------------------------------------------------
class ObjectTransferManager:
    """Both halves of the data plane for one process, plus the coalescing
    local-read path the head's relay fallback uses (so concurrent relay
    pulls of one key cost one segment read on a bounded pool instead of N
    ad-hoc threads)."""

    def __init__(self, shm_dir: str, cfg=None, authkey: Optional[bytes] = None):
        if cfg is None:
            from ray_tpu_torch._private.config import get_config

            cfg = get_config()
        self.shm_dir = shm_dir
        self.enabled = bool(cfg.enable_peer_transfer)
        self.pulls = PullManager(shm_dir, cfg, authkey=authkey)
        self.pushes = PushManager(shm_dir, cfg, authkey=authkey)
        self._lock = threading.Lock()
        self._local_reads: Dict[bytes, List[Callable[[bool, Any], None]]] = {}
        self._local_pool = None
        _stats_enabled()

    # Pull facade -----------------------------------------------------------
    @any_thread
    def pull(self, meta, locations, priority: int = PRIORITY_GET,
             timeout: Optional[float] = None) -> Optional[str]:
        return self.pulls.pull(meta, locations, priority, timeout)

    @any_thread
    def prefetch(self, metas, locate_fn) -> None:
        if self.enabled:
            self.pulls.prefetch(metas, locate_fn)

    @property
    def no_peer_nodes(self) -> Set[bytes]:
        return self.pulls.no_peer_nodes

    # Push facade -----------------------------------------------------------
    def start_push_server(self, advertise_host: str) -> Optional[str]:
        if not self.enabled:
            return None
        return self.pushes.start_listener(advertise_host)

    # Local coalescing reads (head relay fallback) --------------------------
    @any_thread
    def read_local(self, meta, respond: Callable[[bool, Any], None]) -> None:
        """Answer `respond(ok, (meta, bytes) | error)` with a local segment
        read, coalescing concurrent requests for the same object into ONE
        read on a bounded pool (satellite of the old ad-hoc "pull-read"
        thread, which both leaked threads under bursts and re-read the
        segment once per concurrent puller)."""
        key = meta.object_id.binary()
        with self._lock:
            waiters = self._local_reads.get(key)
            if waiters is not None:
                waiters.append(respond)
                return
            self._local_reads[key] = [respond]
            pool = self._ensure_pool_locked()
        pool.submit(self._do_local_read, key, meta)

    @lock_guarded("_lock")
    def _ensure_pool_locked(self):
        if self._local_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._local_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="pull-read"
            )
        return self._local_pool

    @any_thread
    def _do_local_read(self, key: bytes, meta) -> None:
        from ray_tpu_torch._private.object_store import read_segment

        try:
            payload: Any = (meta, read_segment(
                meta.segment, meta.arena_offset, meta.size))
            ok = True
        except OSError as e:
            payload = e
            ok = False
        with self._lock:
            waiters = self._local_reads.pop(key, [])
        for respond in waiters:
            respond(ok, payload)

    def close(self) -> None:
        self.pulls.close()
        self.pushes.close()
        if self._local_pool is not None:
            self._local_pool.shutdown(wait=False)
