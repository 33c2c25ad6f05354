"""Control-plane micro-batching: per-connection outbound coalescing.

The data plane moves bytes through shared memory at hardware speed, but every
control-plane operation — a task submission, an actor-call ExecRequest, a
put_meta registration, a completion, a refcount op — used to pay one framed
pickle + one pipe write + one reader wakeup. Fine-grained workloads are
bounded by that per-message cost, the same lesson as the reference's
ownership redesign (Wang et al., NSDI'21 "Ownership: A Distributed Futures
System for Fine-Grained Tasks") and the original Ray paper's
millions-of-tasks/s target (Moritz et al., OSDI'18).

`BatchedSender` generalizes the one batching seam that already existed
(refcount-op flushing in `_private/worker.py`) into a uniform layer:

 - fire-and-forget messages enqueue via `send_async()` and coalesce into a
   single ``("batch", [msg, ...])`` frame, flushed when the buffer reaches a
   count/byte threshold or when a sub-millisecond safety-net timer fires;
 - `send()` (used by every blocking request) flushes the buffer FIRST and
   then writes its message, so per-connection FIFO order is preserved by
   construction and a blocking get/wait never waits on the flush timer;
 - refcount ops ride the same buffer (`flush_ref_ops` enqueues drained ops
   via `send_async`), so they piggyback on whatever outbound batch goes next
   — a done, a submit — instead of paying dedicated frames.

Receivers are batch-aware: the scheduler loop, worker/driver readers, and the
node daemon unpack a ``("batch", ...)`` frame and process every contained
message before running scheduling/wakeup work once.

Disable with ``Config.control_plane_batching = False`` (env:
``RAY_TPU_TORCH_control_plane_batching=0``): every send becomes one frame again
with identical observable semantics.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional

from ray_tpu_torch._private import failpoints, serialization
from ray_tpu_torch._private.concurrency import any_thread, lock_guarded
from ray_tpu_torch.exceptions import FrameTooLargeError

# Process-wide batching stats, exported as ray_tpu_batch_* metrics by the
# telemetry collector (telemetry.ensure_batching_metrics). Plain ints bumped
# under each sender's lock: the send path never touches a Metric object.
# _FLUSH_SIZE_COUNTS[i] counts flushes of <= BATCH_FLUSH_BOUNDS[i] messages
# (overflow flushes appear only in the frame count, like Histogram.observe).
_STATS = {"msgs": 0, "frames": 0, "bytes": 0, "straggler_fires": 0}
_FLUSH_SIZE_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
_FLUSH_SIZE_COUNTS = [0] * len(_FLUSH_SIZE_BOUNDS)
_metrics_on = False


def _enable_stats() -> None:
    global _metrics_on
    if _metrics_on:
        return
    _metrics_on = True
    from ray_tpu_torch._private import telemetry

    telemetry.ensure_batching_metrics()


def _record_flush(n_msgs: int, nbytes: int) -> None:
    _STATS["msgs"] += n_msgs
    _STATS["frames"] += 1
    _STATS["bytes"] += nbytes
    for i, b in enumerate(_FLUSH_SIZE_BOUNDS):
        if n_msgs <= b:
            _FLUSH_SIZE_COUNTS[i] += 1
            break


def _meta_nbytes(meta: Any) -> int:
    """Bytes an ObjectMeta carries IN the message (inline payloads only;
    segment-backed objects ship no bytes on the control plane)."""
    n = 0
    inband = getattr(meta, "inband", None)
    if inband is not None:
        n += len(inband)
    for b in getattr(meta, "inline_buffers", None) or ():
        n += len(b)
    return n


def approx_msg_nbytes(msg: Any) -> int:
    """Cheap upper-ish estimate of a control message's wire size, good enough
    to bound buffered memory (exact accounting would require serializing at
    enqueue time, forfeiting the single-dump-per-batch win). Counts the
    payload-bearing fields: raw bytes, ObjectMeta inline payloads (puts,
    dones, stream items), and an ExecRequest's func_blob + arg metas."""
    n = 64
    try:
        items = msg if isinstance(msg, tuple) else (msg,)
        for x in items:
            if isinstance(x, (bytes, bytearray, memoryview)):
                n += len(x)
            elif isinstance(x, (list, tuple)):
                n += 64 + 64 * len(x)
                for y in x:
                    n += _meta_nbytes(y)
            else:
                n += _meta_nbytes(x)
                blob = getattr(x, "func_blob", None)  # ExecRequest
                if blob is not None:
                    n += len(blob)
                for m in getattr(x, "arg_metas", None) or ():
                    n += 64 + _meta_nbytes(m)
    except Exception:  # noqa: BLE001 — sizing must never break a send
        pass
    return n


class BatchedSender:
    """Outbound micro-batcher for one control connection.

    All writes to the connection MUST go through this object (its lock is the
    connection's send lock): `send()` for ordered/blocking messages,
    `send_async()` for coalescable fire-and-forget ones. `raw_send(data)`
    performs the actual frame write and may raise on a dead connection —
    `send()` propagates that (callers handle EOF), async/timer flushes
    swallow it (the reader-side EOF path owns connection death).
    """

    def __init__(self, raw_send: Callable[[bytes], None], cfg=None,
                 start_timer: bool = True,
                 close_fn: Optional[Callable[[], None]] = None):
        if cfg is None:
            from ray_tpu_torch._private.config import get_config

            cfg = get_config()
        self._raw_send = raw_send
        # For the "close" failpoint action: abruptly close the underlying
        # connection so the PEER sees a real mid-stream EOF (half-open case).
        self._close_fn = close_fn
        self._stats = bool(getattr(cfg, "enable_metrics", False))
        if self._stats:
            _enable_stats()
        self.enabled = bool(cfg.control_plane_batching)
        self.max_msgs = max(1, int(cfg.control_plane_batch_max_msgs))
        self.max_bytes = int(cfg.control_plane_batch_max_bytes)
        self.interval = float(cfg.control_plane_batch_flush_interval_s)
        self._lock = threading.Lock()
        self._buf: List[Any] = []
        self._nbytes = 0
        self._last_write = 0.0
        self._last_enqueue = 0.0
        self._dirty = threading.Event()
        self._closed = False
        self._timer_started = not (start_timer and self.enabled)

    # ------------------------------------------------------------------ sends
    @any_thread
    def send(self, msg: Any) -> None:
        """Flush buffered messages, then write `msg` — FIFO with everything
        queued before it. Raises on a dead connection."""
        with self._lock:
            self._flush_locked()
            if self._stats:
                _record_flush(1, approx_msg_nbytes(msg))
            data = serialization.dumps(msg)
            if failpoints.ENABLED and failpoints.inject_send(
                "conn.send", self._raw_send, data, self._close_fn
            ):
                return  # frame consumed (dropped) by the failpoint
            self._raw_send(data)

    @any_thread
    def send_async(self, msg: Any) -> None:
        """Enqueue a fire-and-forget message; flushes on threshold, else the
        timer (or the next send()/flush()) delivers it. Adaptive: after a
        quiet stretch (no write within the flush interval) the message goes
        out immediately — a lone message never waits on the timer, and sync
        request/response traffic skips the timer thread entirely (its
        wakeups cost ~15% of a roundtrip on small hosts)."""
        self._enqueue(msg, adaptive=True)

    @any_thread
    def buffer(self, msg: Any, nbytes: Optional[int] = None) -> None:
        """Enqueue WITHOUT the adaptive immediate-send: for messages whose
        natural flush point is a caller-owned boundary (a pipelined worker's
        queue-empty flush, a completion batch) — the timer is only the
        backstop. On a timeshared core each process's send cadence looks
        sparse even when the aggregate rate is high, so the adaptive path
        would defeat exactly the coalescing these messages exist for.
        `nbytes` lets hot callers pass a size they already know (a done's
        result sizes) instead of paying the generic estimator walk."""
        self._enqueue(msg, adaptive=False, nbytes=nbytes)

    @any_thread
    def _enqueue(self, msg: Any, adaptive: bool,
                 nbytes: Optional[int] = None) -> None:
        if not self.enabled:
            try:
                self.send(msg)
            except (OSError, ValueError):
                pass  # connection gone; reader EOF path handles it
            return
        arm = False
        with self._lock:
            now = time.monotonic()
            self._buf.append(msg)
            self._nbytes += approx_msg_nbytes(msg) if nbytes is None else nbytes
            stale = now - self._last_write >= self.interval
            self._last_enqueue = now
            if (
                len(self._buf) >= self.max_msgs
                or self._nbytes >= self.max_bytes
                or (adaptive and stale)
            ):
                try:
                    self._flush_locked()
                except (OSError, ValueError):
                    pass
                return
            # Arm only on the empty->non-empty transition: one timer wakeup
            # per flush cycle, not one per message (appends hold the lock, so
            # a post-flush append always re-arms).
            arm = len(self._buf) == 1
        if arm:
            self._arm_timer()

    @any_thread
    def flush(self) -> None:
        """Flush buffered messages now (the explicit flush-before-blocking /
        loop-idle hook). Connection errors are swallowed — the reader's EOF
        path owns death handling."""
        with self._lock:
            try:
                self._flush_locked()
            except (OSError, ValueError):
                pass

    def close(self) -> None:
        self._closed = True
        self._dirty.set()

    # --------------------------------------------------------------- internals
    @lock_guarded("_lock")
    def _flush_locked(self) -> None:
        msgs, self._buf = self._buf, []
        nbytes, self._nbytes = self._nbytes, 0
        self._last_write = time.monotonic()
        if not msgs:
            return
        if self._stats:
            _record_flush(len(msgs), nbytes)
        try:
            datas = serialization.frames(msgs[0] if len(msgs) == 1 else ("batch", msgs))
        except FrameTooLargeError as e:
            # A lone buffered message: its sender has moved on.
            serialization.report_dropped_frame("send", e)
            return
        for data in datas:
            if failpoints.ENABLED and failpoints.inject_send(
                "batch.flush", self._raw_send, data, self._close_fn
            ):
                continue
            self._raw_send(data)

    def _arm_timer(self) -> None:
        self._dirty.set()
        if self._timer_started:
            return
        with self._lock:
            if self._timer_started:
                return
            self._timer_started = True
        threading.Thread(
            target=self._timer_loop, daemon=True, name="cp-batch-flush"
        ).start()

    def _timer_loop(self) -> None:
        # Event-gated: parks while the connection is idle, so an idle worker
        # costs nothing. It is a STRAGGLER backstop, not the flush cadence:
        # while traffic is dense (a write happened within the interval) it
        # stays out of the way — flushing mid-burst would shred the batches
        # the thresholds are building AND contend the sender lock with the
        # hot path. Only a buffer that has gone stale (sender stopped without
        # reaching a flush point) is delivered here, within ~interval.
        while not self._closed:
            self._dirty.wait()
            if self._closed:
                return
            self._dirty.clear()
            if not self._buf:
                continue  # a threshold/explicit flush already delivered it
            # Re-check with exponential backoff while traffic stays fresh:
            # bounded wakeups during a long dense burst, still ~interval
            # latency for a buffer whose sender just went quiet.
            delay = self.interval if self.interval > 0 else 0.0002
            while self._buf and not self._closed:
                time.sleep(delay)
                if not self._buf:
                    break
                last_activity = max(self._last_write, self._last_enqueue)
                if time.monotonic() - last_activity >= self.interval:
                    if self._stats and self._buf:
                        _STATS["straggler_fires"] += 1
                    self.flush()
                    break
                delay = min(delay * 2, 0.02)
