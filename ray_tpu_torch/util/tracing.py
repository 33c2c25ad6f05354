"""Distributed tracing: spans around task/actor submission and execution.

Reference: `python/ray/util/tracing/tracing_helper.py` (`_tracing_task_invocation:284`,
`_inject_tracing_into_class:443`) — OpenTelemetry spans wrapped around every
task submit and execute, with trace context propagated caller -> worker.
Redesign: no hard OpenTelemetry dependency. Spans are plain dicts with
trace_id/span_id/parent_id; context rides the TaskSpec (and the Serve
request envelope: proxy -> router -> replica -> nested tasks), finished
spans buffer per process (bounded) and flush as APPEND batches into the
head's trace-span ring (`spans_push` cmd — per-flush cost proportional to
NEW spans, not history), where the driver collects them (`spans_list`).

Affordability (always-on mode, `RAY_TPU_TORCH_TRACING=1`):
 - head sampling: each ROOT span draws keep/drop at `trace_sample_rate`
   (seeded + replayable via `trace_sample_seed`); dropped roots propagate
   no context, so the whole trace costs one RNG draw.
 - tail-keep: spans created with `tail_keep=True` (Serve request roots,
   object-transfer pulls) are recorded provisionally even when unsampled
   and flushed only if their wall time reaches `trace_keep_latency_s` —
   the slow outliers survive any sample rate (marked keep="tail").
 - ids come from the batched-entropy trusted mint (`_private/ids._rand`),
   not per-span uuid4.
Programmatic `tracing.enable()` keeps full fidelity (rate 1.0) unless
given an explicit sample_rate — explicit enabling is debug mode.

    from ray_tpu_torch.util import tracing
    tracing.enable()
    ... run tasks ...
    spans = tracing.collect_spans()
    tracing.chrome_trace("trace.json")
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private.ids import _rand

_state = threading.local()
_lock = threading.Lock()
_enabled = False
_buffer: List[dict] = []
_exporter: Optional[Callable[[dict], None]] = None
_flusher_started = False

# Spans dropped by the bounded buffer (enable-before-init, flush failures):
# plain int on the span path, exported as ray_tpu_trace_spans_dropped_total
# by telemetry.ensure_tracing_metrics.
_DROPPED = {"spans": 0}
# Local buffer bound; refreshed from Config.trace_spans_cap lazily (the
# config may not be constructed yet when enable() runs pre-init).
_buffer_cap = 20000

# Sampling state: rate override (enable()'s full-fidelity default) and the
# per-process seeded RNG. None rate = read Config.trace_sample_rate.
_rate_override: Optional[float] = None
_sampler = None
_sampler_lock = threading.Lock()


def _ensure_flusher() -> None:
    global _flusher_started
    with _lock:
        if _flusher_started:
            return
        _flusher_started = True
    threading.Thread(target=_flush_loop, daemon=True, name="span-flusher").start()


def enable(exporter: Optional[Callable[[dict], None]] = None,
           sample_rate: Optional[float] = None) -> None:
    """Turn span recording on in this process (workers inherit via the
    RAY_TPU_TORCH_TRACING env var on spawned tasks). Explicit enable() records
    every trace (rate 1.0) unless `sample_rate` says otherwise; the
    always-on env mode samples at Config.trace_sample_rate instead."""
    global _enabled, _exporter, _rate_override
    _enabled = True
    _exporter = exporter
    _rate_override = 1.0 if sample_rate is None else float(sample_rate)
    os.environ["RAY_TPU_TORCH_TRACING"] = "1"
    _refresh_config()
    _ensure_flusher()
    _ensure_metrics()


def configure_sampling(rate: Optional[float] = None,
                       seed: Optional[int] = None) -> None:
    """Override the sampling rate and/or reseed the decision RNG (tests and
    ops tuning; a given seed replays the same keep/drop sequence)."""
    global _rate_override, _sampler
    import random

    if rate is not None:
        _rate_override = float(rate)
    if seed is not None:
        with _sampler_lock:
            _sampler = random.Random(seed)


# Cached RAY_TPU_TORCH_TRACING environ flag: is_enabled() sits on the `.remote()`
# submission hot path, where a per-call os.environ lookup costs more than the
# span check itself. The cache refreshes at the points the env can change
# under us: ray_tpu_torch.init(), and worker-side task env application (_execute).
_env_enabled = os.environ.get("RAY_TPU_TORCH_TRACING") == "1"


def _refresh_config() -> None:
    """Pull the span-buffer bound from config (safe pre-init: defaults)."""
    global _buffer_cap
    try:
        from ray_tpu_torch._private.config import get_config

        _buffer_cap = max(100, int(get_config().trace_spans_cap))
    except Exception:  # noqa: BLE001 — config not constructible yet
        pass


def refresh_env() -> None:
    global _env_enabled
    _env_enabled = os.environ.get("RAY_TPU_TORCH_TRACING") == "1"
    _refresh_config()
    if _env_enabled:
        _ensure_metrics()


def is_enabled() -> bool:
    return _enabled or _env_enabled


def _ensure_metrics() -> None:
    try:
        from ray_tpu_torch._private import telemetry

        if telemetry.metrics_enabled():
            telemetry.ensure_tracing_metrics()
    except Exception:  # noqa: BLE001 — metrics are optional here
        pass


# ------------------------------------------------------------------ sampling
def _effective_rate() -> float:
    if _rate_override is not None:
        return _rate_override
    try:
        from ray_tpu_torch._private.config import get_config

        return float(get_config().trace_sample_rate)
    except Exception:  # noqa: BLE001
        return 1.0


def _keep_latency() -> float:
    try:
        from ray_tpu_torch._private.config import get_config

        return float(get_config().trace_keep_latency_s)
    except Exception:  # noqa: BLE001
        return 0.0


def _should_sample() -> bool:
    """Root-span head-sampling decision. Spans recorded while tracing is
    OFF (timeline-only collective/custom spans) always keep — sampling is
    an always-on-tracing affordability device, not a timeline filter."""
    if not is_enabled():
        return True
    rate = _effective_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    global _sampler
    with _sampler_lock:
        if _sampler is None:
            import random

            seed = 0
            try:
                from ray_tpu_torch._private.config import get_config

                seed = int(get_config().trace_sample_seed)
            except Exception:  # noqa: BLE001
                seed = 0
            _sampler = random.Random(seed if seed else None)
        return _sampler.random() < rate


def root_unsampled() -> bool:
    """True when a ROOT span minted right here would lose the head-sampling
    draw (no ambient context, draw says drop). The `.remote()` fast path
    asks this FIRST so an unsampled submit keeps the template/trusted-id
    fast path — the whole per-task cost of always-on tracing at rate r is
    one RNG draw for the (1-r) majority."""
    if current_trace_context() is not None:
        return False
    return not _should_sample()


# ------------------------------------------------------------------ span core
# Ambient context for code that crossed a thread/event-loop hop (a Serve
# replica pushing sync user code onto its executor pool, async methods on the
# actor's shared loop): a contextvar survives task switches where the
# thread-local current-span slot can't.
_ctx_var: "contextvars.ContextVar[Optional[Dict[str, str]]]" = (
    contextvars.ContextVar("ray_tpu_trace_ctx", default=None)
)


def current_trace_context() -> Optional[Dict[str, str]]:
    span = getattr(_state, "span", None)
    if span is not None:
        return {"trace_id": span["trace_id"], "parent_id": span["span_id"]}
    return _ctx_var.get()


def context_of(span: Optional[dict]) -> Optional[Dict[str, str]]:
    """The propagable context of a live span, or None for a dropped or
    provisional (tail-keep, not head-sampled) span — children of an
    unsampled trace must not record."""
    if span is None or span.get("_provisional"):
        return None
    return {"trace_id": span["trace_id"], "parent_id": span["span_id"]}


class context_scope:
    """Make `ctx` the ambient trace context while the block runs (explicit
    propagation for code that received a context over a request envelope
    rather than from an enclosing span). Contextvar-backed: correct on a
    plain thread AND inside an asyncio task. ctx=None is a no-op scope."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[Dict[str, str]]):
        self._ctx = ctx

    def __enter__(self):
        if self._ctx is not None:
            self._token = _ctx_var.set(self._ctx)
        return self._ctx

    def __exit__(self, *_exc):
        if self._ctx is not None:
            _ctx_var.reset(self._token)
        return False


def start_span(name: str, kind: str, trace_context: Optional[Dict[str, str]] = None,
               attributes: Optional[Dict[str, Any]] = None,
               detached: bool = False, tail_keep: bool = False,
               presampled: bool = False) -> Optional[dict]:
    """Open a span. Returns None when the span is a ROOT that lost the
    head-sampling draw (unless `tail_keep`, which records provisionally and
    lets end_span decide by latency). `detached` spans never touch the
    thread-local current-span slot (concurrent requests on one event-loop
    thread must not adopt each other's spans). `presampled` means the
    caller already made (and won) this root's sampling decision — e.g. the
    `.remote()` fast-path gate via root_unsampled() — so exactly ONE draw
    is consumed per root whichever path runs."""
    parent = trace_context or current_trace_context()
    provisional = False
    if parent is None:
        if not presampled and not _should_sample():
            if not (tail_keep and _keep_latency() > 0.0):
                return None
            provisional = True
        trace_id = _rand(16).hex()
        parent_id = None
    else:
        trace_id = parent.get("trace_id") or _rand(16).hex()
        parent_id = parent.get("parent_id")
    span = {
        "name": name,
        "kind": kind,  # "submit" | "execute" | "request" | "router" | ...
        "trace_id": trace_id,
        "span_id": _rand(8).hex(),
        "parent_id": parent_id,
        "start": time.time(),
        "end": None,
        "status": "OK",
        "attributes": attributes or {},
        "pid": os.getpid(),
    }
    if provisional:
        span["_provisional"] = True
    if detached:
        span["_detached"] = True
    else:
        span["_prev"] = getattr(_state, "span", None)
        _state.span = span
    return span


def end_span(span: Optional[dict], status: str = "OK") -> None:
    if span is None:
        return
    span["end"] = time.time()
    span["status"] = status
    if not span.pop("_detached", False):
        _state.span = span.pop("_prev", None)
    if span.pop("_provisional", False):
        # Tail-keep verdict: an unsampled span survives only by breaching
        # the latency threshold.
        if span["end"] - span["start"] < _keep_latency():
            return
        span["keep"] = "tail"
    _buffer_span(span)
    if _exporter is not None:
        try:
            _exporter(span)
        except Exception:
            pass


def record_span(name: str, kind: str, start: float, end: float,
                trace_context: Optional[Dict[str, str]] = None,
                attributes: Optional[Dict[str, Any]] = None,
                status: str = "OK", tail_keep: bool = False) -> None:
    """Emit an already-measured span (no thread-local involvement): the
    object-transfer pull path measures around its blocking wait and reports
    here. Dropped unless it has a (sampled) parent context or breaches the
    tail-keep threshold."""
    keep = None
    if trace_context is None:
        if not (tail_keep and _keep_latency() > 0.0
                and end - start >= _keep_latency()):
            return
        keep = "tail"
    span = {
        "name": name,
        "kind": kind,
        "trace_id": (trace_context or {}).get("trace_id") or _rand(16).hex(),
        "span_id": _rand(8).hex(),
        "parent_id": (trace_context or {}).get("parent_id"),
        "start": start,
        "end": end,
        "status": status,
        "attributes": attributes or {},
        "pid": os.getpid(),
    }
    if keep:
        span["keep"] = keep
    _buffer_span(span)


def _buffer_span(span: dict) -> None:
    with _lock:
        if len(_buffer) >= _buffer_cap:
            # Bounded: a process that can't flush (no runtime context yet —
            # enable() before init) must not grow this list forever.
            _DROPPED["spans"] += 1
            return
        _buffer.append(span)
    _ensure_flusher()  # workers start flushing on their first finished span


class span:
    """Context manager for custom application spans."""

    def __init__(self, name: str, attributes: Optional[Dict[str, Any]] = None):
        self._name = name
        self._attrs = attributes

    def __enter__(self):
        self._span = start_span(self._name, "custom", attributes=self._attrs)
        return self._span

    def __exit__(self, exc_type, _exc, _tb):
        end_span(self._span, "ERROR" if exc_type else "OK")
        return False


# ------------------------------------------------------------------ flushing
def _flush_loop():
    while True:
        time.sleep(1.0)
        flush_spans()


def flush_spans() -> None:
    """Push buffered spans to the head's trace-span ring as one APPEND batch
    (`spans_push`): per-flush cost is proportional to the NEW spans, unlike
    the old `spans::<pid>` KV read-modify-write that re-parsed and re-wrote
    the process's whole history every second."""
    from ray_tpu_torch._private.worker import global_worker

    ctx = global_worker.context
    with _lock:
        if not _buffer:
            return
        if ctx is None:
            # No runtime to flush into yet: hold the (bounded) buffer.
            return
        batch, _buffer[:] = list(_buffer), []
    try:
        ctx.push_spans([_strip(s) for s in batch])
    except Exception:
        with _lock:
            # Retry next flush; re-admit only up to the cap.
            room = max(0, _buffer_cap - len(_buffer))
            _DROPPED["spans"] += max(0, len(batch) - room)
            _buffer[:0] = batch[:room]


def _strip(s: dict) -> dict:
    return {k: v for k, v in s.items() if not k.startswith("_")}


def collect_spans() -> List[dict]:
    """All spans every process has flushed into the head's ring (driver
    side); empty when no runtime is connected."""
    from ray_tpu_torch._private.worker import global_worker

    flush_spans()
    ctx = global_worker.context
    if ctx is None:
        return []
    out = ctx.list_spans(None)
    return sorted(out, key=lambda s: s["start"])


def chrome_trace(filename: Optional[str] = None) -> List[dict]:
    """Spans as chrome://tracing complete events (pid = process, tid = trace).

    args carry the span/parent ids so a merged timeline
    (`ray_tpu_torch.timeline()`) preserves the caller->worker parent links; dur is
    clamped to 1us so sub-microsecond submit spans stay visible (and valid)
    in chrome://tracing."""
    events = []
    for s in collect_spans():
        if s.get("end") is None:
            continue
        events.append(
            {
                "name": s["name"],
                "cat": s["kind"],
                "ph": "X",
                "ts": int(s["start"] * 1e6),
                "dur": max(1, int((s["end"] - s["start"]) * 1e6)),
                "pid": s["pid"],
                "tid": s["trace_id"][:8],
                "args": {
                    **s.get("attributes", {}),
                    "status": s["status"],
                    "trace_id": s["trace_id"],
                    "span_id": s["span_id"],
                    "parent_id": s.get("parent_id"),
                },
            }
        )
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events
