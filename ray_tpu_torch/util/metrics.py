"""Application + runtime metrics: Counter / Gauge / Histogram.

Reference: `python/ray/util/metrics.py` (user metrics) + the C++ OpenCensus
stats pipeline (`src/ray/stats/metric.h` -> per-node metrics agent ->
Prometheus scrape, `_private/metrics_agent.py:189`). Redesign: each process
keeps a local registry and flushes snapshots into the GCS KV under
`metrics::<process>`; the dashboard's /metrics endpoint merges every
process's snapshot into one Prometheus text exposition.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60)


class _Registry:
    def __init__(self):
        self.lock = threading.Lock()
        self.metrics: Dict[str, "Metric"] = {}
        # Called right before each snapshot: the off-hot-path seam for
        # runtime internals (batching stats, object-store counters) that
        # accumulate plain ints and only materialize into Metric objects
        # here, at flush cadence instead of per message.
        self.collectors: List[Callable[[], None]] = []
        # Collectors are delta-based (they keep a "last seen" cursor): two
        # concurrent snapshots (the 1 Hz flusher + a /metrics scrape) must
        # not run the same collector at once or the delta double-counts.
        self._collector_lock = threading.Lock()
        self._flusher_started = False

    def register(self, metric: "Metric") -> None:
        with self.lock:
            existing = self.metrics.get(metric.name)
            if existing is not None and type(existing) is not type(metric):
                raise ValueError(f"metric '{metric.name}' already registered with a different type")
            self.metrics[metric.name] = metric
        self._ensure_flusher()

    def snapshot(self) -> List[dict]:
        with self._collector_lock:
            for collect in list(self.collectors):
                try:
                    collect()
                except Exception:
                    pass  # a broken collector must never break the exposition
        with self.lock:
            return [m._snapshot() for m in self.metrics.values()]

    def _ensure_flusher(self) -> None:
        with self.lock:
            if self._flusher_started:
                return
            self._flusher_started = True

        def loop():
            while True:
                time.sleep(1.0)
                flush_metrics()

        threading.Thread(target=loop, daemon=True, name="metrics-flusher").start()


_registry = _Registry()


def register_collector(fn: Callable[[], None]) -> None:
    """Register a pre-snapshot hook that moves accumulated raw counts into
    Metric objects. Runs at flush cadence (~1 Hz) and on every explicit
    flush_metrics()/prometheus_text()-triggered snapshot."""
    _registry.collectors.append(fn)


# Head-process flush seam: a standalone head server has no driver context
# (global_worker.context is None there), so its scheduler metrics would never
# reach the KV — the observability layer registers a direct GCS+store sink
# (timeseries.ObsState) instead. Processes with a context never use it.
_local_sink: Optional[Callable[[bytes, bytes], None]] = None


def set_local_sink(fn: Optional[Callable[[bytes, bytes], None]]) -> None:
    global _local_sink
    _local_sink = fn


def flush_metrics() -> None:
    """Push this process's snapshot into the control plane KV."""
    from ray_tpu_torch._private.worker import global_worker

    ctx = global_worker.context
    if not _registry.metrics:
        return
    if ctx is None and _local_sink is None:
        return
    try:
        key = f"metrics::{os.getpid()}".encode()
        payload = json.dumps(_registry.snapshot()).encode()
        if ctx is not None:
            ctx.kv("put", key, payload)
        else:
            _local_sink(key, payload)
    except Exception:
        pass  # control plane not up / shutting down


def collect_all() -> List[dict]:
    """Merge every process's snapshot (driver side)."""
    from ray_tpu_torch._private.worker import global_worker

    ctx = global_worker.context
    out: List[dict] = []
    for key in ctx.kv("keys", b"metrics::"):
        raw = ctx.kv("get", key)
        if raw:
            pid = key.decode().split("::", 1)[1]
            for m in json.loads(raw):
                m["pid"] = pid
                out.append(m)
    return out


def prometheus_text() -> str:
    """Render merged snapshots as Prometheus exposition text: counters and
    histograms sum across processes; gauges export per-process with a pid tag
    (summing gauges would be wrong). Flushes this process's registry first so
    a scrape right after an update never reads a stale snapshot."""
    flush_metrics()
    merged: Dict[Tuple[str, str], dict] = {}
    lines: List[str] = []
    for m in collect_all():
        if m["type"] == "gauge":
            for tags, v in m["series"]:
                key = (m["name"], _fmt_tags(dict(tags) | {"pid": m["pid"]}))
                merged[key] = {"type": "gauge", "help": m["help"], "value": v}
        elif m["type"] == "counter":
            for tags, v in m["series"]:
                key = (m["name"], _fmt_tags(dict(tags)))
                cur = merged.setdefault(key, {"type": "counter", "help": m["help"], "value": 0.0})
                cur["value"] += v
        else:  # histogram
            for tags, data in m["series"]:
                key = (m["name"], _fmt_tags(dict(tags)))
                cur = merged.setdefault(
                    key,
                    {
                        "type": "histogram",
                        "help": m["help"],
                        "buckets": dict.fromkeys(map(str, m["buckets"]), 0),
                        "sum": 0.0,
                        "count": 0,
                    },
                )
                for b, c in zip(m["buckets"], data["bucket_counts"]):
                    # Processes may disagree on boundaries (per-process
                    # registries, rolling code changes): union the buckets
                    # instead of KeyError-ing the whole exposition.
                    k = str(b)
                    cur["buckets"][k] = cur["buckets"].get(k, 0) + c
                cur["sum"] += data["sum"]
                cur["count"] += data["count"]
    seen_headers = set()
    for (name, tagstr), m in sorted(merged.items()):
        if name not in seen_headers:
            seen_headers.add(name)
            lines.append(f"# HELP {name} {m['help']}")
            lines.append(f"# TYPE {name} {m['type']}")
        if m["type"] in ("gauge", "counter"):
            lines.append(f"{name}{tagstr} {m['value']}")
        else:
            # Histogram series keep their tags: the le label joins the
            # series tags (dropping them would emit duplicate untagged
            # sample lines once a histogram has two tag sets — an invalid
            # exposition Prometheus rejects wholesale).
            inner = tagstr[1:-1] + "," if tagstr else ""
            acc = 0
            for b in sorted(m["buckets"], key=float):
                acc += m["buckets"][b]
                lines.append(f'{name}_bucket{{{inner}le="{b}"}} {acc}')
            lines.append(f'{name}_bucket{{{inner}le="+Inf"}} {m["count"]}')
            lines.append(f"{name}_sum{tagstr} {m['sum']}")
            lines.append(f"{name}_count{tagstr} {m['count']}")
    return "\n".join(lines) + "\n"


def _fmt_tags(tags: Dict[str, str]) -> str:
    if not tags:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(tags.items()))
    return "{" + inner + "}"


# Per-series exemplar bound: the last few (ts, value, trace_id) samples ride
# the snapshot so the series store can link an observation back to the
# concrete trace that produced it (the Prometheus/OpenMetrics exemplar idea).
_EXEMPLAR_CAP = 4


class Metric:
    def __init__(self, name: str, description: str = "", tag_keys: Sequence[str] = ()):
        self.name = name
        self.help = description
        self.tag_keys = tuple(tag_keys)
        self._lock = threading.Lock()
        self._default_tags: Dict[str, str] = {}
        # series key -> [(ts, value, trace_id), ...] (bounded, newest last);
        # only observations that CARRIED a trace id land here.
        self._exemplars: Dict[Tuple, List[tuple]] = {}
        _registry.register(self)

    def set_default_tags(self, tags: Dict[str, str]) -> None:
        self._default_tags = dict(tags)

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
        merged = {**self._default_tags, **(tags or {})}
        return tuple(sorted(merged.items()))

    def _note_exemplar(self, k: Tuple, value: float, trace_id) -> None:
        """Record one traced observation for series `k` (caller holds the
        metric lock). None trace ids are ignored — untraced traffic never
        grows this map."""
        if not trace_id:
            return
        ex = self._exemplars.setdefault(k, [])
        ex.append((time.time(), float(value), str(trace_id)))
        if len(ex) > _EXEMPLAR_CAP:
            del ex[: len(ex) - _EXEMPLAR_CAP]

    def _exemplar_snapshot(self):
        return [(list(k), list(v)) for k, v in self._exemplars.items() if v]


class Counter(Metric):
    def __init__(self, name, description: str = "", tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        with self._lock:
            k = self._key(tags)
            self._values[k] = self._values.get(k, 0.0) + value

    def _snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name, "type": "counter", "help": self.help,
                "series": [(list(k), v) for k, v in self._values.items()],
            }


class Gauge(Metric):
    def __init__(self, name, description: str = "", tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None,
            exemplar: Optional[str] = None) -> None:
        with self._lock:
            k = self._key(tags)
            self._values[k] = float(value)
            self._note_exemplar(k, value, exemplar)

    def _snapshot(self) -> dict:
        with self._lock:
            out = {
                "name": self.name, "type": "gauge", "help": self.help,
                "series": [(list(k), v) for k, v in self._values.items()],
            }
            ex = self._exemplar_snapshot()
            if ex:
                out["exemplars"] = ex
            return out


class Histogram(Metric):
    def __init__(self, name, description: str = "", boundaries: Sequence[float] = _DEFAULT_BUCKETS,
                 tag_keys: Sequence[str] = ()):
        self.boundaries = tuple(boundaries)
        super().__init__(name, description, tag_keys)
        self._data: Dict[Tuple, dict] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None,
                exemplar: Optional[str] = None) -> None:
        with self._lock:
            k = self._key(tags)
            d = self._data.setdefault(
                k, {"bucket_counts": [0] * len(self.boundaries), "sum": 0.0, "count": 0}
            )
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    d["bucket_counts"][i] += 1
                    break
            d["sum"] += value
            d["count"] += 1
            self._note_exemplar(k, value, exemplar)

    def _merge_counts(self, bucket_counts: Sequence[int], count: int, total: float,
                      tags: Optional[Dict[str, str]] = None) -> None:
        """Bulk-add pre-bucketed observations (a collector's delta since its
        last run). `bucket_counts` aligns with this histogram's boundaries;
        overflow observations appear only in `count`/`total`, mirroring
        observe()'s behavior for values above the last boundary."""
        with self._lock:
            k = self._key(tags)
            d = self._data.setdefault(
                k, {"bucket_counts": [0] * len(self.boundaries), "sum": 0.0, "count": 0}
            )
            for i, c in enumerate(bucket_counts[: len(self.boundaries)]):
                d["bucket_counts"][i] += c
            d["sum"] += total
            d["count"] += count

    def _snapshot(self) -> dict:
        with self._lock:
            out = {
                "name": self.name, "type": "histogram", "help": self.help,
                "buckets": list(self.boundaries),
                "series": [(list(k), dict(v)) for k, v in self._data.items()],
            }
            ex = self._exemplar_snapshot()
            if ex:
                out["exemplars"] = ex
            return out
