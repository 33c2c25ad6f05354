"""KV-based rendezvous shared by all collective backends: rank 0 publishes a
value under a group-scoped key; other ranks poll until it appears. The
replacement for the reference's named `NCCLUniqueIDStore` actor
(`nccl_collective_group.py:28-60`)."""

from __future__ import annotations

import time

# Plain per-process accumulators (waits + blocked seconds) so the train-side
# goodput ledger can bucket rendezvous time without the metrics pipeline; the
# histogram below is the cluster-visible view and stays behind enable_metrics.
_WAIT_STATS = {"waits": 0, "wait_s": 0.0}


def publish(kv, key: bytes, value: bytes) -> None:
    kv("put", key, value)


def note_wait(seconds: float, emit_metric: bool = True) -> None:
    """Account `seconds` of rendezvous blocking. Other gang-join seams that
    block outside wait_for (e.g. a process-group init) call this so the
    ledger's rendezvous_wait bucket sees them too."""
    _WAIT_STATS["waits"] += 1
    _WAIT_STATS["wait_s"] += float(seconds)
    if not emit_metric:
        return
    try:
        from ray_tpu_torch._private.config import get_config

        if get_config().enable_metrics:
            from ray_tpu_torch._private.telemetry import rendezvous_wait_histogram

            rendezvous_wait_histogram().observe(float(seconds))
    except Exception:  # noqa: BLE001 — telemetry must not break rendezvous
        pass


def wait_for(kv, key: bytes, timeout: float = None) -> bytes:
    if timeout is None:
        # Config-governed ceiling (Config.collective_timeout_s / the
        # RAY_TPU_TORCH_collective_timeout_s override).
        from ray_tpu_torch._private.config import get_config

        timeout = float(get_config().collective_timeout_s)
    # Unified retry policy: backoff 5ms -> 250ms with key-seeded jitter under
    # the timeout budget (was a fixed 50ms poll). Only INJECTED handler
    # faults (chaos schedules) count as transient and retry in budget —
    # connection-level errors mean the control plane is gone and the client
    # conn never heals, so they propagate immediately (hanging every rank
    # for collective_timeout_s on a dead head would be strictly worse).
    # Seeded via retry.seed_from (stable across processes, unlike hash()).
    from ray_tpu_torch._private import failpoints, retry

    policy = retry.RetryPolicy(
        max_attempts=1_000_000, base_delay_s=0.005, max_delay_s=0.25,
        multiplier=1.6, deadline_s=timeout,
    )
    last_err = None
    transient = (failpoints.FailpointInjected,)
    t0 = time.perf_counter()
    try:
        for _ in retry.attempts(policy, seed=retry.seed_from(key)):
            try:
                value = kv("get", key)
            except transient as e:
                last_err = e
                continue
            if value:
                return value
        raise TimeoutError(
            f"rendezvous on {key!r} timed out after {timeout}s"
        ) from last_err
    finally:
        note_wait(time.perf_counter() - t0)


def clear(kv, key: bytes) -> None:
    kv("del", key)
