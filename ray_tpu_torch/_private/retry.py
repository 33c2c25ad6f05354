"""The runtime's ONE retry/backoff policy: exponential backoff with
deterministic (seeded) jitter under a total deadline budget.

Before this module every retry in the tree was hand-rolled and one-shot: the
lost-segment path reconstructed exactly once, Serve resubmitted a dead-replica
request exactly once, the node daemon rejoined on a fixed 1s loop, collective
rendezvous polled at a fixed 50ms. One policy object replaces all of them, so
backoff behavior is uniform, configurable (``Config.retry_backoff_base_ms`` /
``retry_backoff_max_ms``), and — because jitter comes from a caller-provided
seed — chaos runs replay exactly.

Adopters: object reconstruct (`_private/worker.py`, `worker_main.fetch_value`),
Serve dead-replica resubmit (`serve/handle.py`), node-daemon head rejoin
(`node_daemon._reconnect`), collective rendezvous (`util/collective/
rendezvous.wait_for`).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass(frozen=True)
class RetryPolicy:
    """Attempt budget + backoff shape + total deadline.

    `max_attempts` counts TOTAL attempts (the first try included); backoff
    sleeps happen before each retry, never before the first attempt. The
    deadline is a wall-clock budget from the first attempt: a retry whose
    backoff would land past it is not made.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1  # +/- fraction of each delay, drawn from the seed
    deadline_s: Optional[float] = None

    @classmethod
    def from_config(cls, cfg, max_attempts: Optional[int] = None,
                    deadline_s: Optional[float] = None) -> "RetryPolicy":
        return cls(
            max_attempts=max_attempts if max_attempts is not None else 3,
            base_delay_s=max(0.0, cfg.retry_backoff_base_ms / 1000.0),
            max_delay_s=max(0.001, cfg.retry_backoff_max_ms / 1000.0),
            deadline_s=deadline_s,
        )


def seed_from(token) -> int:
    """Stable 16-bit jitter seed from a str/bytes token. NOT hash(): the
    built-in is salted per process (PYTHONHASHSEED), which would break the
    replay contract across runs."""
    import zlib

    if isinstance(token, str):
        token = token.encode()
    return zlib.crc32(token or b"") & 0xFFFF


def backoff_delays(policy: RetryPolicy, seed: Optional[int] = None) -> Iterator[float]:
    """The delay before each RETRY (``max_attempts - 1`` values): exponential
    from base, capped at max, jittered deterministically from `seed`."""
    rng = random.Random(seed)
    delay = policy.base_delay_s
    for _ in range(max(0, policy.max_attempts - 1)):
        jit = 1.0
        if policy.jitter > 0:
            jit = 1.0 + policy.jitter * (2.0 * rng.random() - 1.0)
        yield min(policy.max_delay_s, delay) * jit
        delay = min(policy.max_delay_s, delay * policy.multiplier)


def attempts(policy: RetryPolicy, seed: Optional[int] = None) -> Iterator[int]:
    """Yield attempt indices ``0..max_attempts-1``, sleeping the backoff delay
    BEFORE each retry and stopping early once the deadline budget is spent
    (the pending sleep is clipped to the remaining budget; if nothing
    remains, no further attempt is yielded). The canonical adoption shape::

        last = None
        for _ in retry.attempts(policy, seed=...):
            try:
                return do_the_thing()
            except TransientError as e:
                last = e
        raise TypedGaveUpError(...) from last
    """
    start = time.monotonic()
    delays = backoff_delays(policy, seed)
    for i in range(policy.max_attempts):
        if i > 0:
            try:
                delay = next(delays)
            except StopIteration:  # pragma: no cover - range bounds match
                return
            if policy.deadline_s is not None:
                remaining = policy.deadline_s - (time.monotonic() - start)
                if remaining <= 0 or delay >= remaining:
                    # A retry whose backoff lands past the deadline is not
                    # made — and not slept for either: clipping the sleep to
                    # the remainder would burn dead wall-clock with zero
                    # chance of another attempt.
                    return
            if delay > 0:
                time.sleep(delay)
        yield i


def reconstruct_object_with_retry(cfg, meta, reconstruct, read, first_err):
    """The ONE lost-segment recovery loop (driver get() and worker arg fetch
    share it): reconstruct from lineage under the policy —
    ``object_reconstruct_attempts`` x object-id-seeded backoff within the
    pull deadline, since a fresh copy can be lost AGAIN mid-chaos — and
    surface a typed ObjectLostError (never a bare OSError) once the budget
    is spent. `reconstruct(key_bytes) -> fresh_meta` performs the lineage
    re-execution round trip; `read(meta) -> value` reads the (re)stored
    bytes. Returns ``(fresh_meta, value)``."""
    from ray_tpu_torch import exceptions

    policy = RetryPolicy.from_config(
        cfg,
        max_attempts=max(1, cfg.object_reconstruct_attempts),
        deadline_s=cfg.object_pull_timeout_s,
    )
    last: BaseException = first_err
    seed = int.from_bytes(meta.object_id.binary()[:4], "little")
    for _ in attempts(policy, seed=seed):
        try:
            fresh = reconstruct(meta.object_id.binary())
            return fresh, read(fresh)
        except exceptions.ObjectLostError:
            raise  # unreconstructable (no lineage / actor task): final
        except (OSError, ConnectionError) as e:
            last = e
    raise exceptions.ObjectLostError(
        f"Object {meta.object_id.hex()} bytes are lost and "
        f"{policy.max_attempts} reconstruct attempt(s) did not restore them."
    ) from last


def call_with_retry(fn, policy: RetryPolicy, retry_on=(Exception,),
                    seed: Optional[int] = None):
    """Run ``fn()`` under the policy; re-raises the last `retry_on` error once
    the attempt/deadline budget is exhausted. Non-matching exceptions
    propagate immediately (they are not transient)."""
    last: Optional[BaseException] = None
    for _ in attempts(policy, seed=seed):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 - retry loop by design
            last = e
    if last is None:  # zero-attempt policy; treat as immediate failure
        raise RuntimeError("retry budget allowed no attempts")
    raise last
