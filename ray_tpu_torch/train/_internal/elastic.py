"""Elastic-gang checkpoint replication: per-worker in-memory stash + peer
mirrors, and the driver-side recovery assembly.

Every rank keeps its newest checkpoint shards in process memory (the "stash",
written by `air.session.stash_checkpoint` at effectively zero cost) and
mirrors each stash entry to ONE peer worker over the object plane. Losing a
worker — even rank 0, even without a recent disk checkpoint — therefore never
loses the newest state: the dead rank's shard survives in its peer's mirror,
and the driver reassembles the full tree from survivors' stashes plus mirrors
(`assemble_recovery`).

Stash entries are self-describing ({step, world_size, rank, state, rules}) and
both stores keep a small window of recent steps per source. The window must
cover the maximum inter-rank skew at detection time: ranks are lockstep only
at driver-round granularity, and a survivor can run ahead of a dead rank by
the report-queue depth (1) plus the result already claimed by the in-flight
`next_result` call plus the step it is computing — 3 steps — before its
report blocks. Keeping 5 generations guarantees every survivor still holds
the dead rank's newest step, so a *consistent* (same step, same world size)
full set exists at assembly time even when the kill lands mid-round. Entries
cut at an older world size remain assemblable — a complete world-4 set is
valid state even after the gang shrank to 3.

This module holds worker-process globals (like the session module); the
driver only calls `assemble_recovery` on payloads fetched via actor calls.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

# Generations kept per source rank: must exceed the max detection-time skew
# between a dead rank and the fastest survivor (3 steps, see module doc).
_KEEP = 5

_lock = threading.Lock()
# This worker's own stash: step -> payload dict.
_stash: Dict[int, Dict[str, Any]] = {}
# Mirrors received from peers: sender rank -> {step: payload}.
_mirrors: Dict[int, Dict[int, Dict[str, Any]]] = {}
# Peer actor handle this worker mirrors its stash to (set by the executor).
_peer = None


def _trim(entries: Dict[int, Dict[str, Any]]) -> None:
    while len(entries) > _KEEP:
        del entries[min(entries)]


def set_peer(handle) -> None:
    global _peer
    _peer = handle


def clear() -> None:
    """Drop peer handle and mirrors (worker reuse across fits). The stash
    itself is kept: it is this rank's own state and stays valid."""
    global _peer
    with _lock:
        _peer = None
        _mirrors.clear()


def stash(rank: int, step: int, world_size: int, state: Any, rules) -> None:
    """Record this rank's newest shard and mirror it to the peer (fire and
    forget: the training step must not block on replication)."""
    payload = {
        "step": int(step),
        "world_size": int(world_size),
        "rank": int(rank),
        "state": state,
        "rules": list(rules or []),
    }
    with _lock:
        _stash[payload["step"]] = payload
        _trim(_stash)
        peer = _peer
    if peer is not None:
        try:
            peer.receive_mirror.remote(payload)
        except Exception:  # noqa: BLE001 — peer dying; resize will handle it
            pass


def flush_to_peer(timeout: float = 2.0) -> bool:
    """Synchronously push the newest stash entry to the peer — the preemption
    notice path, where the process is about to die and the mirror must land
    before it does."""
    with _lock:
        if not _stash:
            return False
        payload = _stash[max(_stash)]
        peer = _peer
    if peer is None:
        return False
    try:
        import ray_tpu_torch

        ray_tpu_torch.get(peer.receive_mirror.remote(payload), timeout=timeout)
        return True
    except Exception:  # noqa: BLE001
        return False


def receive_mirror(payload: Dict[str, Any]) -> None:
    """Actor-call target on the peer: store another rank's shard."""
    rank = int(payload.get("rank", -1))
    with _lock:
        entries = _mirrors.setdefault(rank, {})
        entries[int(payload.get("step", 0))] = payload
        _trim(entries)


def fetch_stash() -> List[Dict[str, Any]]:
    """This worker's own stash entries (driver recovery fetch)."""
    with _lock:
        return list(_stash.values())


def fetch_mirrors() -> List[Dict[str, Any]]:
    """Every mirrored payload this worker holds for other ranks."""
    with _lock:
        return [p for entries in _mirrors.values() for p in entries.values()]


def newest_step() -> Optional[int]:
    with _lock:
        return max(_stash) if _stash else None


# --------------------------------------------------------------- driver side
def assemble_recovery(
    payloads: List[Dict[str, Any]],
) -> Optional[Tuple[int, Any, List]]:
    """Reassemble the newest complete checkpoint from collected payloads.

    A candidate is a (step, world_size) group; it is complete when every rank
    0..world_size-1 contributed a shard. Returns (step, full state tree,
    rules) for the completable group with the highest step, or None. A
    sharded stash (one with rules) is gathered whole
    (``train/torch/resharding.py``), for the resumed ranks to cut again at
    the new world size.
    """
    from ray_tpu_torch.train.torch import resharding

    groups: Dict[Tuple[int, int], Dict[int, Dict[str, Any]]] = {}
    for p in payloads:
        if not isinstance(p, dict) or "state" not in p:
            continue
        key = (int(p.get("step", 0)), int(p.get("world_size", 0)))
        groups.setdefault(key, {})[int(p.get("rank", -1))] = p
    complete = [
        (step, world, by_rank)
        for (step, world), by_rank in groups.items()
        if world >= 1 and all(r in by_rank for r in range(world))
    ]
    if not complete:
        return None
    step, world, by_rank = max(complete, key=lambda c: c[0])
    rules = [tuple(r) for r in (by_rank[0].get("rules") or [])]
    shards = {rk: by_rank[rk]["state"] for rk in range(world)}
    if not rules:
        # No partition rules: state is replicated; any rank's copy is whole.
        return step, shards[0], []
    # Rules arrive as [pattern, spec] lists after serialization.
    norm = [(pat, tuple(spec)) for pat, spec in rules]
    return step, resharding.gather_tree(shards, norm), norm
