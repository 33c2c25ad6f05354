"""Node-local object store: an in-process memory store for small objects plus a
shared-memory (/dev/shm mmap) store for large ones.

This is a re-design of the reference's two stores:
 - in-process memory store (`src/ray/core_worker/store_provider/
   memory_store/memory_store.h:43`) for small/inlined results, and
 - plasma (`src/ray/object_manager/plasma/store.cc`), the node-level
   shared-memory store with zero-copy reads.

Differences from plasma, deliberate:
 - one segment file per object (created by the *writing* process, attached lazily by
   readers) instead of a single dlmalloc arena behind a unix-socket protocol. Segment
   metadata travels through the control plane, so writers never copy payload bytes
   through a socket. A C++ arena allocator can replace the per-object files without
   changing this interface (see ray_tpu_torch/_native).
 - CUDA tensors never enter the store: they are lowered to CPU tensors when they
   cross a process (serialization.py); only host data does.

Layout of a segment file:  [8-byte inband len][inband pickle][buffer 0][buffer 1]...
with every buffer 64-byte aligned so numpy views over the mmap are aligned.
"""

from __future__ import annotations

import mmap
import os
import sys
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import failpoints
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.serialization import (
    FRAME_HEADROOM,
    SerializedValue,
    check_frame,
    deserialize,
    serialize,
)

_ALIGN = 64


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


@dataclass
class ObjectMeta:
    """Control-plane record describing where an object's bytes live."""

    object_id: ObjectID
    size: int
    # For inline objects, the payload travels with the metadata.
    inband: Optional[bytes] = None
    inline_buffers: Optional[List[bytes]] = None
    # For shm objects: segment path + (offset, length) per out-of-band buffer.
    segment: Optional[str] = None
    buffer_layout: Optional[List[Tuple[int, int]]] = None
    # Error payloads are stored like inline objects but marked, so `get` re-raises.
    is_error: bool = False
    # NodeID.binary() of the node whose store holds the segment. Readers on other
    # nodes use it to route a pull (the analogue of the reference's object
    # directory, `src/ray/object_manager/ownership_based_object_directory.h`).
    node_id: Optional[bytes] = None
    # Set when the bytes live inside the node's native shm ARENA (segment is
    # then the arena path): payload offset of this object's allocation.
    # buffer_layout offsets are relative to the allocation either way.
    arena_offset: Optional[int] = None
    # False for metas that ALIAS another object's payload (dependency-error
    # propagation): readers use the location, but freeing is the owner's job.
    owns_payload: bool = True
    # ObjectRef ids pickled inside this value: the control plane keeps them
    # pinned while this object lives (reference: contained-object tracking,
    # `core_worker/reference_count.h`).
    contained_ids: Optional[List[bytes]] = None
    # True when the bytes were relocated to the disk spill directory (plasma's
    # fallback-allocation analogue): excluded from shm capacity accounting.
    spilled: bool = False


class SharedSegment:
    """A single mmap'ed object segment under /dev/shm."""

    def __init__(self, path: str, size: int = 0, create: bool = False):
        self.path = path
        if create:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, size)
                self.mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
        else:
            fd = os.open(path, os.O_RDWR)
            try:
                size = os.fstat(fd).st_size
                self.mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
        self.size = size

    def close(self):
        try:
            self.mm.close()
        except BufferError:
            # A numpy view still references the mapping; the mmap will be freed
            # when the last view dies.
            pass

    def unlink(self):
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


ARENA_FILENAME = "arena.shm"
_arenas: Dict[str, object] = {}
_arena_lock = threading.Lock()


def get_node_arena(shm_dir: str, capacity: Optional[int] = None):
    """Attach (creating once per node, creation-raced via an O_EXCL claim
    file) the node's native arena; None when the native lib is unavailable or
    creation failed (callers fall back to per-object files — a None result is
    cached so a broken arena never stalls the put path again)."""
    import time

    from ray_tpu_torch._native import available, Arena

    if not available():
        return None
    path = os.path.join(shm_dir, ARENA_FILENAME)
    with _arena_lock:
        if path in _arenas:  # may be a cached None (permanent fallback)
            return _arenas[path]
    arena = None
    try:
        arena = _create_or_attach_arena(path, capacity)
    except OSError:
        arena = None
    with _arena_lock:
        if path in _arenas and _arenas[path] is not None:
            if arena is not None and arena is not _arenas[path]:
                arena.detach()  # lost the caching race
            return _arenas[path]
        _arenas[path] = arena
        return arena


def _create_or_attach_arena(path: str, capacity: Optional[int]):
    """Claim-or-wait creation protocol. Runs WITHOUT the module lock (the
    wait must not block other arenas' operations); handles a creator that died
    between claiming and publishing by retiring the stale claim once."""
    import time

    from ray_tpu_torch._native import Arena

    ready = path + ".ready"
    claim = path + ".init"
    for attempt in range(2):
        if os.path.exists(ready):
            return Arena(path)
        if capacity is None:
            from ray_tpu_torch._private.config import get_config

            cfg = get_config()
            capacity = cfg.object_arena_bytes or cfg.object_store_memory
        try:
            fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            Arena(path, create_capacity=capacity).detach()
            with open(ready, "w") as f:
                f.write("1")
            return Arena(path)
        except FileExistsError:
            deadline = time.time() + 10
            while not os.path.exists(ready):
                if time.time() > deadline:
                    # Creator likely died mid-creation: retire the stale claim
                    # (and any partial arena file) and retry once.
                    for p in (claim, path):
                        try:
                            os.unlink(p)
                        except OSError:
                            pass
                    break
                time.sleep(0.02)
            else:
                return Arena(path)
    return None


def write_arena_object(arena, arena_path: str, sv: SerializedValue) -> Optional[ObjectMeta]:
    """Place `sv` into the node arena; None when the arena is full (caller
    falls back to a per-object file segment)."""
    header = 8 + len(sv.inband)
    layout: List[Tuple[int, int]] = []
    offset = _align(header)
    for b in sv.buffers:
        layout.append((offset, b.nbytes))
        offset = _align(offset + b.nbytes)
    total = max(offset, header)
    alloc = arena.alloc(total)
    if alloc == 0:
        return None
    view = arena.view(alloc, total)
    view[0:8] = len(sv.inband).to_bytes(8, "little")
    view[8:header] = sv.inband
    for (off, length), buf in zip(layout, sv.buffers):
        view[off:off + length] = buf
    return ObjectMeta(
        object_id=None,  # set by caller
        size=total,
        segment=arena_path,
        buffer_layout=layout,
        arena_offset=alloc,
    )


def write_segment(dir_path: str, object_id: ObjectID, sv: SerializedValue) -> ObjectMeta:
    """Create a segment for `sv` and copy its buffers in (the only copy on the write
    path; readers are zero-copy)."""
    header = 8 + len(sv.inband)
    layout: List[Tuple[int, int]] = []
    offset = _align(header)
    for b in sv.buffers:
        layout.append((offset, b.nbytes))
        offset = _align(offset + b.nbytes)
    total = max(offset, header)
    path = os.path.join(dir_path, object_id.hex())
    seg = SharedSegment(path, size=total, create=True)
    mm = seg.mm
    mm[0:8] = len(sv.inband).to_bytes(8, "little")
    mm[8:header] = sv.inband
    for (off, length), buf in zip(layout, sv.buffers):
        mm[off : off + length] = buf
    seg.close()
    return ObjectMeta(
        object_id=object_id,
        size=total,
        segment=path,
        buffer_layout=layout,
    )


def read_segment(path: str, offset: Optional[int], length: Optional[int]) -> bytes:
    """Read a whole segment file, or an arena allocation's [offset, offset+length)
    slice. The single read used by the head relay, the daemon command path,
    and the peer-direct data server."""
    with open(path, "rb") as f:
        if offset is not None:
            f.seek(offset)
            return f.read(length)
        return f.read()


# Reader-side locality stats (ray_tpu_object_store_reads_total /
# _pull_bytes_total via telemetry.ensure_objectstore_client_metrics): the
# hot read path bumps plain ints; a registry collector publishes deltas.
_READ_STATS = {"local_hits": 0, "cache_hits": 0, "pulls": 0, "pull_bytes": 0}
_collector_installed = False


def _stats_enabled() -> bool:
    # Re-read the config every time (cheap attr read): a shutdown()/init()
    # cycle may flip enable_metrics, and a stale cached verdict here would
    # silently pin the old behavior for the life of the process. Only the
    # collector install is once-per-process.
    global _collector_installed
    try:
        from ray_tpu_torch._private import telemetry

        if not telemetry.metrics_enabled():
            return False
        if not _collector_installed:
            _collector_installed = True
            telemetry.ensure_objectstore_client_metrics()
        return True
    except Exception:  # noqa: BLE001 — stats must never break a read
        return False


def resolve_for_read(store: "LocalObjectStore", meta: ObjectMeta, pull_fn,
                     force_remote: bool, locate_fn=None, transfer=None,
                     priority: Optional[int] = None,
                     replica_fn=None) -> ObjectMeta:
    """Return a meta whose segment is readable from this process, pulling the
    bytes when the segment lives on another node. The single implementation
    behind every reader path (worker task args, driver get, client-driver get)
    so pull semantics cannot drift.

    - Same-node (or same-filesystem) segments are used in place: zero-copy.
    - `force_remote` (Config.force_object_pulls) treats other-node segments as
      unreadable even on a shared filesystem, to exercise the wire path.
    - With a `transfer` (ObjectTransferManager) and `locate_fn(key) ->
      (meta, [(node_id, address), ...])` the bytes stream PEER-DIRECT from a
      holder's data server in bounded chunks (object_transfer.PullManager:
      priority admission, per-key dedup, replica failover); `pull_fn(key) ->
      (meta, bytes)` (head relay) is the fallback.
    - Pulled bytes are cached under the object id in the local store dir;
      later reads hit the cache instead of re-transferring, and `replica_fn`
      (when given) registers this node as a replica in the head's location
      directory so OTHER nodes can pull from here too — and so the head can
      DELETE the cache file when the object is freed. Registration also runs
      on cache hits (a prefetch fills the cache before any blocking read
      reaches this function), deduped per store so a hot object doesn't
      re-announce on every read.
    """
    import dataclasses

    if meta.segment is None:
        return meta
    if failpoints.ENABLED and meta.arena_offset is None:
        # "object.lose_segment": delete the bytes out from under this reader
        # — the deterministic stand-in for a node dying after seal. The read
        # below fails and the caller's reconstruct-from-lineage path runs.
        if failpoints.fire("object.lose_segment"):
            try:
                os.unlink(meta.segment)
            except OSError:
                pass
    remote = force_remote and meta.node_id is not None and meta.node_id != store.node_id
    if not remote and os.path.exists(meta.segment):
        if _stats_enabled():
            _READ_STATS["local_hits"] += 1
        return meta
    # Pulled copies cache under the OBJECT id (arena objects share one file
    # path, so the segment basename isn't unique) as plain file segments.
    local_path = os.path.join(store.shm_dir, meta.object_id.hex())
    if os.path.exists(local_path):
        if _stats_enabled():
            _READ_STATS["cache_hits"] += 1
        _register_replica(store, meta.object_id.binary(), replica_fn)
        return dataclasses.replace(meta, segment=local_path, arena_offset=None)
    fetched: Optional[ObjectMeta] = None
    data: Optional[bytes] = None
    if (
        transfer is not None
        and transfer.enabled
        and locate_fn is not None
        and meta.node_id not in transfer.no_peer_nodes
    ):
        from ray_tpu_torch._private import object_transfer

        try:
            located = locate_fn(meta.object_id.binary())
        except Exception:  # noqa: BLE001 — stale meta etc.: use the relay
            located = None
        if located is not None:
            fresh, locations = located
            if fresh is not None and fresh.segment is None:
                return fresh  # became inline (e.g. error overwrite)
            if fresh is not None:
                try:
                    path = transfer.pull(
                        fresh, locations,
                        object_transfer.PRIORITY_GET if priority is None else priority,
                    )
                except Exception:  # noqa: BLE001 — PullFailed, or any manager
                    # surprise: the peer plane must DEGRADE to the relay, never
                    # turn a readable object into a reader-facing error.
                    path = None
                if path is not None:
                    if _stats_enabled():
                        _READ_STATS["pulls"] += 1
                        _READ_STATS["pull_bytes"] += fresh.size
                    _register_replica(store, fresh.object_id.binary(),
                                      replica_fn)
                    return dataclasses.replace(
                        fresh, segment=path, arena_offset=None
                    )
    fetched, data = pull_fn(meta.object_id.binary())
    if _stats_enabled():
        _READ_STATS["pulls"] += 1
        _READ_STATS["pull_bytes"] += len(data) if data else 0
    if fetched.segment is None:
        return fetched  # became inline (e.g. error overwrite)
    local_path = os.path.join(store.shm_dir, fetched.object_id.hex())
    if not os.path.exists(local_path):
        tmp = f"{local_path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data or b"")
        os.replace(tmp, local_path)
    _register_replica(store, fetched.object_id.binary(), replica_fn)
    return dataclasses.replace(fetched, segment=local_path, arena_offset=None)


def _register_replica(store: "LocalObjectStore", key: bytes,
                      replica_fn) -> None:
    """Tell the head this node caches `key`'s bytes (once per store+key —
    object ids are never reused, so the dedup set needs no eviction). The
    registration makes the copy both a pull source for other nodes and
    reachable by the head's free-time purge."""
    if replica_fn is None or key in store._replicas_announced:
        return
    store._replicas_announced.add(key)
    try:
        replica_fn(key)
    except Exception:  # noqa: BLE001 — bookkeeping only
        pass


# PEP-688 __buffer__ (the pinned zero-copy exporter below) needs 3.12+; on
# older interpreters arena reads copy their buffers out instead — still one
# mapping and no per-object files, just not zero-copy on the read side.
_PINNED_EXPORT = sys.version_info >= (3, 12)


class _PinnedArenaBuffer:
    """Zero-copy buffer exporter that keeps its arena object refcounted while
    any consumer (numpy array, bytes view) is alive — the client half of
    plasma's pin-while-mapped rule (`object_lifecycle_manager.h`)."""

    __slots__ = ("_mv", "_key")

    def __init__(self, mv: memoryview, key: bytes):
        self._mv = mv
        self._key = key
        from ray_tpu_torch._private.worker import _ref_tracker

        _ref_tracker.incref(key)

    def __buffer__(self, flags):
        return self._mv

    def __del__(self):
        try:
            from ray_tpu_torch._private.worker import _ref_tracker

            _ref_tracker.decref(self._key)
        except Exception:
            pass  # interpreter teardown


# Guard for put_serialized's fast inline-meta construction: a field added to
# ObjectMeta without updating it would surface as a late AttributeError.
_fast_meta_fields = {
    "object_id", "size", "inband", "inline_buffers", "segment",
    "buffer_layout", "is_error", "node_id", "arena_offset", "owns_payload",
    "contained_ids", "spilled",
}
assert _fast_meta_fields == set(ObjectMeta.__dataclass_fields__), (
    "put_serialized's fast path is out of sync with ObjectMeta: "
    f"{_fast_meta_fields ^ set(ObjectMeta.__dataclass_fields__)}"
)


class LocalObjectStore:
    """Per-process facade over inline values and shm segments.

    Each process keeps attached segments alive in `_segments` while any
    deserialized view may reference them; the owner decides when to unlink.
    """

    def __init__(self, shm_dir: str, node_id: Optional[bytes] = None):
        self.shm_dir = shm_dir
        # Stamped onto every segment-backed meta this process writes, so remote
        # readers know which node's store to pull from.
        self.node_id = node_id
        os.makedirs(shm_dir, exist_ok=True)
        self._segments: Dict[str, SharedSegment] = {}
        # Object keys whose cached copy this process already announced to the
        # head's replica directory (see resolve_for_read/_register_replica).
        self._replicas_announced: set = set()
        self._lock = threading.Lock()
        # Arena handle cached per store: False = not yet resolved (None is a
        # meaningful "unavailable" result from get_node_arena).
        self._arena: Any = False

    # --- write path ---
    def put_serialized(self, object_id: ObjectID, sv: SerializedValue, inline_threshold: int) -> ObjectMeta:
        contained = sv.contained_ids or None
        if sv.total_size <= inline_threshold or not sv.buffers:
            # An inline value rides in the frame of the message that carries
            # it: one too large for a frame raises here, in its sender.
            if sv.total_size > inline_threshold:
                check_frame(sv.total_size, "an inline value (no out-of-band buffers)",
                            FRAME_HEADROOM)
            # Hot path (every small task result / put): bypass the dataclass
            # __init__'s 12 field assignments (_fast_meta_fields guards the
            # field set at import).
            meta = ObjectMeta.__new__(ObjectMeta)
            meta.__dict__.update(
                object_id=object_id,
                size=sv.total_size,
                inband=sv.inband,
                inline_buffers=[bytes(b) for b in sv.buffers],
                segment=None,
                buffer_layout=None,
                is_error=False,
                node_id=None,
                arena_offset=None,
                owns_payload=True,
                contained_ids=contained,
                spilled=False,
            )
            return meta
        meta = None
        if self._arena is False:  # resolve once per store
            from ray_tpu_torch._private.config import get_config

            # None = auto: arena only where reads can be pinned zero-copy
            # (PEP-688, py3.12+) — the copy fallback turns ~138 GB/s
            # same-node gets into ~10 GB/s, worse than file-segment mmaps.
            # True (tests) forces the arena on regardless.
            want = get_config().use_native_object_arena
            if want is None:
                want = _PINNED_EXPORT
            self._arena = get_node_arena(self.shm_dir) if want else None
        if self._arena is not None:
            meta = write_arena_object(
                self._arena, os.path.join(self.shm_dir, ARENA_FILENAME), sv
            )
            if meta is not None:
                meta.object_id = object_id
        if meta is None:
            # No native lib, arena disabled, or arena full: per-object file.
            meta = write_segment(self.shm_dir, object_id, sv)
        meta.node_id = self.node_id
        meta.contained_ids = contained
        return meta

    def put(self, object_id: ObjectID, value, inline_threshold: int) -> ObjectMeta:
        return self.put_serialized(object_id, serialize(value), inline_threshold)

    # --- read path ---
    def get(self, meta: ObjectMeta):
        if meta.segment is None:
            buffers = [memoryview(b) for b in (meta.inline_buffers or [])]
            return deserialize(meta.inband, buffers)
        if meta.arena_offset is not None:
            arena = get_node_arena(os.path.dirname(meta.segment))
            if arena is None:
                raise OSError(f"native arena unavailable for {meta.segment}")
            mv = arena.view(meta.arena_offset, meta.size)
            inband_len = int.from_bytes(mv[0:8], "little")
            inband = bytes(mv[8 : 8 + inband_len])
            # Unlike unlinked file mmaps (which stay valid for existing views),
            # a freed arena block gets RECYCLED — so zero-copy views must pin
            # the object. Each buffer is wrapped in a PEP-688 exporter that
            # holds a process-local ref until the consuming arrays die; on
            # interpreters without __buffer__ support the bytes are copied
            # out instead (safe without a pin).
            key = meta.object_id.binary()
            if _PINNED_EXPORT:
                buffers = [
                    _PinnedArenaBuffer(mv[off : off + length], key)
                    for off, length in meta.buffer_layout or []
                ]
            else:
                buffers = [
                    bytes(mv[off : off + length])
                    for off, length in meta.buffer_layout or []
                ]
            return deserialize(inband, buffers)
        with self._lock:
            seg = self._segments.get(meta.segment)
            if seg is None:
                seg = SharedSegment(meta.segment)
                self._segments[meta.segment] = seg
        mm = seg.mm
        inband_len = int.from_bytes(mm[0:8], "little")
        inband = mm[8 : 8 + inband_len]
        buffers = [memoryview(mm)[off : off + length] for off, length in meta.buffer_layout or []]
        return deserialize(bytes(inband), buffers)

    # --- lifecycle (owner side) ---
    def free(self, meta: ObjectMeta):
        if meta.segment is None:
            return
        if meta.arena_offset is not None:
            arena = get_node_arena(os.path.dirname(meta.segment))
            if arena is not None:
                arena.free(meta.arena_offset)
            return
        with self._lock:
            seg = self._segments.pop(meta.segment, None)
        if seg is not None:
            seg.close()
        try:
            os.unlink(meta.segment)
        except FileNotFoundError:
            pass

    def detach_all(self):
        with self._lock:
            for seg in self._segments.values():
                seg.close()
            self._segments.clear()
