"""Wire types exchanged between the driver control plane and worker processes.

The reference splits this across protobuf services (`src/ray/protobuf/
core_worker.proto`, `node_manager.proto`) spoken over gRPC. Here a node is a single
machine and the control plane lives in the driver process, so messages are pickled
tuples over `multiprocessing` duplex pipes — payload bytes for large objects never
travel on these pipes (they go through the shared-memory store; see object_store.py).

The wire grammar is MACHINE-READABLE: ``MESSAGE_GRAMMAR`` below is the single
source of truth for every message tag, its tuple arity, its direction, and
the dispatch loops required to handle it. ``ray_tpu.devtools.lint`` (the
protocol-conformance pass) cross-checks every sender site and every reader
dispatch loop in the tree against it, so a tag that is sent-but-unhandled,
handled-but-never-sent, or sent with the wrong arity fails lint (and tier-1,
via tests/test_static_analysis.py). Keep the registry exactly in sync with
the code — that is now enforced, not aspirational.

Batching note: any message below may arrive wrapped in a ``("batch", [msg,
...])`` frame — control messages coalesce per connection (BatchedSender in
batching.py, scheduler-side `_send_to`/`_flush_outbound`). Receivers process
every contained message before running scheduling/wakeup work once; per-
connection FIFO holds because blocking sends flush the batch buffer first.
Config knobs: control_plane_batching / _batch_max_msgs / _batch_max_bytes /
_batch_flush_interval_s.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, ObjectID, PlacementGroupID, TaskID
from ray_tpu_torch._private.object_store import ObjectMeta

# --------------------------------------------------------------------------
# Wire-message registry. PURE LITERAL by design: ray_tpu.devtools.lint reads
# it with ast.literal_eval straight from this file's source, so the linter
# never has to import the runtime (and stays usable in a bare CI venv).
#
# Per tag:
#   dir     -- who speaks it ("worker->head", "head->worker", "daemon->head",
#              "head->daemon", "driver->head", "head->driver", "handshake",
#              "any"); documentation only, not checked.
#   arity   -- (min, max) tuple length INCLUDING the tag. Senders whose
#              message is a static tuple literal are checked against this;
#              dynamically-built tuples (e.g. ("done",) + payload) only
#              register the tag as sent.
#   readers -- dispatcher keys (see DISPATCHERS) that must each handle the
#              tag in their dispatch chain. Empty for handshake messages,
#              which are consumed inline by connection-setup code.
#   doc     -- one-line payload description.
#
# DISPATCHERS maps dispatcher keys to "module:Class.method" of the dispatch
# loop that routes on the tag (the functions the lint pass scans for
# `kind == "..."` / `msg[0] == "..."` comparisons).
# --------------------------------------------------------------------------

DISPATCHERS = {
    "scheduler.worker": "ray_tpu_torch._private.scheduler:Scheduler._on_worker_message",
    "scheduler.daemon": "ray_tpu_torch._private.scheduler:Scheduler._on_daemon_message",
    "scheduler.driver": "ray_tpu_torch._private.scheduler:Scheduler._on_driver_message",
    "worker.reader": "ray_tpu_torch._private.worker_main:WorkerConnection.reader_loop",
    "worker.dispatch": "ray_tpu_torch._private.worker_main:WorkerConnection._dispatch",
    "driver.misc": "ray_tpu_torch._private.worker:RemoteDriverContext._on_misc",
    "daemon.dispatch": "ray_tpu_torch._private.node_daemon:NodeDaemon._dispatch",
    # Peer-to-peer data plane (object_transfer.py): the pusher's per-conn
    # reader (begin/ack/cancel in) and the puller's peer reader (chunk/end in).
    "transfer.push": "ray_tpu_torch._private.object_transfer:PushEndpoint._dispatch",
    "transfer.pull": "ray_tpu_torch._private.object_transfer:_PeerConnection._reader_loop",
}

MESSAGE_GRAMMAR = {
    # ---- worker/driver -> head -------------------------------------------
    "register": {
        "dir": "worker->head", "arity": (3, 3),
        "readers": ("scheduler.worker",),
        "doc": "(worker_id_hex, pid) — worker announces itself on its conn",
    },
    "done": {
        "dir": "worker->head", "arity": (4, 5),
        "readers": ("scheduler.worker",),
        "doc": "(task_id_bytes, ok, result_metas[, stage_ts]) — stage_ts "
               "(args_fetched/exec_start/exec_end/result_stored) rides along "
               "when enable_timeline/enable_metrics is on; readers treat the "
               "5th element as optional",
    },
    "req": {
        "dir": "worker+driver->head", "arity": (4, 4),
        "readers": ("scheduler.worker", "scheduler.driver"),
        "doc": "(req_id, method, payload) — blocking control-plane RPC",
    },
    "cmd": {
        "dir": "worker+driver->head", "arity": (3, 3),
        "readers": ("scheduler.worker", "scheduler.driver"),
        "doc": "(method, payload) — one-way request, no ack (pipelined submits)",
    },
    "stream": {
        "dir": "worker->head", "arity": (4, 4),
        "readers": ("scheduler.worker",),
        "doc": "(task_id_bytes, index, meta) — generator task item sealed",
    },
    "log": {
        "dir": "worker->head", "arity": (6, 6),
        "readers": ("scheduler.worker",),
        "doc": "(worker_id_hex, pid, stream, task_name, lines) — stdout/err ship",
    },
    "ref_ops": {
        "dir": "worker+driver->head", "arity": (2, 2),
        "readers": ("scheduler.worker", "scheduler.driver"),
        "doc": "([(op, key), ...],) — batched refcount ops",
    },
    "object_data": {
        "dir": "any->head", "arity": (4, 4),
        "readers": ("scheduler.daemon", "scheduler.driver"),
        "doc": "(token, ok, data) — reply to a read_object pull",
    },
    "heartbeat": {
        "dir": "any->head", "arity": (1, 1),
        "readers": ("scheduler.worker", "scheduler.daemon"),
        "doc": "() — liveness beat from a worker/daemon (the connection "
               "identifies the peer); the scheduler's staleness detector "
               "drives the ALIVE -> SUSPECT -> DEAD transitions "
               "(health_check_period_ms / health_check_failure_threshold)",
    },
    "stacks_data": {
        "dir": "any->head", "arity": (3, 3),
        "readers": ("scheduler.worker", "scheduler.daemon"),
        "doc": "(token, payload) — all-thread stack dump reply (in-band from "
               "the peer's dispatch thread, or a daemon tailing back a "
               "SIGUSR1 faulthandler dump for a wedged worker)",
    },
    "profile_data": {
        "dir": "any->head", "arity": (3, 3),
        "readers": ("scheduler.worker", "scheduler.daemon"),
        "doc": "(token, payload) — sampling-profiler folded stacks reply "
               "to a profile_stop",
    },
    # ---- daemon -> head ---------------------------------------------------
    "worker_exit": {
        "dir": "daemon->head", "arity": (2, 2),
        "readers": ("scheduler.daemon",),
        "doc": "(worker_id_hex,) — a daemon-managed worker process exited",
    },
    "spawn_failed": {
        "dir": "daemon->head", "arity": (3, 3),
        "readers": ("scheduler.daemon",),
        "doc": "(worker_id_hex, error_repr) — spawn_worker exec failed",
    },
    "memory_pressure": {
        "dir": "daemon->head", "arity": (3, 3),
        "readers": ("scheduler.daemon",),
        "doc": "(used_bytes, total_bytes) — node crossed the memory threshold",
    },
    # ---- head -> worker ---------------------------------------------------
    "exec": {
        "dir": "head->worker", "arity": (2, 2),
        "readers": ("worker.dispatch",),
        "doc": "(ExecRequest,) — task pushed to a leased worker",
    },
    "resp": {
        "dir": "head->worker", "arity": (4, 4),
        "readers": ("worker.dispatch",),
        "doc": "(req_id, ok, payload) — reply to a blocking req",
    },
    "cancel_queued": {
        "dir": "head->worker", "arity": (2, 2),
        "readers": ("worker.dispatch",),
        "doc": "(task_id_bytes,) — drop a lease-queued task unrun",
    },
    "shutdown": {
        "dir": "head->any", "arity": (1, 1),
        "readers": ("worker.dispatch", "daemon.dispatch"),
        "doc": "() — orderly teardown of a worker/daemon connection",
    },
    # ---- introspection (head fan-out; see util/state.stacks/profile) ------
    "dump_stacks": {
        "dir": "head->any", "arity": (2, 2),
        "readers": ("worker.dispatch", "daemon.dispatch"),
        "doc": "(token,) — request an all-thread stack dump; the peer's "
               "reader/dispatch thread replies stacks_data (it stays "
               "responsive while the main thread runs user code)",
    },
    "profile_start": {
        "dir": "head->any", "arity": (2, 2),
        "readers": ("worker.dispatch", "daemon.dispatch"),
        "doc": "(hz,) — start the process-local sampling profiler "
               "(profiler.py); never sent when enable_profiler is off",
    },
    "profile_stop": {
        "dir": "head->any", "arity": (2, 2),
        "readers": ("worker.dispatch", "daemon.dispatch"),
        "doc": "(token,) — stop the sampler; the peer replies profile_data "
               "with its folded stacks",
    },
    # ---- head -> driver ---------------------------------------------------
    "pub": {
        "dir": "head->driver", "arity": (3, 3),
        "readers": ("driver.misc",),
        "doc": "(channel, payload) — pubsub push (logs/errors channels)",
    },
    # ---- object location directory (data plane control) ------------------
    "locate_object": {
        "dir": "any->head", "arity": (3, 3),
        "readers": ("scheduler.worker", "scheduler.driver"),
        "doc": "(token, [object_key, ...]) — batched location query: where do "
               "these objects' bytes live? The head answers object_locations; "
               "it never moves payload bytes for peer-served objects",
    },
    "object_locations": {
        "dir": "head->any", "arity": (3, 3),
        "readers": ("worker.dispatch", "driver.misc"),
        "doc": "(token, {key: (meta, [(node_id, data_address), ...])}) — "
               "owner-first locations (replicas after); address None means "
               "the holder has no data server (relay is the only route)",
    },
    # ---- ownership decentralization (head -> owner seal forwarding) ------
    "own_meta": {
        "dir": "head->owner", "arity": (2, 2),
        "readers": ("worker.dispatch", "driver.misc"),
        "doc": "(meta,) — a sealed ObjectMeta forwarded to the process that "
               "OWNS the object (submitted its task): the owner's "
               "OwnershipTable is the record of truth, so its local gets "
               "resolve in-process without a head round trip. Coalesces "
               "into batch frames like any control message",
    },
    # ---- peer-to-peer chunked transfers (node<->node, bypassing the head) -
    "transfer_begin": {
        "dir": "puller->pusher", "arity": (6, 6),
        "readers": ("transfer.push",),
        "doc": "(req_id, path, offset, length, chunk_bytes) — start streaming "
               "a segment/arena slice in chunk_bytes pieces. path is absolute "
               "for the owner's segment; a store-RELATIVE object-id name asks "
               "a replica for its cache file (resolved under its store dir)",
    },
    "transfer_ack": {
        "dir": "puller->pusher", "arity": (3, 3),
        "readers": ("transfer.push",),
        "doc": "(req_id, seq) — chunk received; refills the pusher's bounded "
               "outstanding-chunk window (transfer_window_chunks)",
    },
    "transfer_cancel": {
        "dir": "puller->pusher", "arity": (2, 2),
        "readers": ("transfer.push",),
        "doc": "(req_id,) — abandon an in-flight transfer (pull cancelled or "
               "timed out); the pusher drops its state",
    },
    "transfer_chunk": {
        "dir": "pusher->puller", "arity": (4, 4),
        "readers": ("transfer.pull",),
        "doc": "(req_id, seq, nbytes) — chunk header; the payload follows as "
               "one RAW (unpickled) frame. Written at seq*chunk_bytes on the "
               "puller (positional reassembly: dups are idempotent, a drop "
               "surfaces as a byte-count mismatch at transfer_end)",
    },
    "transfer_end": {
        "dir": "pusher->puller", "arity": (4, 4),
        "readers": ("transfer.pull",),
        "doc": "(req_id, ok, err_repr) — transfer complete (sent after the "
               "final chunk; FIFO puts it behind every chunk) or failed",
    },
    # ---- head -> daemon/driver data plane (relay fallback) ---------------
    "read_object": {
        "dir": "head->source", "arity": (3, 5),
        "readers": ("daemon.dispatch", "driver.misc"),
        "doc": "(token, path[, offset, length]) — serve a segment read for a "
               "relayed pull; offset/length present for arena-backed objects",
    },
    "delete_object": {
        "dir": "head->source", "arity": (2, 3),
        "readers": ("daemon.dispatch", "driver.misc"),
        "doc": "(path[, arena_offset]) — free a sealed segment at its owner",
    },
    # ---- Serve ingress tier (proxy service directory + graceful drain) ----
    "serve_proxy_up": {
        "dir": "worker->head", "arity": (2, 2),
        "readers": ("scheduler.worker",),
        "doc": "({proxy_id, node_id, port, pid},) — a Serve HTTP proxy bound "
               "its listener: register it in the head's service directory so "
               "ingress endpoints are discoverable cluster-wide (the "
               "reference's per-node HTTPProxy set in http_state.py)",
    },
    "serve_proxy_down": {
        "dir": "worker->head", "arity": (2, 2),
        "readers": ("scheduler.worker",),
        "doc": "(proxy_id,) — proxy withdrew from the service directory "
               "(draining or stopping); clients should stop dialing it. "
               "Worker death prunes the entry implicitly",
    },
    "serve_drain": {
        "dir": "head->worker", "arity": (3, 3),
        "readers": ("worker.dispatch",),
        "doc": "(token, deadline_s) — begin graceful drain of the Serve "
               "actor hosted by this worker (proxy or replica): it stops "
               "ACCEPTING new work immediately (the flag is set by the "
               "reader thread, in-band — an actor call could never overtake "
               "the very requests being drained) and finishes its in-flight "
               "window; replies serve_drained when idle or at the deadline",
    },
    "serve_drained": {
        "dir": "worker->head", "arity": (4, 4),
        "readers": ("scheduler.worker",),
        "doc": "(token, ok, inflight) — drain finished (ok=True, idle) or "
               "timed out with `inflight` requests still running",
    },
    # ---- head -> daemon ---------------------------------------------------
    "spawn_worker": {
        "dir": "head->daemon", "arity": (2, 2),
        "readers": ("daemon.dispatch",),
        "doc": "({worker_id_hex, args_blob[, container_env]},) — exec a worker",
    },
    "kill_worker": {
        "dir": "head->daemon", "arity": (2, 2),
        "readers": ("daemon.dispatch",),
        "doc": "(worker_id_hex,) — kill a daemon-managed worker process",
    },
    "dump_worker_oob": {
        "dir": "head->daemon", "arity": (3, 3),
        "readers": ("daemon.dispatch",),
        "doc": "(token, worker_id_hex) — out-of-band stack capture for a "
               "worker that did not answer dump_stacks: the daemon sends "
               "SIGUSR1 (faulthandler dump to the worker's stack file) and "
               "tails the file back as stacks_data",
    },
    # ---- batching ---------------------------------------------------------
    "batch": {
        "dir": "any", "arity": (2, 2),
        "readers": ("scheduler.worker", "scheduler.daemon", "scheduler.driver",
                    "worker.reader", "daemon.dispatch", "transfer.push"),
        "doc": "([msg, ...],) — micro-batched control frame; receivers apply "
               "every contained message before waking scheduling work once",
    },
    # ---- connection handshakes (consumed inline at accept/connect) -------
    "worker": {
        "dir": "handshake", "arity": (2, 2), "readers": (),
        "doc": "(worker_id_hex,) — first frame on a worker's connect-back",
    },
    "daemon": {
        "dir": "handshake", "arity": (2, 2), "readers": (),
        "doc": "({resources, labels, shm_dir, data_address},) — daemon hello",
    },
    "driver": {
        "dir": "handshake", "arity": (2, 2), "readers": (),
        "doc": "({pull_node_id},) — client-mode driver hello",
    },
    "ok": {
        "dir": "handshake", "arity": (2, 4), "readers": (),
        "doc": "(payload, ...) — registration accepted (daemon: node_id_hex + "
               "monitor settings; driver: session info dict)",
    },
}

# --------------------------------------------------------------------------
# Per-connection SESSION machine. MESSAGE_GRAMMAR pins each tag's shape;
# this spec pins the STATEFUL rules between tags — which role may speak
# which tag, which request expects which reply (token-paired), and which
# tags form a streaming sequence. PURE LITERAL like the grammar: the static
# checker (`python -m ray_tpu.devtools.verify`, pass `session`) reads it
# with ast.literal_eval and cross-checks every sender site's module role and
# the spec's own coherence against the grammar; the runtime conformance
# monitor (`_private/session_monitor.py`, armed by RAY_TPU_TORCH_DEBUG_INVARIANTS)
# is compiled from the same spec and flags out-of-state frames live —
# a reply whose token was never requested, a transfer_chunk for a stream
# that never saw transfer_begin, a tag arriving at a dispatcher the grammar
# does not route it to.
#
#   module_roles -- which protocol role(s) each sender module speaks; the
#                   sender side of a tag's "dir" ("worker" of "worker->head",
#                   split on "+" for multi-role tags, "any"/"handshake"
#                   always allowed) must intersect the module's roles.
#   pairs        -- request tag -> its reply tag. token_elem is the tuple
#                   index (on both sides) carrying the correlation token;
#                   the runtime monitor flags replies with unknown tokens.
#   streams      -- named streaming sequences: `open` starts a keyed stream
#                   (key_elem indexes the stream id in every frame), `data`
#                   tags may only refer to a key the endpoint has seen
#                   opened, `close` tags retire it (late data frames for a
#                   RETIRED key stay legal: acks/chunks drain in flight).
# --------------------------------------------------------------------------

SESSION_SPEC = {
    "module_roles": {
        "scheduler.py": ("head",),
        "head.py": ("head",),
        "worker_main.py": ("worker",),
        "worker_entry.py": ("worker",),
        "worker.py": ("driver",),
        "node_daemon.py": ("daemon",),
        # Generic transport: BatchedSender wraps ANY buffered message in
        # ("batch", ...) frames; it never originates a protocol tag itself.
        "batching.py": ("any",),
        # The data plane runs in every reader/server process: pull side
        # speaks puller tags, push side pusher tags (+ location queries,
        # which the grammar marks any->head).
        "object_transfer.py": ("puller", "pusher"),
    },
    "pairs": {
        "req": {"reply": "resp", "token_elem": 1},
        "dump_stacks": {"reply": "stacks_data", "token_elem": 1},
        "profile_stop": {"reply": "profile_data", "token_elem": 1},
        "locate_object": {"reply": "object_locations", "token_elem": 1},
        "read_object": {"reply": "object_data", "token_elem": 1},
        "serve_drain": {"reply": "serve_drained", "token_elem": 1},
    },
    "streams": {
        "transfer": {
            "open": "transfer_begin",
            "data": ("transfer_chunk", "transfer_ack"),
            "close": ("transfer_end", "transfer_cancel"),
            "key_elem": 1,
        },
    },
}


@dataclass
class FunctionDescriptor:
    """Identifies a pickled function/class in the GCS function table, so each worker
    deserializes it once and caches it (reference: function table keyed by
    function_id in `_private/function_manager.py`)."""

    function_id: str  # sha1 of the pickled blob
    name: str


@dataclass
class TaskSpec:
    """The analogue of the reference's `TaskSpecification`
    (`src/ray/common/task/task_spec.h`)."""

    task_id: TaskID
    func: FunctionDescriptor
    num_returns: int = 1
    # Generator tasks (reference: `num_returns="dynamic"` / streaming generators,
    # `python/ray/_raylet.pyx:174 ObjectRefGenerator`):
    #   None        — fixed num_returns
    #   "dynamic"   — task returns an iterable; each yielded value becomes an
    #                 object at return index 2+i, and index 1 holds a picklable
    #                 DynamicObjectRefGenerator listing the refs (resolved when
    #                 the task finishes).
    #   "streaming" — the caller gets an ObjectRefGenerator immediately; items
    #                 become consumable as the worker seals them, before the
    #                 task finishes.
    returns_mode: Optional[str] = None
    # For streaming tasks: the producer pauses when it is more than this many
    # items ahead of the consumer (reference:
    # `_generator_backpressure_num_objects` in `_raylet.pyx`). None = unbounded.
    generator_backpressure: Optional[int] = None
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: int = 0
    # Actor fields
    actor_id: Optional[ActorID] = None
    is_actor_creation: bool = False
    method_name: Optional[str] = None
    # >1 on the creation spec makes the actor threaded: calls run on a bounded
    # pool, out of order (reference: threaded actors /
    # `transport/concurrency_group_manager.h`); async def methods additionally
    # interleave on the actor's event loop.
    max_concurrency: int = 1
    # Named concurrency groups on the creation spec: {"io": 2, "compute": 4}
    # gives each group its own bounded call-thread pool, isolated from the
    # default pool (reference: `transport/concurrency_group_manager.h` —
    # a saturated group must not block calls routed to another).
    concurrency_groups: Optional[Dict[str, int]] = None
    # On a method-call spec: route this call to the named group's pool.
    concurrency_group: Optional[str] = None
    # Scheduling
    scheduling_strategy: Any = None
    placement_group_id: Optional[PlacementGroupID] = None
    placement_group_bundle_index: int = -1
    name: str = ""
    # Runtime env: env_vars apply per task; the rest (pip/working_dir/
    # py_modules) provisions a dedicated per-env worker pool
    # (reference: `_private/runtime_env/`, dedicated workers in worker_pool.h).
    env_vars: Dict[str, str] = field(default_factory=dict)
    runtime_env: Optional[Dict[str, Any]] = None
    # Tracing context propagated caller -> worker (util/tracing.py); the
    # execute-side span becomes a child of the caller's submit span.
    trace_context: Optional[Dict[str, str]] = None
    # Caller-side submission wall time: the "submit" stage of the task-event
    # pipeline (specs are built at the submit call site in every path —
    # remote(), actor method calls, actor creation).
    submitted_ts: float = field(default_factory=time.time)


@dataclass
class ExecRequest:
    """A task pushed to a leased worker (reference: `CoreWorkerService.PushTask`)."""

    spec: TaskSpec
    # Resolved top-level args: each is either ("meta", ObjectMeta) for an object-store
    # arg or ("ref", object_id_bytes) — refs stay refs only when nested, so top-level
    # entries here are always metas. kwargs likewise.
    arg_metas: List[ObjectMeta]
    kwarg_metas: Dict[str, ObjectMeta]
    # Function blob rides along the first time a worker sees this function_id.
    func_blob: Optional[bytes] = None
    # Return object ids (assigned by the submitter).
    return_ids: List[ObjectID] = field(default_factory=list)
