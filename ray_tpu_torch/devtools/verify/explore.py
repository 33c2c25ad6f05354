"""rt-state side B: systematic interleaving exploration of the control plane.

The static pass (`devtools/pass_lifecycle.py`) proves every state WRITE is a
declared transition; this module explores whether legal-looking handler code
reaches illegal states under reordered delivery and crashes. It runs the REAL
`Scheduler` handler methods single-threaded against a virtual harness:

  * `Scheduler(virtual=True)` builds the full in-memory control plane but
    binds no listeners and is never `start()`ed. The harness claims the loop
    thread (`_loop_tid`) so every `@loop_thread_only` handler runs inline.
  * The batched-send seam (`_send_to` -> `_flush_outbound` ->
    `conn.send_bytes`) is intercepted by `VirtualConn`: outbound frames are
    decoded and fed to small peer models (worker / daemon) whose replies
    become *pending delivery events* instead of being applied immediately.
  * The explorer then permutes the schedule: per-peer FIFO delivery queues
    (channel order is preserved, cross-channel order is not) plus global
    events (worker crash, heartbeat verdict, drain-deadline sweep). Each
    schedule re-executes the scenario from scratch (stateless model
    checking), so any prefix of event keys replays deterministically.
  * Exploration is a bounded DFS with a sleep-set partial-order reduction:
    deliveries from distinct peers are treated as independent (they commute
    up to bookkeeping our invariants do not observe), so only one order per
    such pair is explored; anything involving a global event or a shared
    FIFO is explored in every order. The reduction is a heuristic static
    independence relation, not a proof — the planted-bug tests in
    `tests/test_explore.py` pin that the orders that matter stay explored.

Checked after every delivery and at quiescence:
  * lifecycle legality — `_private/lifecycle.py` runtime monitor armed; an
    undeclared transition raises inside the handler and fails the schedule.
  * no lost task — every submitted task reaches a terminal state once no
    events remain (a PENDING/RUNNING task at quiescence can never finish).
  * no double seal — at most one non-error seal per object id.
  * eventual quiescence — every schedule drains within a step budget.

Scenario families (`SCENARIOS`): submit-vs-worker-death (lease-pipelined
tasks racing a worker crash and a SUSPECT verdict), seal-vs-owner-death (a
worker-submitted child task racing its owner's crash), heartbeat-verdict-vs-
rejoin (staleness detector racing a late daemon heartbeat), drain-vs-kill
(graceful serve drain racing the target's death and the deadline sweep).

Interesting schedules persist one JSON per scenario: `run_sweep` replays the
stored corpus first, then explores fresh. The checked-in corpus under
`tools/explore_corpus/` is only read; a sweep over it stores into the port's
own `OWN_CORPUS_DIR`, which is read first. Schedules are plain event-key lists, so a corpus
entry reproduces across processes: `replay(scenario, schedule)`.
"""

from __future__ import annotations

import json
import os
import random
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import lifecycle, serialization
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.gcs import GCS
from ray_tpu_torch._private.ids import ActorID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_store import ObjectMeta
from ray_tpu_torch._private.protocol import ExecRequest, FunctionDescriptor, TaskSpec
from ray_tpu_torch._private.scheduler import (
    ActorRecord,
    DaemonHandle,
    Scheduler,
    WorkerHandle,
    fast_task_record,
)

DEFAULT_SEED = 20260807
DEFAULT_BUDGET = 400
MAX_STEPS = 64

# __file__ = <root>/ray_tpu_torch/devtools/verify/explore.py -> <root>/tools/...
# The checked-in corpus beside the package (tools/explore_corpus/, stored by
# the JAX package's sweeps; its schedules replay against this scheduler too):
# read, never written.
CORPUS_DIR = os.path.join(
    os.path.dirname(
        os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
    ),
    "tools",
    "explore_corpus",
)
_SHARED_CORPUS_DIR = CORPUS_DIR
# The port's own corpus: where a sweep over the shared one stores its
# schedules, and read before the shared one.
OWN_CORPUS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "explore_corpus")


# --------------------------------------------------------------------- virtual pieces
class _VirtualProc:
    """Quacks like _Proc for a worker that exists only in the harness."""

    pid = -1

    def __init__(self):
        self._alive = True

    def is_alive(self) -> bool:
        return self._alive

    def terminate(self) -> None:
        self._alive = False

    def join(self, timeout: Optional[float] = None) -> None:
        pass

    def mark_dead(self) -> None:
        self._alive = False


class VirtualConn:
    """The send-seam intercept. `send_bytes` decodes the frame and hands it
    to the harness peer model synchronously; the model only ENQUEUES reply
    events (it never calls back into the scheduler), so handler re-entrancy
    cannot occur. After `close()` sends raise OSError, which drives the
    scheduler's real send-failure -> death path."""

    def __init__(self, harness: "Harness", peer: str):
        self.harness = harness
        self.peer = peer
        self.closed = False

    def fileno(self) -> int:
        return -1  # selector registration fails -> swallowed by _watch_conn

    def send_bytes(self, data: bytes) -> None:
        if self.closed:
            raise OSError(f"virtual conn to {self.peer} closed")
        self.harness._on_frame(self.peer, serialization.loads(data))

    def poll(self, *_a) -> bool:
        return False

    def recv_bytes(self) -> bytes:
        raise EOFError

    def close(self) -> None:
        self.closed = True


class VirtualScheduler(Scheduler):
    """Scheduler(virtual=True) + deterministic worker spawning through the
    harness + seal accounting for the no-double-seal invariant. Planted-bug
    fixtures subclass THIS (see tests/test_explore.py) and are passed to
    explore(sched_cls=...)."""

    harness: Optional["Harness"] = None

    def _spawn_worker(self, node, actor_id=None, env_vars=None,
                      runtime_env=None) -> WorkerHandle:
        h = self.harness
        h.spawn_seq += 1
        from ray_tpu_torch._private.runtime_env import env_hash as _renv_hash

        worker_id = WorkerID(h.spawn_seq.to_bytes(WorkerID.SIZE, "little"))
        wh = WorkerHandle(
            worker_id=worker_id,
            node_id=node.node_id,
            process=_VirtualProc(),
            state="idle" if actor_id is None else "busy",
            actor_id=actor_id,
            env_hash=_renv_hash(runtime_env),
        )
        node.workers[worker_id] = wh
        self._workers_by_id[worker_id.hex()] = wh
        if actor_id is None:
            node.idle.append(worker_id)
        h.register_worker(wh)
        return wh

    def _seal_object(self, meta: ObjectMeta):
        h = self.harness
        if h is not None and not meta.is_error:
            key = meta.object_id.binary()
            h.seal_counts[key] = h.seal_counts.get(key, 0) + 1
        return super()._seal_object(meta)


# --------------------------------------------------------------------- harness
class Harness:
    """One virtual cluster for one schedule execution. Owns the event
    queues; `fire(key)` applies one event through the real handlers and then
    runs a scheduling pass + outbound flush, exactly like one loop tick."""

    def __init__(self, sched_cls=VirtualScheduler):
        cfg = Config()
        cfg.enable_metrics = False
        cfg.enable_obs = False
        cfg.memory_monitor_refresh_ms = 0
        cfg.log_to_driver = False
        self.sched = sched_cls(
            GCS(), cfg, session_dir="/nonexistent/rt-explore", virtual=True
        )
        self.sched.harness = self
        self.sched._loop_tid = threading.get_ident()
        self.spawn_seq = 0
        self.workers: Dict[str, WorkerHandle] = {}
        self.conns: Dict[str, VirtualConn] = {}
        # Per-peer FIFO of (event_key, thunk): only the head is deliverable.
        self.channels: Dict[str, deque] = {}
        # Global one-shot events (crash / verdict / sweep), armed by scenarios.
        self.globals_: Dict[str, Callable[[], None]] = {}
        self.crashed: set = set()
        self.seal_counts: Dict[bytes, int] = {}
        self.violations: List[str] = []
        # Per-task exec hooks: first byte of task id -> hook(h, peer, req),
        # run before the default done reply is queued (scenario scaffolding).
        self.exec_hooks: Dict[int, Callable] = {}
        # Virtual clock for the heartbeat scenarios (seconds since setup).
        self.vclock = 0.0
        self._prev_lifecycle_enabled = lifecycle.ENABLED
        lifecycle.reset()
        lifecycle.ENABLED = True

    # -- lifecycle of the harness itself
    def close(self) -> None:
        lifecycle.ENABLED = self._prev_lifecycle_enabled
        lifecycle.reset()
        s = self.sched
        for sock in (s._wake_r, s._wake_w, s._urgent_r, s._urgent_w):
            try:
                sock.close()
            except OSError:
                pass
        try:
            s._selector.close()
        except OSError:
            pass

    # -- cluster construction helpers (scenario scaffolding)
    def add_node(self, resources: Dict[str, float]) -> NodeID:
        return self.sched._cmd_add_node((resources, {}))

    def add_daemon_node(self, resources: Dict[str, float]):
        nid = self.add_node(resources)
        node = self.sched.nodes[nid]
        name = "d%d" % (len(self.conns) + 1)
        conn = VirtualConn(self, name)
        self.conns[name] = conn
        daemon = DaemonHandle(nid, conn)
        node.daemon = daemon
        self.sched._conn_to_daemon[conn] = daemon
        return nid, daemon

    def make_record(self, idx: int, max_retries: int = 0,
                    resources: Optional[Dict[str, float]] = None):
        tid = TaskID(bytes([idx]) * TaskID.SIZE)
        spec = TaskSpec(
            task_id=tid,
            func=FunctionDescriptor("fid", "f"),
            resources={"CPU": 1.0} if resources is None else resources,
            max_retries=max_retries,
        )
        return fast_task_record(
            spec, (), {}, [ObjectID.for_return(tid, 1)], b"blob", max_retries
        )

    def submit(self, idx: int, max_retries: int = 0) -> None:
        self.sched._cmd_submit(self.make_record(idx, max_retries))

    def register_worker(self, wh: WorkerHandle) -> None:
        name = "w%d" % self.spawn_seq
        conn = VirtualConn(self, name)
        self.workers[name] = wh
        self.conns[name] = conn
        self.channels.setdefault(name, deque())
        wh.attach(conn)
        self.sched._conn_to_worker[conn] = wh
        self.sched._watch_conn(conn)

    # -- peer models: decode outbound frames, enqueue reply events
    def _on_frame(self, peer: str, msg) -> None:
        if msg[0] == "batch":
            for m in msg[1]:
                self._on_frame(peer, m)
            return
        if peer not in self.workers:
            return  # daemon model: ignores shutdown/stacks/etc.
        kind = msg[0]
        if kind == "exec":
            req: ExecRequest = msg[1]
            tid = req.spec.task_id
            hook = self.exec_hooks.get(tid.binary()[0])
            if hook is not None:
                hook(self, peer, req)
            payload = b"result:" + tid.hex().encode()
            metas = [
                ObjectMeta(object_id=oid, size=len(payload), inband=payload)
                for oid in req.return_ids
            ]
            self.queue_delivery(
                peer,
                "deliver:%s:done:t%d" % (peer, tid.binary()[0]),
                lambda wh=self.workers[peer], t=tid, m=metas: (
                    self.sched._on_worker_message(wh, ("done", t.binary(), True, m))
                ),
            )
        elif kind == "serve_drain":
            token = msg[1]
            self.queue_delivery(
                peer,
                "deliver:%s:drained:%d" % (peer, token),
                lambda wh=self.workers[peer], tok=token: (
                    self.sched._on_worker_message(
                        wh, ("serve_drained", tok, True, 0)
                    )
                ),
            )
        # cancel_queued / own_meta / stacks / shutdown / resp: no reply.

    # -- event plumbing
    def queue_delivery(self, peer: str, key: str, thunk: Callable[[], None],
                       front: bool = False) -> None:
        q = self.channels.setdefault(peer, deque())
        if front:
            q.appendleft((key, thunk))
        else:
            q.append((key, thunk))

    def arm(self, key: str, thunk: Callable[[], None]) -> None:
        self.globals_[key] = thunk

    def arm_crash(self, name: str) -> None:
        self.arm("crash:%s" % name, lambda n=name: self._crash(n))

    def _crash(self, name: str) -> None:
        wh = self.workers[name]
        self.crashed.add(name)
        self.channels[name].clear()
        self.conns[name].closed = True
        wh.process.mark_dead()
        self.sched._on_worker_death(wh)

    def hb_check(self, vnow: float) -> None:
        """Run the staleness detector at virtual time `vnow` (seconds after
        setup). The throttle is reset so each armed verdict actually runs."""
        self.vclock = max(self.vclock, vnow)
        self.sched._last_hb_check = 0.0
        self.sched._check_heartbeats(self.t0 + vnow)

    t0 = 0.0  # stamped by scenarios that use the virtual clock

    def enabled(self) -> List[str]:
        keys = [
            q[0][0]
            for peer, q in self.channels.items()
            if q and peer not in self.crashed
        ]
        keys.extend(self.globals_.keys())
        return sorted(keys)

    def fire(self, key: str) -> bool:
        thunk = self.globals_.pop(key, None)
        if thunk is None:
            for peer, q in self.channels.items():
                if q and peer not in self.crashed and q[0][0] == key:
                    thunk = q.popleft()[1]
                    break
        if thunk is None:
            return False
        try:
            thunk()
            self.sched._schedule()
            self.sched._flush_outbound()
        except AssertionError as e:
            self.violations.append("%s: %s" % (key, e))
        except Exception as e:  # noqa: BLE001 - a handler crash IS a finding
            self.violations.append(
                "%s: handler raised %s: %s" % (key, type(e).__name__, e)
            )
        return True

    def settle(self) -> None:
        """Initial scheduling pass + flush (the part of the schedule that is
        not permuted: submission order is fixed by the scenario)."""
        try:
            self.sched._schedule()
            self.sched._flush_outbound()
        except AssertionError as e:
            self.violations.append("settle: %s" % e)

    def run_keys(self, keys: List[str]) -> Optional[str]:
        for k in keys:
            if not self.fire(k):
                return "schedule replay mismatch: %r not enabled (have %r)" % (
                    k, self.enabled()
                )
        return None


def base_invariants(h: Harness) -> List[str]:
    """Quiescence invariants shared by every scenario."""
    fails = list(h.violations)
    fails.extend(
        "lifecycle monitor: %s" % v
        for v in lifecycle.violations()
        if not any(v in f for f in fails)
    )
    for key, n in h.seal_counts.items():
        if n > 1:
            fails.append(
                "object %s sealed non-error %d times (double-seal)"
                % (key.hex()[:12], n)
            )
    for rec in h.sched.tasks.values():
        if rec.state in ("PENDING", "RUNNING"):
            fails.append(
                "task t%d stuck %s at quiescence (lost task)"
                % (rec.spec.task_id.binary()[0], rec.state)
            )
    return fails


# --------------------------------------------------------------------- scenarios
class Scenario:
    def __init__(self, name: str, setup: Callable[[Harness], None],
                 check: Optional[Callable[[Harness], List[str]]] = None):
        self.name = name
        self._setup = setup
        self._check = check

    def setup(self, h: Harness) -> None:
        self._setup(h)

    def check(self, h: Harness) -> List[str]:
        fails = base_invariants(h)
        if self._check is not None:
            fails.extend(self._check(h))
        return fails


def _setup_submit_vs_worker_death(h: Harness) -> None:
    # One CPU, two identical tasks -> the second lease-pipelines onto w1's
    # in-flight window. Racing: w1's two done deliveries (FIFO), w1's crash
    # (retries re-dispatch to a fresh worker), and a worker-SUSPECT verdict.
    import time as _time

    h.t0 = _time.time()
    h.add_node({"CPU": 1.0})
    h.submit(1, max_retries=1)
    h.submit(2, max_retries=1)
    h.settle()
    h.arm_crash("w1")
    h.arm("verdict:workers", lambda: h.hb_check(3.0))


def _setup_seal_vs_owner_death(h: Harness) -> None:
    # w1 runs the parent task and, mid-execution, submits a child task it
    # OWNS (cmd submit over its conn, before its own done in the FIFO). The
    # child runs on w2. w1's crash races the child's dispatch and seal:
    # owner death must cancel what it can and tolerate the rest.
    def submit_child(hh: Harness, peer: str, req: ExecRequest) -> None:
        child = hh.make_record(2)
        hh.queue_delivery(
            peer,
            "deliver:%s:submit:t2" % peer,
            lambda wh=hh.workers[peer], rec=child: (
                hh.sched._on_worker_message(wh, ("cmd", "submit", rec))
            ),
        )

    h.exec_hooks[1] = submit_child
    h.add_node({"CPU": 2.0})
    h.submit(1)
    h.settle()
    h.arm_crash("w1")


def _check_seal_vs_owner_death(h: Harness) -> List[str]:
    fails = []
    # A cancelled-by-owner-death child must hold an error seal, never a
    # payload seal racing in afterwards (the late-done guard in
    # _on_task_done): state CANCELLED with a non-error seal is a conflict.
    for rec in h.sched.tasks.values():
        if rec.state == "CANCELLED":
            for oid in rec.return_ids:
                if h.seal_counts.get(oid.binary()):
                    fails.append(
                        "cancelled task t%d has a non-error seal"
                        % rec.spec.task_id.binary()[0]
                    )
    return fails


def _setup_hb_verdict_vs_rejoin(h: Harness) -> None:
    # Daemon-backed node. Verdicts run the real detector at virtual times
    # 2.5s (SUSPECT window: > 2 periods) and 6.0s (> grace of 5s). The
    # daemon's late heartbeat races them; the real handler stamps wall time,
    # so the harness re-stamps to the virtual arrival time (vclock + 1s) —
    # that is the one clock shim, everything else is handler code.
    import time as _time

    h.t0 = _time.time()
    nid, daemon = h.add_daemon_node({"CPU": 1.0})
    h.hb_nid = nid

    def rejoin():
        h.sched._on_daemon_message(daemon, ("heartbeat",))
        node = h.sched.nodes.get(nid)
        if node is not None:
            node.last_heartbeat = h.t0 + h.vclock + 1.0

    h.queue_delivery("d1", "deliver:d1:heartbeat", rejoin)
    h.arm("verdict:suspect", lambda: h.hb_check(2.5))
    h.arm("verdict:dead", lambda: h.hb_check(6.0))


def _check_hb_verdict_vs_rejoin(h: Harness) -> List[str]:
    fails = []
    node = h.sched.nodes.get(h.hb_nid)
    if node is not None and node.health == "DEAD":
        fails.append("node declared DEAD but still in the node table")
    if node is not None and not node.alive:
        fails.append("node marked not-alive but still in the node table")
    return fails


def _setup_drain_vs_kill(h: Harness) -> None:
    # Graceful serve drain of an actor's worker racing that worker's death
    # and the drain-deadline sweep. The reply future must resolve exactly
    # once on every interleaving (reply, death-completes-drain, or timeout).
    import concurrent.futures

    nid = h.add_node({"CPU": 1.0})
    node = h.sched.nodes[nid]
    wh = h.sched._spawn_worker(node, actor_id=None)
    node.idle.remove(wh.worker_id)
    aid = ActorID(bytes([9]) * ActorID.SIZE)
    wh.actor_id = aid
    wh.state = "busy"
    creation = ExecRequest(
        spec=TaskSpec(
            task_id=TaskID(bytes([9]) * TaskID.SIZE),
            func=FunctionDescriptor("fid", "A"),
            actor_id=aid,
            is_actor_creation=True,
        ),
        arg_metas=[],
        kwarg_metas={},
        return_ids=[],
    )
    h.sched.actors[aid] = ActorRecord(
        actor_id=aid, creation_req=creation, resources={},
        worker=wh.worker_id, node=nid, state="ALIVE",
    )
    h.drain_fut = concurrent.futures.Future()
    h.sched._start_serve_drain(aid.binary(), 5.0, ("future", h.drain_fut))
    h.settle()
    h.arm_crash("w1")
    import time as _time

    h.arm(
        "sweep:deadline",
        lambda: h.sched._sweep_serve_drains(_time.time() + 60.0),
    )


def _check_drain_vs_kill(h: Harness) -> List[str]:
    fails = []
    if not h.drain_fut.done():
        fails.append("drain future unresolved at quiescence")
    if h.sched._serve_drains:
        fails.append("drain table non-empty at quiescence")
    return fails


SCENARIOS: Dict[str, Scenario] = {
    "submit_vs_worker_death": Scenario(
        "submit_vs_worker_death", _setup_submit_vs_worker_death
    ),
    "seal_vs_owner_death": Scenario(
        "seal_vs_owner_death", _setup_seal_vs_owner_death,
        _check_seal_vs_owner_death,
    ),
    "hb_verdict_vs_rejoin": Scenario(
        "hb_verdict_vs_rejoin", _setup_hb_verdict_vs_rejoin,
        _check_hb_verdict_vs_rejoin,
    ),
    "drain_vs_kill": Scenario(
        "drain_vs_kill", _setup_drain_vs_kill, _check_drain_vs_kill
    ),
}


# --------------------------------------------------------------------- exploration
class ExploreResult:
    def __init__(self, scenario: str):
        self.scenario = scenario
        self.schedules_run = 0  # harness executions (the budget unit)
        self.complete: List[List[str]] = []  # schedules that reached quiescence
        self.failures: List[Tuple[List[str], List[str]]] = []
        self.truncated = False

    @property
    def ok(self) -> bool:
        return not self.failures


def _peer_of(key: str) -> Optional[str]:
    if key.startswith("deliver:"):
        return key.split(":", 2)[1]
    return None  # crash / verdict / sweep: dependent with everything


def _independent(a: str, b: str) -> bool:
    pa, pb = _peer_of(a), _peer_of(b)
    return pa is not None and pb is not None and pa != pb


def _execute_prefix(scenario: Scenario, prefix: List[str], sched_cls,
                    result: ExploreResult) -> Tuple[Harness, Optional[str]]:
    h = Harness(sched_cls=sched_cls)
    err = None
    try:
        scenario.setup(h)
        err = h.run_keys(prefix)
    except AssertionError as e:
        h.violations.append("setup: %s" % e)
    result.schedules_run += 1
    return h, err


def explore(scenario, budget: int = DEFAULT_BUDGET, seed: int = DEFAULT_SEED,
            sched_cls=VirtualScheduler, max_steps: int = MAX_STEPS,
            ) -> ExploreResult:
    """Bounded DFS over delivery orders and crash points. Deterministic for
    a given (scenario, seed, budget, sched_cls): the seed only permutes
    sibling visit order, so two runs produce identical schedule sets."""
    if isinstance(scenario, str):
        scenario = SCENARIOS[scenario]
    result = ExploreResult(scenario.name)

    def dfs(prefix: List[str], sleep: frozenset) -> None:
        if result.truncated or result.schedules_run >= budget:
            result.truncated = True
            return
        h, err = _execute_prefix(scenario, prefix, sched_cls, result)
        try:
            if err is not None:
                result.failures.append((list(prefix), [err]))
                return
            enabled = h.enabled()
            if not enabled:
                result.complete.append(list(prefix))
                msgs = scenario.check(h)
                if msgs:
                    result.failures.append((list(prefix), msgs))
                return
            if len(prefix) >= max_steps:
                result.failures.append(
                    (list(prefix),
                     ["no quiescence within %d events" % max_steps])
                )
                return
            candidates = [e for e in enabled if e not in sleep]
            rng = random.Random("%d|%s" % (seed, "|".join(prefix)))
            rng.shuffle(candidates)
            done: set = set()
            for e in candidates:
                child_sleep = frozenset(
                    s for s in (set(sleep) | done) if _independent(s, e)
                )
                dfs(prefix + [e], child_sleep)
                done.add(e)
                if result.truncated:
                    return
        finally:
            h.close()

    dfs([], frozenset())
    return result


def replay(scenario, schedule: List[str], sched_cls=VirtualScheduler,
           ) -> Tuple[bool, List[str]]:
    """Re-run one recorded schedule. Returns (ok, messages); a key that is
    no longer enabled at its position is a determinism/compat failure."""
    if isinstance(scenario, str):
        scenario = SCENARIOS[scenario]
    h = Harness(sched_cls=sched_cls)
    try:
        scenario.setup(h)
        err = h.run_keys(schedule)
        if err is not None:
            return False, [err]
        if h.enabled():
            # Partial schedule (a recorded failure prefix): legality of the
            # prefix is all that is checked.
            return (not h.violations), list(h.violations)
        msgs = scenario.check(h)
        return (not msgs), msgs
    finally:
        h.close()


# --------------------------------------------------------------------- corpus + sweep
def _write_dir() -> str:
    """Where sweeps store schedules: CORPUS_DIR, unless it is the shared
    checked-in corpus, which the port only reads."""
    shared = os.path.realpath(CORPUS_DIR) == os.path.realpath(_SHARED_CORPUS_DIR)
    return OWN_CORPUS_DIR if shared else CORPUS_DIR


def _corpus_path(name: str) -> str:
    return os.path.join(_write_dir(), name + ".json")


def _load_corpus(name: str) -> Optional[dict]:
    for path in dict.fromkeys((_corpus_path(name), os.path.join(CORPUS_DIR, name + ".json"))):
        try:
            with open(path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            continue
    return None


def _save_corpus(name: str, seed: int, result: ExploreResult) -> None:
    entry = {
        "scenario": name,
        "seed": seed,
        "schedules_explored": len(result.complete),
        # A spread of complete schedules: first/last plus evenly spaced
        # middles — enough to replay the interesting orders cheaply.
        "schedules": _spread(result.complete, 16),
        "failures": [
            {"schedule": sch, "messages": msgs}
            for sch, msgs in result.failures[:8]
        ],
    }
    try:
        os.makedirs(_write_dir(), exist_ok=True)
        with open(_corpus_path(name), "w", encoding="utf-8") as f:
            json.dump(entry, f, indent=2, sort_keys=True)
            f.write("\n")
    except OSError:
        pass  # read-only checkout: exploration still ran


def _spread(items: List[List[str]], k: int) -> List[List[str]]:
    if len(items) <= k:
        return items
    step = (len(items) - 1) / (k - 1)
    return [items[round(i * step)] for i in range(k)]


def run_sweep(names: List[str], budget: int = DEFAULT_BUDGET,
              seed: int = DEFAULT_SEED, quiet: bool = False) -> bool:
    """Corpus replay + fresh exploration for each scenario. The CLI entry
    (`python -m ray_tpu_torch.devtools.verify <pkg> --explore ...`)."""
    ok = True
    for name in names:
        scenario = SCENARIOS[name]
        corpus = _load_corpus(name)
        replay_fail = 0
        if corpus:
            for sch in corpus.get("schedules", []):
                good, msgs = replay(scenario, sch)
                if not good:
                    replay_fail += 1
                    ok = False
                    if not quiet:
                        for m in msgs:
                            print("rt-verify explore %s REPLAY: %s" % (name, m))
        result = explore(scenario, budget=budget, seed=seed)
        if result.failures:
            ok = False
            if not quiet:
                for sch, msgs in result.failures[:4]:
                    print(
                        "rt-verify explore %s FAIL schedule=%s" % (name, sch)
                    )
                    for m in msgs:
                        print("    %s" % m)
        if not quiet:
            print(
                "rt-verify explore %s: %d executions, %d complete schedules"
                "%s%s%s"
                % (
                    name,
                    result.schedules_run,
                    len(result.complete),
                    " (budget-truncated)" if result.truncated else "",
                    ", %d corpus replay failure(s)" % replay_fail
                    if replay_fail
                    else "",
                    ", %d failing schedule(s)" % len(result.failures)
                    if result.failures
                    else ", all invariants held",
                )
            )
        _save_corpus(name, seed, result)
    return ok
