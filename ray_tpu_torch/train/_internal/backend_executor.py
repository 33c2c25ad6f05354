"""BackendExecutor: drives the worker gang through a training run.

Reference: `python/ray/train/_internal/backend_executor.py:43` (`BackendExecutor`),
`start:94`, `_create_placement_group:147`, `start_training:325`,
`get_next_results:426`. Gang semantics default to all-or-nothing: any worker failure fails the whole group and the
trainer restarts the full gang from the last checkpoint.

With `ScalingConfig(elastic=True)` the executor is also the gang membership
controller: a worker/node loss raises `GangResizeNeeded` instead of
`TrainingWorkerError`, and `resize_gang` re-forms the gang in place — probe
survivors, collect in-memory checkpoint shards (stashes + peer mirrors), drain
surviving ranks at a step boundary, drop the dead, re-run the backend
rendezvous at the new world size, and reassign ranks/local_world_size. The
result-wait loop doubles as the health poller: a heartbeat-SUSPECT worker
triggers a proactive driver-side checkpoint fetch, and a heartbeat-DEAD node
hosting a gang rank triggers the resize without waiting for the actor call to
fail.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.train._internal import elastic
from ray_tpu_torch.train._internal.session import DONE, DRAINED, ERROR, REPORT, SessionArgs, TrainingResult
from ray_tpu_torch.train._internal.worker_group import WorkerGroup, WorkerMetadata
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group


class TrainingWorkerError(Exception):
    """A worker of the gang failed; the gang must be restarted as a unit."""


class GangResizeNeeded(Exception):
    """Elastic-only control signal: gang membership changed (worker/node
    loss, or capacity returned for a grow) and the gang must re-form at a new
    world size. NOT a failure — it never consumes FailureConfig.max_failures.
    """

    def __init__(self, reason: str, grow: bool = False):
        super().__init__(reason)
        self.reason = reason
        self.grow = grow


# Chaos-lab seam: hooks invoked as fn(executor, round_idx) right after each
# completed result round, so a PreemptionSimulator (util/preemption.py) can
# fire round-indexed, seed-deterministic kills against the live gang. Hook
# errors are deliberately NOT swallowed for the simulator's own bugs to
# surface in tests — hooks must not raise in production use.
_ROUND_HOOKS: List[Callable[[Any, int], None]] = []


def register_round_hook(fn: Callable[[Any, int], None]) -> None:
    _ROUND_HOOKS.append(fn)


def unregister_round_hook(fn: Callable[[Any, int], None]) -> None:
    try:
        _ROUND_HOOKS.remove(fn)
    except ValueError:
        pass


def _rendezvous_wait_total() -> float:
    """Runs on a worker: process-lifetime seconds blocked in collective
    rendezvous (includes a backend's gang join)."""
    from ray_tpu_torch.util.collective import rendezvous

    return float(rendezvous._WAIT_STATS["wait_s"])


class BackendExecutor:
    def __init__(
        self,
        backend_config: BackendConfig,
        scaling_config: ScalingConfig,
        trial_info: Optional[Dict[str, str]] = None,
        gang_id: str = "",
        ledger=None,
    ):
        self._backend_config = backend_config
        self._backend = backend_config.backend_cls()
        self._scaling = scaling_config
        self._trial_info = trial_info or {}
        self._gang_id = gang_id or self._trial_info.get("trial_id") or "default"
        self._ledger = ledger  # GoodputLedger (driver-owned) or None
        self._pg = None
        self.worker_group: Optional[WorkerGroup] = None
        self._ranks: List[int] = []
        # Straggler hysteresis: when the per-round skew first breached, and
        # whether the sustained-breach event already fired for this episode.
        self._skew_breach_since: Optional[float] = None
        self._skew_event_sent = False
        self._skew_gauge_touched = False
        # --- elastic membership state ---
        self._elastic = bool(getattr(scaling_config, "elastic", False))
        self._min_workers = int(getattr(scaling_config, "min_workers", None) or 1)
        self._target = scaling_config.num_workers
        self._rounds = 0  # completed result rounds (== lockstep step count)
        self._persist_round = -1  # round of the last disk checkpoint persist
        self._last_resize_at = time.monotonic()
        self._last_health_tick = 0.0
        self._suspect_handled: set = set()  # pids already proactively stashed
        # Shards fetched driver-side on SUSPECT verdicts; merged into the
        # recovery assembly at resize time.
        self._spare_payloads: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------ start
    def start(self):
        if self._elastic:
            # No placement group: atomic all-or-nothing placement is the
            # opposite contract from resize-in-place membership.
            try:
                self.worker_group = WorkerGroup(
                    self._scaling.num_workers,
                    resources_per_worker=self._scaling._resources,
                )
                meta = self.worker_group.fetch_metadata()
            except Exception as e:
                raise TrainingWorkerError(f"gang startup failed: {e}") from e
        else:
            bundles = self._scaling.as_placement_group_bundles()
            self._pg = placement_group(bundles, strategy=self._scaling.placement_strategy)
            if not self._pg.ready(timeout=60.0):
                remove_placement_group(self._pg)
                self._pg = None
                raise TrainingWorkerError(
                    f"placement group {bundles} not schedulable on this cluster"
                )
            try:
                self.worker_group = WorkerGroup(
                    self._scaling.num_workers,
                    resources_per_worker=self._scaling._resources,
                    placement_group=self._pg,
                )
                meta = self.worker_group.fetch_metadata()
            except Exception as e:
                # Worker/actor death during gang bring-up must consume the
                # FailureConfig budget (gang restart), not surface as a
                # driver-side bug (reference retries startup failures too).
                raise TrainingWorkerError(f"gang startup failed: {e}") from e
        self._assign_ranks(meta)
        if self._elastic:
            self._assign_peers(meta)
        try:
            self._backend.on_start(self, self._backend_config)
        except RayTpuError as e:
            raise TrainingWorkerError(f"gang startup failed: {e}") from e
        self._last_resize_at = time.monotonic()

    def _assign_ranks(self, meta: List[WorkerMetadata]) -> None:
        # Rank assignment: stable by (node ip, pid) so local ranks are contiguous
        # per node (the reference sorts workers by node for the same reason).
        order = sorted(range(len(meta)), key=lambda i: (meta[i].node_ip, meta[i].pid))
        self._ranks = [order.index(i) for i in range(len(meta))]
        self._local: List[Dict[str, int]] = [{} for _ in meta]
        by_node: Dict[str, List[int]] = {}
        for i in order:
            by_node.setdefault(meta[i].node_ip, []).append(i)
        node_ips = sorted(by_node)
        for node_rank, ip in enumerate(node_ips):
            for local_rank, i in enumerate(by_node[ip]):
                self._local[i] = {
                    "local_rank": local_rank,
                    "local_world_size": len(by_node[ip]),
                    "node_rank": node_rank,
                }

    def _assign_peers(self, meta: List[WorkerMetadata]) -> None:
        """Install each worker's mirror peer: the next worker in ring order,
        preferring one on a DIFFERENT node so a node loss cannot take a shard
        and its mirror together."""
        workers = self.worker_group.workers
        n = len(workers)
        if n < 2:
            return
        refs = []
        for i in range(n):
            peer = None
            for off in range(1, n):
                j = (i + off) % n
                if meta[j].node_ip != meta[i].node_ip:
                    peer = j
                    break
            if peer is None:
                peer = (i + 1) % n  # single-node gang: ring fallback
            refs.append(workers[i].set_peer.remote(workers[peer]))
        try:
            ray_tpu_torch.get(refs, timeout=30.0)
        except Exception as e:  # noqa: BLE001 — dying gang; resize handles it
            if not self._elastic:
                raise TrainingWorkerError(f"peer assignment failed: {e}") from e

    @property
    def ranks(self) -> List[int]:
        return list(self._ranks)

    def world_info(self, worker_index: int) -> Dict[str, int]:
        info = dict(self._local[worker_index])
        info["world_rank"] = self._ranks[worker_index]
        info["world_size"] = len(self._ranks)
        return info

    # --------------------------------------------------------------- training
    def start_training(
        self,
        train_fn: Callable[[Dict[str, Any]], None],
        config: Dict[str, Any],
        checkpoint: Optional[Checkpoint] = None,
        dataset_shards: Optional[List[Dict[str, Any]]] = None,
        mesh_builder: Optional[Callable] = None,
    ):
        try:
            self._backend.on_training_start(self, self._backend_config)
        except RayTpuError as e:
            raise TrainingWorkerError(f"gang startup failed: {e}") from e
        refs = []
        for i, w in enumerate(self.worker_group.workers):
            info = self.world_info(i)
            args = SessionArgs(
                train_fn=train_fn,
                config=dict(config),
                world_rank=info["world_rank"],
                world_size=info["world_size"],
                local_rank=info["local_rank"],
                local_world_size=info["local_world_size"],
                node_rank=info["node_rank"],
                checkpoint=checkpoint,
                dataset_shards=(dataset_shards or [{}] * len(self._ranks))[
                    info["world_rank"]
                ],
                mesh_builder=mesh_builder,
                gang_id=self._gang_id,
                **self._trial_info,
            )
            refs.append(w.init_session.remote(args))
        try:
            ray_tpu_torch.get(refs)
        except Exception as e:
            raise TrainingWorkerError(f"gang startup failed: {e}") from e

    def gang_rendezvous_seconds(self) -> float:
        """Gang-mean seconds the workers spent blocked in rendezvous so far
        (the ledger's rendezvous_wait share of bring-up). Best-effort: 0.0
        when observability is off or the gang is unreachable."""
        from ray_tpu_torch._private.telemetry import metrics_enabled

        if not metrics_enabled() or self.worker_group is None:
            return 0.0
        try:
            totals = self.worker_group.execute(_rendezvous_wait_total)
        except Exception:  # noqa: BLE001 — dying gang; caller handles failure
            return 0.0
        return sum(totals) / len(totals) if totals else 0.0

    def get_next_results(self) -> Optional[List[TrainingResult]]:
        """One result per worker (ordered by world rank), or None when all DONE.

        Raises TrainingWorkerError if any worker errored or died; an elastic
        gang raises GangResizeNeeded on worker/node loss instead, and runs
        the health poll (SUSPECT -> proactive checkpoint, node DEAD -> early
        resize) while waiting on the round.
        """
        refs = [w.next_result.remote() for w in self.worker_group.workers]
        if self._elastic:
            # Once per round even when rounds complete inside the wait
            # timeout (the tick self-throttles to 1s) — fast gangs must not
            # outrun SUSPECT detection.
            self._health_tick()
            pending = list(refs)
            while pending:
                ready, pending = ray_tpu_torch.wait(
                    pending, num_returns=len(pending), timeout=0.25
                )
                # A lost rank ends the round at once: a survivor blocked in a
                # collective with it may never deliver its result (the drain
                # aborts that collective).
                for ref in ready:
                    try:
                        ray_tpu_torch.get(ref)
                    except Exception as e:
                        raise GangResizeNeeded(f"worker loss mid-round: {e}") from e
                if pending:
                    self._health_tick()
        try:
            results: List[TrainingResult] = ray_tpu_torch.get(refs)
        except Exception as e:
            if self._elastic:
                raise GangResizeNeeded(f"worker loss mid-round: {e}") from e
            raise TrainingWorkerError(f"a training worker died: {e}") from e
        by_rank = sorted(results, key=lambda r: r.world_rank)
        errors = [r for r in by_rank if r.type == ERROR]
        if errors:
            # User-code failure, not capacity loss: even an elastic gang
            # treats this as an ordinary failure (budgeted restart).
            raise TrainingWorkerError(
                "training worker(s) failed:\n" + "\n".join(r.error for r in errors)
            )
        if all(r.type == DONE for r in by_rank):
            return None
        if any(r.type != REPORT for r in by_rank):
            if self._elastic and any(r.type == DRAINED for r in by_rank):
                # A stray drained-session result racing a resize window.
                raise GangResizeNeeded("drained rank in result round")
            # Mixed DONE/REPORT: some worker returned early — a gang bug.
            raise TrainingWorkerError(
                "workers out of sync: mixed DONE and REPORT results in one round"
            )
        self._rounds += 1
        self._fold_results(by_rank)
        for hook in list(_ROUND_HOOKS):
            hook(self, self._rounds)
        return by_rank

    def note_persisted_checkpoint(self) -> None:
        """Trainer seam: a reported checkpoint was just persisted to disk.
        Recovery assembly prefers the in-memory stash only when it is at
        least as new as this round."""
        self._persist_round = self._rounds

    # ------------------------------------------------------ elastic controller
    def _health_tick(self) -> None:
        """Throttled heartbeat-health poll while waiting on a result round:
        a SUSPECT gang worker triggers one proactive driver-side checkpoint
        fetch per episode (the stash survives even if the worker never comes
        back); a DEAD node hosting a gang rank triggers the resize without
        waiting for the actor call to fail."""
        now = time.monotonic()
        if now - self._last_health_tick < 1.0:
            return
        self._last_health_tick = now
        try:
            nodes = ray_tpu_torch.nodes()
        except Exception:  # noqa: BLE001 — head unreachable; actor calls will fail
            return
        by_pid = {m.pid: i for i, m in enumerate(self.worker_group.metadata)}
        seen_suspect = set()
        for node in nodes:
            gang_pids = [
                w.get("pid") for w in node.get("workers", [])
                if w.get("pid") in by_pid
            ]
            if gang_pids and node.get("health") == "DEAD":
                raise GangResizeNeeded(
                    f"node {node.get('node_id', '')[:12]} heartbeat-DEAD with "
                    f"{len(gang_pids)} gang rank(s)"
                )
            for w in node.get("workers", []):
                pid = w.get("pid")
                if pid not in by_pid:
                    continue
                if w.get("health") == "SUSPECT":
                    seen_suspect.add(pid)
                    if pid not in self._suspect_handled:
                        self._suspect_handled.add(pid)
                        self._proactive_checkpoint()
        # Re-arm pids whose SUSPECT episode resolved.
        self._suspect_handled &= seen_suspect

    def _proactive_checkpoint(self) -> None:
        """Fetch every reachable rank's stash to the driver now — detection
        latency must not cost the newest step if the suspect rank dies."""
        payloads: List[Dict[str, Any]] = []
        refs = [w.fetch_stash.remote() for w in self.worker_group.workers]
        for r in refs:
            try:
                payloads.extend(ray_tpu_torch.get(r, timeout=2.0) or [])
            except Exception:  # noqa: BLE001 — the suspect rank itself
                continue
        if payloads:
            self._merge_spare_payloads(payloads)
            if self._ledger is not None:
                self._ledger.proactive_checkpoints += 1
                self._ledger.publish(force=True)

    def _merge_spare_payloads(self, payloads: List[Dict[str, Any]]) -> None:
        keyed = {
            (p.get("step"), p.get("world_size"), p.get("rank")): p
            for p in self._spare_payloads
        }
        for p in payloads:
            keyed[(p.get("step"), p.get("world_size"), p.get("rank"))] = p
        # Bounded: keep the newest few steps' worth across world sizes.
        entries = sorted(keyed.values(), key=lambda p: p.get("step", 0))
        self._spare_payloads = entries[-4 * max(1, self._target):]

    def _collect_payloads(self, indices: List[int]) -> List[Dict[str, Any]]:
        """Stashes + mirrors from the given (believed-alive) workers, plus
        anything already fetched proactively."""
        from ray_tpu_torch._private.config import get_config

        timeout = get_config().elastic_probe_timeout_s
        payloads = list(self._spare_payloads)
        workers = self.worker_group.workers
        refs = []
        for i in indices:
            refs.append(workers[i].fetch_stash.remote())
            refs.append(workers[i].fetch_mirrors.remote())
        for r in refs:
            try:
                payloads.extend(ray_tpu_torch.get(r, timeout=timeout) or [])
            except Exception:  # noqa: BLE001 — mid-death worker
                continue
        return payloads

    def should_grow(self) -> bool:
        """True when a shrunken elastic gang has waited out the grow backoff
        and the cluster has capacity for at least one more worker."""
        if not self._elastic or self.worker_group is None:
            return False
        if len(self.worker_group) >= self._target:
            return False
        from ray_tpu_torch._private.config import get_config

        if time.monotonic() - self._last_resize_at < get_config().elastic_grow_after_s:
            return False
        return self._capacity_for(1) >= 1

    def _capacity_for(self, want: int) -> int:
        """How many additional workers (up to `want`) the cluster can host."""
        try:
            avail = ray_tpu_torch.available_resources()
        except Exception:  # noqa: BLE001
            return 0
        need = self._scaling._resources
        fits = want
        for k, v in need.items():
            if v > 0:
                fits = min(fits, int(avail.get(k, 0.0) / v))
        return max(0, fits)

    def resize_gang(self, reason: str, grow: bool = False) -> Dict[str, Any]:
        """Re-form the gang in place at the surviving (plus any regrown)
        world size. Returns resize info: old/new world, the recovered
        in-memory checkpoint (or None when the disk checkpoint is newer), and
        its source/step. Raises TrainingWorkerError when the gang cannot
        re-form at >= min_workers (the loss then consumes the failure budget
        like any other gang failure)."""
        from ray_tpu_torch._private.config import get_config

        cfg = get_config()
        old_world = len(self._ranks)
        workers = self.worker_group.workers
        # 1. Probe liveness. Dead ranks fail fast (sealed error), stuck ranks
        # burn the probe timeout once each.
        alive: List[int] = []
        for i, w in enumerate(workers):
            try:
                ray_tpu_torch.get(w.ping.remote(), timeout=cfg.elastic_probe_timeout_s)
                alive.append(i)
            except Exception:  # noqa: BLE001
                continue
        # 2. Collect recovery shards BEFORE touching the survivors: stashes
        # and the dead ranks' mirrors live on the alive workers.
        payloads = self._collect_payloads(alive)
        # 3. Drain survivors at a step boundary; a rank that cannot reach its
        # boundary inside the drain budget is treated as dead.
        drained: List[int] = []
        for i in alive:
            try:
                ok = ray_tpu_torch.get(
                    workers[i].drain_session.remote(cfg.elastic_drain_timeout_s),
                    timeout=cfg.elastic_drain_timeout_s + 5.0,
                )
            except Exception:  # noqa: BLE001
                ok = False
            if ok:
                drained.append(i)
        self.worker_group.discard(
            [i for i in range(old_world) if i not in drained], kill=True
        )
        # 4. Grow toward the target when asked (and capacity allows).
        if grow:
            for _ in range(self._capacity_for(self._target - len(self.worker_group))):
                if len(self.worker_group) >= self._target:
                    break
                self.worker_group.spawn_worker()
        if len(self.worker_group) < max(1, self._min_workers):
            raise TrainingWorkerError(
                f"elastic resize impossible: {len(self.worker_group)} "
                f"survivor(s) < min_workers {self._min_workers} ({reason})"
            )
        # 5. Re-form: metadata, ranks, peers, backend rendezvous at new size.
        try:
            meta = self.worker_group.fetch_metadata()
        except Exception as e:
            raise TrainingWorkerError(f"gang re-form failed: {e}") from e
        self._assign_ranks(meta)
        self._assign_peers(meta)
        try:
            self._backend.on_shutdown(self, self._backend_config)
        except Exception:  # noqa: BLE001 — old collective state best-effort
            pass
        try:
            self._backend.on_start(self, self._backend_config)
        except RayTpuError as e:
            raise TrainingWorkerError(f"gang re-form failed: {e}") from e
        # 6. Assemble the newest complete in-memory checkpoint and decide
        # whether it beats the last disk persist (stash steps count report
        # calls, exactly what _rounds counts driver-side).
        recovered = elastic.assemble_recovery(payloads)
        info: Dict[str, Any] = {
            "old_world": old_world,
            "new_world": len(self.worker_group),
            "reason": reason,
            "checkpoint": None,
            "ckpt_source": "disk",
            "recovered_step": None,
        }
        if recovered is not None:
            step, state, rules = recovered
            if step >= self._persist_round:
                info["checkpoint"] = Checkpoint.from_dict(
                    {"elastic_step": step, "state": state, "rules": rules}
                )
                info["ckpt_source"] = "memory"
                info["recovered_step"] = step
        self._suspect_handled.clear()
        self._last_resize_at = time.monotonic()
        return info

    def _fold_results(self, by_rank: List[TrainingResult]) -> None:
        """Per-round observability fold: gang skew gauge, straggler naming
        (slowest rank + its dominant phase excess over the gang mean), the
        sustained-breach train_straggler event, and the goodput ledger."""
        pairs = [(r.world_rank, r.telemetry) for r in by_rank if r.telemetry]
        straggler = None
        skew = 0.0
        per_rank: Dict[str, Dict[str, Any]] = {}
        if len(pairs) == len(by_rank) and len(pairs) >= 2:
            # Skew is computed on ACTIVE time, not raw step wall: the gang
            # runs lockstep (bounded result queue + collectives), so every
            # rank's wall converges to the slowest rank's. Waiting-for-others
            # time — report-queue backpressure and collective arrival offset
            # (how early this rank reached the rendezvous) — is subtracted;
            # what's left is the rank's own work, where a straggler shows.
            walls = {}
            for rk, t in pairs:
                wait = (t.get("phases") or {}).get("report", 0.0) + float(
                    t.get("arrival_offset_s", 0.0)
                )
                walls[rk] = max(0.0, float(t.get("step_wall_s", 0.0)) - wait)
            slow = max(walls, key=walls.get)
            skew = walls[slow] - min(walls.values())
            n = len(pairs)
            means: Dict[str, float] = {}
            for _, t in pairs:
                for p, v in (t.get("phases") or {}).items():
                    means[p] = means.get(p, 0.0) + v / n
            slow_phases = dict(
                next(t for rk, t in pairs if rk == slow).get("phases") or {}
            )
            excess = {
                p: slow_phases.get(p, 0.0) - means.get(p, 0.0)
                for p in set(slow_phases) | set(means)
            }
            dominant = max(excess, key=excess.get) if excess else "step_exec"
            straggler = {
                "rank": slow,
                "phase": dominant,
                "skew_s": round(skew, 6),
                "active_s": round(walls[slow], 6),
            }
            per_rank = {
                str(rk): {
                    "step_wall_s": round(float(t.get("step_wall_s", 0.0)), 6),
                    "phases": {
                        p: round(v, 6)
                        for p, v in (t.get("phases") or {}).items()
                    },
                }
                for rk, t in pairs
            }
            from ray_tpu_torch._private.telemetry import metrics_enabled, train_metrics

            if metrics_enabled():
                train_metrics()["step_skew"].set(skew, {"gang": self._gang_id})
                self._skew_gauge_touched = True
            from ray_tpu_torch._private.config import get_config

            cfg = get_config()
            if skew > cfg.train_straggler_skew_s:
                now = time.monotonic()
                if self._skew_breach_since is None:
                    self._skew_breach_since = now
                elif (
                    not self._skew_event_sent
                    and now - self._skew_breach_since >= cfg.train_straggler_for_s
                ):
                    from ray_tpu_torch._private.events import emit_event

                    emit_event(
                        "train_straggler",
                        f"gang {self._gang_id}: rank {slow} is straggling "
                        f"(skew {skew:.3f}s, dominant phase {dominant})",
                        severity="warning",
                        source="train-driver",
                        gang=self._gang_id,
                        rank=slow,
                        phase=dominant,
                        skew_s=round(skew, 6),
                    )
                    self._skew_event_sent = True
            else:
                self._skew_breach_since = None
                self._skew_event_sent = False
        if self._ledger is not None:
            self._ledger.note_skew(skew, straggler, per_rank)
            self._ledger.fold_round([t for _, t in pairs])

    # ---------------------------------------------------------------- shutdown
    def shutdown(self):
        if self._skew_gauge_touched:
            # The driver registry re-flushes a gauge's last value forever;
            # left non-zero after the gang ends, the train_straggler alert
            # would never resolve. Park it at 0 explicitly.
            try:
                from ray_tpu_torch._private.telemetry import train_metrics

                train_metrics()["step_skew"].set(0.0, {"gang": self._gang_id})
            except Exception:  # noqa: BLE001
                pass
            self._skew_gauge_touched = False
        if self.worker_group is not None:
            try:
                self._backend.on_shutdown(self, self._backend_config)
            except Exception:
                pass
            self.worker_group.shutdown()
            self.worker_group = None
        if self._pg is not None:
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None
