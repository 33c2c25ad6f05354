"""Per-job resource accounting: the head-side tenant ledger.

Reference: the GCS `JobManager` + per-job resource usage reporting that feeds
raylet scheduling policies (`gcs_job_manager.h`, `cluster_task_manager`
usage accounting). Redesign: job identity is *embedded in the id scheme*
(every ActorID carries its JobID, every TaskID carries its ActorID, every
ObjectID carries its TaskID — ids.py), so attribution needs no new wire
fields: the scheduler derives the owning job of any task, actor, object or
transfer from ids it already has. The `JobLedger` lives on the scheduler
(`sched.jobs`, loop-thread-only like everything the scheduler owns) exactly
when `sched.obs` exists, accrues plain dicts on the hot seams, and
materializes `ray_tpu_job_*` metrics at obs-tick cadence into the
time-series store — same flush-cadence discipline as SchedulerTelemetry.

What is metered per job:
  - CPU-lease-seconds: lease grant (dispatch with acquired CPU, or lease
    transfer on pipelining) -> release (terminal / requeue-on-death).
    Actors accrue their creation resources for their whole lifetime.
  - task counts by terminal state (+ submitted), queue-wait totals and a
    queue-wait histogram whose p95 is the starvation signal.
  - object-store resident byte*seconds, sampled on the obs tick by walking
    the ownership table (owner job = object_id.task_id.actor_id.job_id).
  - transfer bytes (head relay reads + peer-direct replica registrations).
  - Serve request counts: proxy counter deltas re-keyed app -> owning job
    (the deploy-time mapping rides the serve_deploy cluster event).

Finalization: a dead driver's live record is sealed into a bounded
finished-jobs ring owned by the GCS (persisted with --persist), so "what did
tenant X cost" stays answerable after the tenant is gone.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID

# Terminal states the ledger tags tasks with (the `state` label of
# ray_tpu_job_tasks_total; "submitted" rides the same metric).
_TERMINAL_STATES = ("finished", "failed", "cancelled")


def job_of_task(task_id: TaskID) -> str:
    """Owning job (hex) of a task — recovered from the id embedding."""
    return task_id.actor_id.job_id.hex()


def job_of_object(object_id: ObjectID) -> str:
    return object_id.task_id.actor_id.job_id.hex()


def job_of_actor(actor_id: ActorID) -> str:
    return actor_id.job_id.hex()


def _new_totals() -> Dict[str, Any]:
    return {
        "cpu_seconds": 0.0,
        "tasks": {"submitted": 0, "finished": 0, "failed": 0, "cancelled": 0},
        "queue_wait_seconds": 0.0,
        "object_byte_seconds": 0.0,
        "object_bytes": 0.0,  # latest resident sample (gauge)
        "transfer_bytes": 0,
        "serve_requests": 0,
    }


class JobLedger:
    """Accrues per-job usage on the scheduler loop thread; exports deltas
    into util.metrics objects at obs-tick cadence (never on the hot path).

    Method names deliberately avoid `inc`/`observe` — the scheduler is an
    rt-lint hot-path module and may not call those; the Metric objects live
    HERE and are only touched from flush()."""

    def __init__(self, config, gcs):
        self.config = config
        self.gcs = gcs
        # job hex -> live record ({"job", "driver", "source", "started_at",
        # "totals"}). Jobs appear at mint time (register_job) or lazily on
        # first attributed usage (a worker-submitted task can land before
        # the obs layer saw the mint, e.g. after a head restart).
        self.live: Dict[str, dict] = {}
        # Open per-task accrual: task_id bytes -> [job, queued_ts, lease_ts,
        # cpus]. Closed exactly once (pop) at terminal; requeue-on-death
        # accrues the partial lease and re-opens as queued.
        self._open_tasks: Dict[bytes, list] = {}
        # Open actor leases: actor_id bytes -> [job, start_ts, cpus].
        self._open_actors: Dict[bytes, list] = {}
        # Serve attribution: app name -> owning job hex (from serve_deploy),
        # and per-(pid, app) cumulative cursors on the proxy request counter.
        self._serve_apps: Dict[str, str] = {}
        self._proxy_cursors: Dict[tuple, float] = {}
        # Pending queue-wait observations drained into the histogram at
        # flush cadence: job -> [wait_s, ...].
        self._wait_obs: Dict[str, List[float]] = {}
        # Export cursors: job -> totals already pushed into the Metric
        # objects (counters take the delta each flush).
        self._exported: Dict[str, Dict[str, Any]] = {}
        self._metrics: Optional[dict] = None
        self._last_sample: Optional[float] = None
        # Tick cadence: same knob as alert evaluation — the object-table
        # walk must never run per loop iteration.
        self._tick_interval = max(0.05, float(config.alert_eval_interval_s))

    # ---------------------------------------------------------------- lookup
    def _rec(self, job: str) -> dict:
        rec = self.live.get(job)
        if rec is None:
            rec = self.live[job] = {
                "job": job,
                "driver": None,
                "source": "unknown",
                "started_at": time.time(),
                "totals": _new_totals(),
            }
        return rec

    def register_job(self, job: str, driver: Optional[str], source: str) -> dict:
        rec = self._rec(job)
        rec["driver"] = driver
        rec["source"] = source
        return rec

    # ------------------------------------------------------------ task seams
    def task_submitted(self, task_id: TaskID, now: float) -> None:
        job = job_of_task(task_id)
        self._rec(job)["totals"]["tasks"]["submitted"] += 1
        self._open_tasks[task_id.binary()] = [job, now, None, 0.0]

    def task_dispatched(self, task_id: TaskID, cpus: float, now: float) -> None:
        """Queue-wait closes, CPU lease opens (cpus=0 for pipelined pushes
        and actor calls — the lease head / the actor holds the resources)."""
        ent = self._open_tasks.get(task_id.binary())
        if ent is None:
            return
        job, queued, _, _ = ent
        if queued is not None:
            wait = max(0.0, now - queued)
            self._rec(job)["totals"]["queue_wait_seconds"] += wait
            self._wait_obs.setdefault(job, []).append(wait)
        ent[1] = None
        ent[2] = now
        ent[3] = float(cpus or 0.0)

    def task_lease_transferred(self, task_id: TaskID, cpus: float,
                               now: float) -> None:
        """Pipelining: the predecessor finished and its acquired resources
        moved to this (already dispatched, cpus=0) successor. The lease
        clock starts NOW — the successor held nothing while it sat in the
        worker's pipeline behind the predecessor."""
        ent = self._open_tasks.get(task_id.binary())
        if ent is None:
            return
        ent[2] = now
        ent[3] = float(cpus or 0.0)

    def task_terminal(self, task_id: TaskID, state: str, now: float) -> None:
        """The ONE close point — called from done, error-seal, and cancel
        paths; idempotent via pop so double-seals can't double-accrue.
        A task sealed while still queued (owner died / cancelled while
        PENDING) closes its queue-wait accrual here instead of leaking an
        open interval."""
        ent = self._open_tasks.pop(task_id.binary(), None)
        if ent is None:
            return
        job, queued, lease, cpus = ent
        totals = self._rec(job)["totals"]
        if lease is not None and cpus:
            totals["cpu_seconds"] += cpus * max(0.0, now - lease)
        elif queued is not None:
            wait = max(0.0, now - queued)
            totals["queue_wait_seconds"] += wait
            self._wait_obs.setdefault(job, []).append(wait)
        if state not in _TERMINAL_STATES:
            state = "failed"
        totals["tasks"][state] += 1

    def task_requeued(self, task_id: TaskID, now: float) -> None:
        """Worker died, task retries: accrue the dead attempt's partial
        lease; the fresh attempt waits in queue again."""
        ent = self._open_tasks.get(task_id.binary())
        if ent is None:
            return
        job, _, lease, cpus = ent
        if lease is not None and cpus:
            self._rec(job)["totals"]["cpu_seconds"] += cpus * max(0.0, now - lease)
        ent[1] = now
        ent[2] = None
        ent[3] = 0.0

    # ----------------------------------------------------------- actor seams
    def actor_lease_opened(self, actor_id: ActorID, cpus: float,
                           now: float) -> None:
        if cpus:
            self._open_actors[actor_id.binary()] = [
                job_of_actor(actor_id), now, float(cpus)
            ]

    def actor_lease_closed(self, actor_id: ActorID, now: float) -> None:
        ent = self._open_actors.pop(actor_id.binary(), None)
        if ent is None:
            return
        job, start, cpus = ent
        self._rec(job)["totals"]["cpu_seconds"] += cpus * max(0.0, now - start)

    # -------------------------------------------------------- transfer seams
    def transfer_bytes(self, object_id: ObjectID, nbytes: int) -> None:
        if nbytes:
            self._rec(job_of_object(object_id))["totals"]["transfer_bytes"] += int(nbytes)

    def transfer_rollup(self) -> Dict[str, int]:
        """Per-job transfer-bytes map for _cmd_transfer_stats."""
        return {
            job: rec["totals"]["transfer_bytes"]
            for job, rec in self.live.items()
            if rec["totals"]["transfer_bytes"]
        }

    # ----------------------------------------------------------- serve seams
    def register_serve_app(self, app: str, job: str) -> None:
        self._serve_apps[str(app)] = str(job)

    def ingest_snapshot(self, pid: str, snapshot: list) -> None:
        """Piggybacks on ObsState.ingest_kv (already-parsed snapshot): fold
        proxy request-counter deltas into the owning job. Cursors are
        per-(pid, app) because counters in a snapshot are cumulative."""
        for m in snapshot:
            if m.get("name") != "ray_tpu_serve_proxy_requests_total":
                continue
            for tags, value in m.get("series", ()):
                app = dict(tags).get("app")
                job = self._serve_apps.get(app)
                if job is None:
                    continue
                key = (pid, app)
                last = self._proxy_cursors.get(key, 0.0)
                delta = value - last if value >= last else value
                self._proxy_cursors[key] = value
                if delta > 0:
                    self._rec(job)["totals"]["serve_requests"] += delta

    def prune_process(self, pid: str) -> None:
        """A process died: drop its proxy cursors so a pid reuse with a
        fresh counter can't look like a negative delta forever."""
        for key in [k for k in self._proxy_cursors if k[0] == str(pid)]:
            del self._proxy_cursors[key]

    # ------------------------------------------------------------------ tick
    def on_iteration(self, sched, now: float) -> None:
        """Obs-tick hook (called right after ObsState.on_iteration, same
        cadence): sample resident bytes from the ownership table, accrue
        byte*seconds, flush metric deltas."""
        if (self._last_sample is not None
                and now - self._last_sample < self._tick_interval):
            return
        dt = 0.0 if self._last_sample is None else max(0.0, now - self._last_sample)
        self._last_sample = now
        resident: Dict[str, float] = {}
        for meta in sched.object_table.values():
            job = job_of_object(meta.object_id)
            resident[job] = resident.get(job, 0.0) + (meta.size or 0)
        for job, rec in self.live.items():
            totals = rec["totals"]
            bytes_now = resident.get(job, 0.0)
            totals["object_bytes"] = bytes_now
            if dt:
                totals["object_byte_seconds"] += bytes_now * dt
        for job, bytes_now in resident.items():
            if job not in self.live:
                rec = self._rec(job)
                rec["totals"]["object_bytes"] = bytes_now
                if dt:
                    rec["totals"]["object_byte_seconds"] += bytes_now * dt
        self._flush(now)

    def _flush(self, now: float) -> None:
        m = self._metrics
        if m is None:
            m = self._metrics = self._create_metrics()
        for job, rec in self.live.items():
            totals = rec["totals"]
            prev = self._exported.setdefault(
                job, {"cpu_seconds": 0.0, "queue_wait_seconds": 0.0,
                      "object_byte_seconds": 0.0, "transfer_bytes": 0,
                      "serve_requests": 0,
                      "tasks": {k: 0 for k in
                                ("submitted",) + _TERMINAL_STATES}}
            )
            tags = {"job": job}
            for field, metric in (
                ("cpu_seconds", "cpu_seconds"),
                ("queue_wait_seconds", "queue_wait"),
                ("object_byte_seconds", "object_bytes_total"),
                ("transfer_bytes", "transfer_bytes"),
                ("serve_requests", "serve_requests"),
            ):
                d = totals[field] - prev[field]
                if d > 0:
                    m[metric].inc(d, tags)
                    prev[field] = totals[field]
            for state, n in totals["tasks"].items():
                d = n - prev["tasks"][state]
                if d > 0:
                    m["tasks"].inc(d, {"job": job, "state": state})
                    prev["tasks"][state] = n
            m["object_bytes"].set(totals["object_bytes"], tags)
        for job, waits in self._wait_obs.items():
            for w in waits:
                m["queue_wait_hist"].observe(w, {"job": job})
        self._wait_obs.clear()

    def _create_metrics(self) -> dict:
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        return {
            "cpu_seconds": Counter(
                "ray_tpu_job_cpu_seconds_total",
                "CPU-lease-seconds accrued by the job's tasks and actors",
                ("job",)),
            "tasks": Counter(
                "ray_tpu_job_tasks_total",
                "job task counts by state (submitted/finished/failed/cancelled)",
                ("job", "state")),
            "queue_wait": Counter(
                "ray_tpu_job_queue_wait_seconds_total",
                "total seconds the job's tasks spent queued before dispatch",
                ("job",)),
            "queue_wait_hist": Histogram(
                "ray_tpu_job_queue_wait_seconds",
                "per-task queue-wait distribution; p95 is the starvation signal",
                tag_keys=("job",)),
            "object_bytes_total": Counter(
                "ray_tpu_job_object_bytes_total",
                "object-store resident byte*seconds attributed to the job",
                ("job",)),
            "object_bytes": Gauge(
                "ray_tpu_job_object_bytes",
                "object-store bytes currently resident and owned by the job",
                ("job",)),
            "transfer_bytes": Counter(
                "ray_tpu_job_transfer_bytes_total",
                "object bytes moved for the job (head relay + peer-direct)",
                ("job",)),
            "serve_requests": Counter(
                "ray_tpu_job_serve_requests_total",
                "Serve proxy requests attributed to the job's applications",
                ("job",)),
        }

    # ------------------------------------------------------------- lifecycle
    def finalize_job(self, job: str, now: float, reason: str) -> Optional[dict]:
        """Seal a job's ledger into the GCS finished-jobs ring. Open task
        accruals belonging to the job are closed (the scheduler's dead-owner
        sweep seals the tasks themselves; a task of another owner keeps its
        entry). Returns the summary, or None if the job was never live."""
        for key, ent in list(self._open_tasks.items()):
            if ent[0] != job:
                continue
            del self._open_tasks[key]
            totals = self._rec(job)["totals"]
            if ent[2] is not None and ent[3]:
                totals["cpu_seconds"] += ent[3] * max(0.0, now - ent[2])
            elif ent[1] is not None:
                totals["queue_wait_seconds"] += max(0.0, now - ent[1])
        for key, ent in list(self._open_actors.items()):
            if ent[0] == job:
                del self._open_actors[key]
                self._rec(job)["totals"]["cpu_seconds"] += (
                    ent[2] * max(0.0, now - ent[1])
                )
        rec = self.live.pop(job, None)
        if rec is None:
            return None
        self._exported.pop(job, None)
        for app in [a for a, j in self._serve_apps.items() if j == job]:
            del self._serve_apps[app]
        summary = dict(rec)
        summary["totals"] = dict(rec["totals"])
        summary["totals"]["tasks"] = dict(rec["totals"]["tasks"])
        summary["finished_at"] = now
        summary["reason"] = reason
        summary["duration_s"] = max(0.0, now - rec["started_at"])
        self.gcs.append_finished_job(summary)
        return summary

    def finalize_all(self, now: float, reason: str = "head shutdown") -> None:
        for job in list(self.live):
            self.finalize_job(job, now, reason)

    # -------------------------------------------------------------- readouts
    def _summary(self, rec: dict) -> dict:
        out = dict(rec)
        out["totals"] = dict(rec["totals"])
        out["totals"]["tasks"] = dict(rec["totals"]["tasks"])
        out["state"] = "LIVE"
        out["open_tasks"] = sum(
            1 for ent in self._open_tasks.values() if ent[0] == rec["job"]
        )
        out["serve_apps"] = sorted(
            a for a, j in self._serve_apps.items() if j == rec["job"]
        )
        return out

    def list_jobs(self) -> List[dict]:
        out = [self._summary(rec) for rec in self.live.values()]
        for fin in self.gcs.finished_job_list():
            ent = dict(fin)
            ent["state"] = "FINISHED"
            out.append(ent)
        return out

    def job_report(self, job: str) -> dict:
        rec = self.live.get(job)
        if rec is not None:
            out = self._summary(rec)
        else:
            for fin in self.gcs.finished_job_list():
                if fin.get("job") == job:
                    out = dict(fin)
                    out["state"] = "FINISHED"
                    break
            else:
                raise KeyError(f"unknown job: {job}")
        # The starvation bar the job_starved rule holds this tenant to —
        # in the report so callers need not resolve head config themselves.
        out["starved_wait_s"] = float(self.config.job_starved_wait_s)
        return out
