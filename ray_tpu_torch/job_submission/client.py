"""JobSubmissionClient + the supervisor actor.

The supervisor (reference: `job_manager.py` `JobSupervisor`) is a named actor
per job: it runs the entrypoint subprocess inside the job's runtime env,
streams combined stdout/stderr into the GCS KV, and records terminal status.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


def _kv():
    from ray_tpu_torch._private.worker import global_worker

    return global_worker.context


def _status_key(job_id: str) -> bytes:
    return f"job::{job_id}::status".encode()


def _logs_key(job_id: str) -> bytes:
    return f"job::{job_id}::logs".encode()


def _meta_key(job_id: str) -> bytes:
    return f"job::{job_id}::meta".encode()


def _message_key(job_id: str) -> bytes:
    return f"job::{job_id}::message".encode()


@ray_tpu_torch.remote(num_cpus=0.1, max_concurrency=2)
class _JobSupervisor:
    """Runs one job's entrypoint; `stop()` kills it (threaded actor so stop()
    is reachable while run() blocks on the subprocess)."""

    def __init__(self, job_id: str, entrypoint: str):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.proc: Optional[subprocess.Popen] = None
        self.stopped = False

    # Logs kept as a bounded tail: full output in RAM + full rewrites per
    # flush would be O(lines^2) bytes through the control plane.
    MAX_LOG_LINES = 2000

    def start(self) -> bool:
        """Submit this job's run() and its reaper from inside the
        supervisor, which owns them: a call the submitting client made would
        be failed with OwnerDiedError if the client exited before run()
        started (the CLI's `job submit` without --wait exits at once)."""
        me = ray_tpu_torch.get_actor(f"JOB_SUPERVISOR::{self.job_id}")
        _reap_supervisor.remote([me.run.remote()], self.job_id)
        return True

    def run(self) -> str:
        ctx = _kv()
        if self.stopped:
            # stop() landed before the subprocess launched.
            ctx.kv("put", _status_key(self.job_id), JobStatus.STOPPED.encode())
            return JobStatus.STOPPED
        ctx.kv("put", _status_key(self.job_id), JobStatus.RUNNING.encode())
        env = dict(os.environ)
        env["RAY_TPU_TORCH_JOB_ID"] = self.job_id
        try:
            # RAY_TPU_TORCH_ADDRESS / RAY_TPU_TORCH_AUTHKEY_HEX are already exported by the
            # worker (WorkerArgs.head_address), so the entrypoint's
            # ray_tpu_torch.init joins this cluster as a client driver.
            self.proc = subprocess.Popen(
                shlex.split(self.entrypoint),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                env=env,
            )
        except OSError as e:
            # Unlaunchable entrypoint must still reach a terminal status.
            ctx.kv("put", _logs_key(self.job_id), f"failed to launch: {e!r}".encode())
            ctx.kv("put", _status_key(self.job_id), JobStatus.FAILED.encode())
            return JobStatus.FAILED
        import collections

        tail: "collections.deque[str]" = collections.deque(maxlen=self.MAX_LOG_LINES)
        dropped = 0
        seen = 0

        def render() -> bytes:
            head = f"... [{dropped} earlier lines truncated]\n" if dropped else ""
            return (head + "".join(tail)).encode()

        for line in self.proc.stdout:
            if len(tail) == self.MAX_LOG_LINES:
                dropped += 1
            tail.append(line)
            seen += 1
            if seen % 50 == 0:
                ctx.kv("put", _logs_key(self.job_id), render())
        rc = self.proc.wait()
        ctx.kv("put", _logs_key(self.job_id), render())
        if self.stopped:
            status = JobStatus.STOPPED
        else:
            status = JobStatus.SUCCEEDED if rc == 0 else JobStatus.FAILED
        ctx.kv("put", _status_key(self.job_id), status.encode())
        return status

    def stop(self) -> bool:
        self.stopped = True
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        return True


@ray_tpu_torch.remote(num_cpus=0)
def _reap_supervisor(run_refs, job_id: str):
    """Waits (list-wrapped ref: NOT a dependency — dependency-error
    propagation would skip this task exactly when run() raised) for the
    supervisor's run() result to seal, then tears the supervisor down and
    repairs a non-terminal status left by a crash — the reference
    JobManager's supervisor teardown."""
    ray_tpu_torch.wait(run_refs)  # blocks without consuming CPU (worker unblocks it)
    from ray_tpu_torch._private.worker import global_worker

    ctx = global_worker.context
    status = ctx.kv("get", _status_key(job_id))
    if status not in (s.encode() for s in JobStatus.TERMINAL):
        # run() died before writing a terminal status.
        ctx.kv("put", _status_key(job_id), JobStatus.FAILED.encode())
    try:
        sup = ray_tpu_torch.get_actor(f"JOB_SUPERVISOR::{job_id}")
    except ValueError:
        return False
    ray_tpu_torch.kill(sup)
    return True


class JobSubmissionClient:
    """Reference: `python/ray/job_submission/JobSubmissionClient` (REST there,
    direct actor calls here — the dashboard REST head wraps this)."""

    def __init__(self, address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address or os.environ.get("RAY_TPU_TORCH_ADDRESS"))
        elif address is not None:
            from ray_tpu_torch._private.worker import RemoteDriverContext, global_worker

            ctx = global_worker.context
            current = (
                ctx.head_address.replace("tcp://", "")
                if isinstance(ctx, RemoteDriverContext)
                else None
            )
            if current is not None and current != address.replace("tcp://", ""):
                raise ValueError(
                    f"already connected to {current}; cannot target {address} "
                    "from the same process"
                )

    def submit_job(
        self,
        *,
        entrypoint: str,
        runtime_env: Optional[Dict[str, Any]] = None,
        submission_id: Optional[str] = None,
        metadata: Optional[Dict[str, str]] = None,
    ) -> str:
        job_id = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        ctx = _kv()
        if ctx.kv("get", _status_key(job_id)) is not None:
            raise ValueError(f"job '{job_id}' already exists")
        ctx.kv("put", _status_key(job_id), JobStatus.PENDING.encode())
        import json

        ctx.kv(
            "put",
            _meta_key(job_id),
            json.dumps(
                {"entrypoint": entrypoint, "metadata": metadata or {}, "submitted_at": time.time()}
            ).encode(),
        )
        sup = _JobSupervisor.options(
            name=f"JOB_SUPERVISOR::{job_id}",
            runtime_env=runtime_env,
            # The job must outlive the submitting client (reference:
            # JobSupervisor is a detached actor, `job_manager.py`).
            lifetime="detached",
        ).remote(job_id, entrypoint)
        # The supervisor submits run() and its reaper itself (start()), so
        # the job outlives this client. Teardown: reap waits on run()'s
        # result (even an error) and then kills the supervisor, so it never
        # leaks and never dies mid-flush.
        ray_tpu_torch.get(sup.start.remote())
        self._supervisors = getattr(self, "_supervisors", {})
        self._supervisors[job_id] = sup
        return job_id

    def get_job_status(self, job_id: str) -> str:
        raw = _kv().kv("get", _status_key(job_id))
        if raw is None:
            raise ValueError(f"no such job '{job_id}'")
        return raw.decode()

    def get_job_logs(self, job_id: str) -> str:
        raw = _kv().kv("get", _logs_key(job_id))
        return (raw or b"").decode()

    def get_job_info(self, job_id: str) -> Dict[str, Any]:
        import json

        raw = _kv().kv("get", _meta_key(job_id))
        if raw is None:
            raise ValueError(f"no such job '{job_id}'")
        info = json.loads(raw)
        info["status"] = self.get_job_status(job_id)
        msg = _kv().kv("get", _message_key(job_id))
        if msg:
            info["message"] = msg.decode()
        return info

    def list_jobs(self) -> Dict[str, str]:
        ctx = _kv()
        out = {}
        for key in ctx.kv("keys", b"job::"):
            s = key.decode()
            if s.endswith("::status"):
                jid = s[len("job::"):-len("::status")]
                out[jid] = ctx.kv("get", key).decode()
        return out

    def stop_job(self, job_id: str) -> bool:
        try:
            sup = ray_tpu_torch.get_actor(f"JOB_SUPERVISOR::{job_id}")
        except ValueError:
            return False
        return ray_tpu_torch.get(sup.stop.remote())

    def wait_until_finished(self, job_id: str, timeout: float = 300.0) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.get_job_status(job_id)
            if st in JobStatus.TERMINAL:
                return st
            time.sleep(0.2)
        raise TimeoutError(f"job '{job_id}' not finished after {timeout}s")
