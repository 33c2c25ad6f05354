"""WorkerGroup: a gang of train-worker actors with broadcast execution.

Reference: `python/ray/train/_internal/worker_group.py:92` (`WorkerGroup`),
`:55` (`RayTrainWorker` — "execute arbitrary functions on a worker"). Workers
are placed into the trainer's placement group bundles 1:1. A worker that
holds `GPU: n` sees its `n` device ids in `CUDA_VISIBLE_DEVICES`, set by the
scheduler before the worker process starts. Elastic gangs skip the
placement group (all-or-nothing atomic placement is antithetical to resize-in-
place) and schedule workers by plain resources instead; the group can then
spawn and discard members mid-run (`spawn_worker` / `discard`).

Train workers run with a small `max_concurrency` so control calls — liveness
ping, step-boundary drain, stash/mirror fetch, preemption notice — proceed
while the long-blocking `next_result` occupies a thread.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train._internal import elastic, session as session_mod
from ray_tpu_torch.train._internal.session import SessionArgs, TrainingResult
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

# Threads per train-worker actor: one for the blocking next_result, the rest
# for control calls (drain/ping/stash) and peer mirror receives.
_WORKER_CONCURRENCY = 4


class RayTrainWorker:
    """Actor hosting one training process (its GPUs, if the gang holds any)."""

    def execute(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    def metadata(self) -> Dict[str, Any]:
        return {
            "node_ip": socket.gethostbyname(socket.gethostname()),
            "hostname": socket.gethostname(),
            "pid": os.getpid(),
        }

    def ping(self) -> bool:
        return True

    # ------------------------------------------------------- session control
    def init_session(self, args: SessionArgs) -> None:
        session_mod.init_session(args)

    def next_result(self) -> TrainingResult:
        return session_mod.get_session().next_result()

    def session_finished(self) -> bool:
        return session_mod.get_session().finished()

    def session_telemetry(self) -> Optional[Dict[str, Any]]:
        """Cumulative step-clock totals for this worker (None with obs off)."""
        return session_mod.get_session().telemetry_snapshot()

    def shutdown_session(self) -> None:
        session_mod.shutdown_session()

    # ------------------------------------------------------ elastic control
    def drain_session(self, timeout: float = 10.0) -> bool:
        """Stop the running session at its next step boundary (elastic
        resize). True = the loop thread exited cleanly within the timeout."""
        if session_mod._session is None:
            return True
        return session_mod._session.drain(timeout)

    def set_peer(self, handle) -> None:
        """Install the peer this worker mirrors its checkpoint stash to."""
        elastic.set_peer(handle)

    def receive_mirror(self, payload: Dict[str, Any]) -> None:
        elastic.receive_mirror(payload)

    def fetch_stash(self) -> List[Dict[str, Any]]:
        return elastic.fetch_stash()

    def fetch_mirrors(self) -> List[Dict[str, Any]]:
        return elastic.fetch_mirrors()

    def preemption_notice(self, grace_s: float = 1.0) -> None:
        """Simulated preemption notice (the SIGTERM-with-grace contract of
        real preemptions): flush the newest stash to the peer mirror,
        emit the event, then hard-exit before the grace window closes."""
        import threading
        import time as _time

        from ray_tpu_torch._private.events import emit_event

        def _die():
            deadline = _time.monotonic() + max(0.1, grace_s)
            flushed = elastic.flush_to_peer(timeout=max(0.1, grace_s * 0.8))
            emit_event(
                "train_preempt_notice",
                f"worker pid {os.getpid()} preempted "
                f"(grace {grace_s:.1f}s, mirror flushed: {flushed})",
                severity="warning",
                source="train-worker",
                pid=os.getpid(),
                grace_s=round(float(grace_s), 3),
                flushed=bool(flushed),
                stash_step=elastic.newest_step(),
            )
            try:
                from ray_tpu_torch.util.metrics import flush_metrics

                flush_metrics()
            except Exception:  # noqa: BLE001
                pass
            _time.sleep(max(0.0, deadline - _time.monotonic()))
            os._exit(1)

        # Run on a fresh thread so the actor call returns immediately: the
        # notice is asynchronous in real clusters too.
        threading.Thread(target=_die, daemon=True).start()


@dataclass
class WorkerMetadata:
    node_ip: str
    hostname: str
    pid: int


class WorkerGroup:
    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Optional[Dict[str, float]] = None,
        placement_group=None,
    ):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        res = dict(resources_per_worker or {"CPU": 1.0})
        opts: Dict[str, Any] = {
            "num_cpus": res.pop("CPU", 1.0),
            "max_concurrency": _WORKER_CONCURRENCY,
        }
        if "GPU" in res:
            opts["num_gpus"] = res.pop("GPU")
        if res:
            opts["resources"] = res
        self._opts = opts
        self._cls = ray_tpu_torch.remote(RayTrainWorker)
        self._workers = []
        for i in range(num_workers):
            o = dict(opts)
            if placement_group is not None:
                o["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                    placement_group=placement_group, placement_group_bundle_index=i
                )
            self._workers.append(self._cls.options(**o).remote())
        self._metadata: List[WorkerMetadata] = []

    def __len__(self):
        return len(self._workers)

    @property
    def workers(self):
        return list(self._workers)

    def fetch_metadata(self) -> List[WorkerMetadata]:
        infos = ray_tpu_torch.get([w.metadata.remote() for w in self._workers])
        self._metadata = [WorkerMetadata(**m) for m in infos]
        return self._metadata

    @property
    def metadata(self) -> List[WorkerMetadata]:
        return list(self._metadata)

    # ------------------------------------------------------ elastic resize
    def spawn_worker(self):
        """Add one worker outside any placement group (elastic grow; a dead
        PG bundle cannot be reused, and elastic gangs run without a PG)."""
        w = self._cls.options(**dict(self._opts)).remote()
        self._workers.append(w)
        return w

    def discard(self, indices: List[int], kill: bool = True) -> None:
        """Drop workers by index (dead or undrainable members at resize)."""
        doomed = {i for i in indices}
        for i in sorted(doomed):
            if kill:
                try:
                    ray_tpu_torch.kill(self._workers[i])
                except Exception:  # noqa: BLE001 — already dead
                    pass
        self._workers = [w for i, w in enumerate(self._workers) if i not in doomed]
        if self._metadata:
            self._metadata = [
                m for i, m in enumerate(self._metadata) if i not in doomed
            ]

    def execute_async(self, fn: Callable, *args, **kwargs):
        return [w.execute.remote(fn, *args, **kwargs) for w in self._workers]

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return ray_tpu_torch.get(self.execute_async(fn, *args, **kwargs))

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        return ray_tpu_torch.get(self._workers[rank].execute.remote(fn, *args, **kwargs))

    def shutdown(self):
        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self._workers = []
