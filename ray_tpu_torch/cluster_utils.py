"""Multi-node cluster fixture for tests, in two fidelities.

The reference's load-bearing test trick (`python/ray/cluster_utils.py:99
class Cluster` / `add_node:165`) starts N real raylet processes on one machine.
Here:

 - ``Cluster(real=True)`` does the full thing: spawns a **head server process**
   (`_private/head.py`, GCS + scheduler over TCP), connects this driver in
   client mode, and ``add_node`` spawns **node daemon processes**
   (`_private/node_daemon.py`) with their own shm dirs — so worker leasing,
   cross-node object pulls, and daemon-kill node failure all run the real
   multi-process paths a second host would use.
 - ``Cluster(real=False)`` (default) registers virtual NodeState entries in an
   in-process scheduler: fast, good for pure scheduling-logic tests
   (spillback / SPREAD / STRICT_SPREAD / PG policies).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.worker import global_worker, init, shutdown


class Cluster:
    def __init__(
        self,
        initialize_head: bool = True,
        connect: bool = True,
        head_node_args: Optional[Dict] = None,
        real: bool = False,
    ):
        self._node_ids = []
        self._real = real
        self._head_proc: Optional[subprocess.Popen] = None
        self._saved_authkey: Optional[str] = None
        self._daemons: Dict[NodeID, subprocess.Popen] = {}
        self._tmp_dirs = []
        self._scheduler = None
        if not initialize_head:
            raise ValueError("Cluster without a head node is not supported")
        args = dict(head_node_args or {})
        args.setdefault("num_cpus", 1)
        if real:
            self._start_head_process(args)
        else:
            init(**args)
            self._scheduler = global_worker.context.scheduler
        head_nodes = global_worker.context.nodes()
        self._node_ids.append(NodeID.from_hex(head_nodes[0]["node_id"]))

    # ------------------------------------------------------------------ real mode
    def _start_head_process(self, args: Dict):
        from ray_tpu_torch._private.launch import spawn_head

        self._head_proc, info = spawn_head(
            num_cpus=args.get("num_cpus"),
            num_gpus=args.get("num_gpus"),
            resources=args.get("resources"),
            timeout_s=30,
        )
        self._head_info = info
        self._saved_authkey = os.environ.get("RAY_TPU_TORCH_AUTHKEY_HEX")
        os.environ["RAY_TPU_TORCH_AUTHKEY_HEX"] = info["authkey_hex"]
        init(address=info["address"])

    @property
    def address(self) -> Optional[str]:
        return self._head_info["address"] if self._real else None

    @property
    def head_node_id(self) -> NodeID:
        return self._node_ids[0]

    def add_node(
        self,
        num_cpus: float = 1,
        num_gpus: float = 0,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> NodeID:
        node_resources = {"CPU": float(num_cpus)}
        if num_gpus:
            node_resources["GPU"] = float(num_gpus)
        node_resources.update(resources or {})
        if self._real:
            return self._add_daemon_node(node_resources, labels or {})
        node_id = self._scheduler.call("add_node", (node_resources, labels or {})).result()
        self._node_ids.append(node_id)
        return node_id

    def _add_daemon_node(self, node_resources, labels) -> NodeID:
        from ray_tpu_torch._private.launch import spawn_node_daemon

        # The node store is the SHARED-MEMORY store: back it with /dev/shm
        # when present (a disk-backed tmpdir caps the data plane at the
        # device's write bandwidth), like the head's session dir.
        shm_root = "/dev/shm" if os.path.isdir("/dev/shm") else None
        shm_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_node_", dir=shm_root)
        self._tmp_dirs.append(shm_dir)
        proc, node_hex = spawn_node_daemon(
            self._head_info["address"],
            shm_dir=shm_dir,
            resources=node_resources,
            labels=labels,
            authkey_hex=self._head_info["authkey_hex"],
            timeout_s=30,
        )
        node_id = NodeID.from_hex(node_hex)
        self._daemons[node_id] = proc
        self._node_ids.append(node_id)
        return node_id

    def remove_node(self, node_id: NodeID) -> bool:
        """Kill a node: its workers die, its tasks fail/retry, its PG bundles
        reschedule (the chaos-testing seam; reference: NodeKillerActor). In real
        mode this SIGKILLs the daemon process — the head notices the dropped
        connection, exactly as it would a dead host."""
        if self._real and node_id in self._daemons:
            proc = self._daemons.pop(node_id)
            proc.kill()
            proc.wait(timeout=10)
            # Wait for the head to observe the death (conn EOF -> node removal).
            deadline = time.time() + 10
            while time.time() < deadline:
                alive = {n["node_id"] for n in global_worker.context.nodes()}
                if node_id.hex() not in alive:
                    break
                time.sleep(0.05)
            ok = True
        elif self._real:
            ok = global_worker.context.remove_node(node_id)
        else:
            ok = self._scheduler.call("remove_node", node_id).result()
        if node_id in self._node_ids:
            self._node_ids.remove(node_id)
        return ok

    def shutdown(self):
        shutdown()
        for proc in self._daemons.values():
            try:
                proc.kill()
            except ProcessLookupError:
                pass
        self._daemons.clear()
        if self._head_proc is not None:
            self._head_proc.terminate()
            try:
                self._head_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._head_proc.kill()
            self._head_proc = None
            # Restore the pre-cluster authkey so later in-process sessions
            # don't silently adopt this (now-published) key.
            if self._saved_authkey is None:
                os.environ.pop("RAY_TPU_TORCH_AUTHKEY_HEX", None)
            else:
                os.environ["RAY_TPU_TORCH_AUTHKEY_HEX"] = self._saved_authkey
        import shutil

        for d in self._tmp_dirs:
            shutil.rmtree(d, ignore_errors=True)
        self._tmp_dirs.clear()
