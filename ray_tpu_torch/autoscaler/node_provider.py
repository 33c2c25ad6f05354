"""NodeProvider plugin interface + built-in providers.

Reference: `python/ray/autoscaler/node_provider.py` (the plugin API cloud
providers implement) and `_private/fake_multi_node/node_provider.py:237`
(`FakeMultiNodeProvider`, the test double nearly every autoscaler test uses).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional


class NodeProvider:
    """Create/terminate nodes of a named node type. `node_config` is the
    type's config dict (resources, labels, provider-specific fields)."""

    def create_node(self, node_type: str, node_config: Dict[str, Any]) -> str:
        """Launch one node; returns a provider node id."""
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError


class FakeMultiNodeProvider(NodeProvider):
    """Registers virtual nodes with the in-process scheduler — pure-logic
    autoscaler tests without processes (the fake_multi_node analogue)."""

    def __init__(self):
        self._nodes: Dict[str, Any] = {}

    def create_node(self, node_type: str, node_config: Dict[str, Any]) -> str:
        from ray_tpu_torch._private.ids import NodeID
        from ray_tpu_torch._private.worker import global_worker

        resources = dict(node_config.get("resources") or {})
        labels = {"autoscaler_node_type": node_type, **(node_config.get("labels") or {})}
        scheduler = global_worker.context.scheduler
        node_id: NodeID = scheduler.call("add_node", (resources, labels)).result()
        self._nodes[node_id.hex()] = node_id
        return node_id.hex()

    def terminate_node(self, provider_node_id: str) -> None:
        from ray_tpu_torch._private.worker import global_worker

        node_id = self._nodes.pop(provider_node_id, None)
        if node_id is not None:
            global_worker.context.scheduler.call("remove_node", node_id).result()

    def non_terminated_nodes(self) -> List[str]:
        return list(self._nodes)


class LocalDaemonProvider(NodeProvider):
    """Spawns real node-daemon processes on this machine (the autoscaler
    variant of `cluster_utils.Cluster(real=True).add_node`). A daemon inherits
    this process's environment, so a GPU node type's daemon registers the
    device ids this process's `CUDA_VISIBLE_DEVICES` names (all of them: ids
    0..n-1 when it is unset) and labels itself with its NVLink domain."""

    def __init__(self, head_address: str, authkey_hex: Optional[str] = None):
        self.head_address = head_address
        self.authkey_hex = authkey_hex or os.environ.get("RAY_TPU_TORCH_AUTHKEY_HEX", "")
        self._procs: Dict[str, subprocess.Popen] = {}
        self._dirs: Dict[str, str] = {}
        # The logs of the last node that failed to start.
        self.failed_logs: Dict[str, str] = {}

    def create_node(self, node_type: str, node_config: Dict[str, Any]) -> str:
        from ray_tpu_torch._private.launch import spawn_node_daemon

        # The node's directory: its object store (`shm`, in shared memory
        # where there is some, as cluster_utils' daemon nodes) and its logs
        # (`logs`: the daemon's own and its workers'). Removed when the node
        # is terminated.
        shm_root = "/dev/shm" if os.path.isdir("/dev/shm") else None
        root = tempfile.mkdtemp(prefix="ray_tpu_torch_asnode_", dir=shm_root)
        labels = {"autoscaler_node_type": node_type, **(node_config.get("labels") or {})}
        try:
            proc, node_id = spawn_node_daemon(
                self.head_address,
                shm_dir=os.path.join(root, "shm"),
                resources=node_config.get("resources") or {},
                labels=labels,
                authkey_hex=self.authkey_hex,
                log_dir=os.path.join(root, "logs"),
            )
        except BaseException:
            self.failed_logs = self._read_logs(root)
            shutil.rmtree(root, ignore_errors=True)
            raise
        self._procs[node_id] = proc
        self._dirs[node_id] = root
        return node_id

    @staticmethod
    def _read_logs(root: str) -> Dict[str, str]:
        logs = {}
        log_dir = os.path.join(root, "logs")
        for name in sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) else ():
            with open(os.path.join(log_dir, name), errors="replace") as f:
                logs[name] = f.read()
        return logs

    def logs(self, provider_node_id: str) -> Dict[str, str]:
        """The node's log files (the daemon's and its workers'), by name."""
        root = self._dirs.get(provider_node_id)
        return self._read_logs(root) if root else {}

    def terminate_node(self, provider_node_id: str) -> None:
        """SIGTERM the daemon, which kills its workers on the way out; SIGKILL
        after 10 s."""
        proc = self._procs.pop(provider_node_id, None)
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        root = self._dirs.pop(provider_node_id, None)
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)

    def pid(self, provider_node_id: str) -> Optional[int]:
        """The daemon process's pid, while this provider holds it."""
        proc = self._procs.get(provider_node_id)
        return proc.pid if proc is not None else None

    def non_terminated_nodes(self) -> List[str]:
        return [nid for nid, p in self._procs.items() if p.poll() is None]


class GcpGpuInstancesProvider(NodeProvider):
    """GCP GPU VM provider: each node type maps to one Compute Engine instance
    of the type's `machine_type` (the A3 types, e.g. `a3-highgpu-8g`, carry
    eight H100s behind one NVSwitch), made by `gcloud compute instances
    create` and removed by `gcloud compute instances delete`. The counterpart
    of the JAX package's TPU queued-resources provider.

    Command construction is pure (unit-testable offline); execution requires
    gcloud credentials at runtime. A started VM joins the cluster by running
    `python -m ray_tpu_torch start --address ...` in its startup script.
    """

    def __init__(self, project: str, zone: str, head_address: str,
                 runner=subprocess.run):
        self.project = project
        self.zone = zone
        self.head_address = head_address
        self._runner = runner
        self._instances: Dict[str, str] = {}  # instance name -> node_type

    def _create_command(self, name: str, node_config: Dict[str, Any]) -> List[str]:
        machine = node_config["machine_type"]  # e.g. "a3-highgpu-8g"
        image_family = node_config.get("image_family", "common-cu124-ubuntu-2204-py310")
        image_project = node_config.get("image_project", "deeplearning-platform-release")
        startup = node_config.get(
            "startup_script",
            f"python -m ray_tpu_torch start --address {self.head_address}",
        )
        return [
            "gcloud", "compute", "instances", "create", name,
            f"--project={self.project}",
            f"--zone={self.zone}",
            f"--machine-type={machine}",
            f"--image-family={image_family}",
            f"--image-project={image_project}",
            # GPU VMs cannot live-migrate.
            "--maintenance-policy=TERMINATE",
            f"--boot-disk-size={node_config.get('boot_disk_gb', 200)}GB",
            f"--metadata=startup-script={startup}",
        ]

    def _delete_command(self, name: str) -> List[str]:
        return [
            "gcloud", "compute", "instances", "delete", name,
            f"--project={self.project}", f"--zone={self.zone}", "--quiet",
        ]

    def create_node(self, node_type: str, node_config: Dict[str, Any]) -> str:
        name = f"raytpu-torch-{node_type}-{int(time.time())}".replace("_", "-").lower()
        cmd = self._create_command(name, node_config)
        proc = self._runner(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"instances create failed: {proc.stdout}")
        self._instances[name] = node_type
        return name

    def terminate_node(self, provider_node_id: str) -> None:
        self._instances.pop(provider_node_id, None)
        self._runner(
            self._delete_command(provider_node_id),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )

    def non_terminated_nodes(self) -> List[str]:
        return list(self._instances)
