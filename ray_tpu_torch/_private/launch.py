"""Process launch helpers: spawn a head server or node daemon and wait for its
ready handshake. The ONE implementation of the RAY_TPU_TORCH_HEAD_READY /
RAY_TPU_TORCH_NODE_READY protocol (used by cluster_utils, the CLI, and the
autoscaler's LocalDaemonProvider — the analogue of the reference's
`_private/services.py` process starters)."""

from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

HEAD_READY_PREFIX = "RAY_TPU_TORCH_HEAD_READY "
NODE_READY_PREFIX = "RAY_TPU_TORCH_NODE_READY "


def _repo_env(extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def spawn_and_wait_ready(
    cmd: List[str],
    ready_prefix: str,
    *,
    env: Optional[Dict[str, str]] = None,
    timeout_s: float = 60.0,
) -> Tuple[subprocess.Popen, str]:
    """Popen `cmd`, wait (wall-clock bounded) for a stdout line starting with
    `ready_prefix`; returns (proc, payload after the prefix). Terminates the
    child and raises on timeout or early exit."""
    proc = subprocess.Popen(
        cmd, env=env or _repo_env(), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True,
    )
    lines: "queue.SimpleQueue[Optional[str]]" = queue.SimpleQueue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True, name="ready-pump").start()
    deadline = time.time() + timeout_s
    while True:
        remaining = deadline - time.time()
        if remaining <= 0:
            proc.terminate()
            raise TimeoutError(f"{cmd[2] if len(cmd) > 2 else cmd[0]} not ready in {timeout_s}s")
        try:
            line = lines.get(timeout=min(remaining, 1.0))
        except queue.Empty:
            continue
        if line is None:
            raise RuntimeError(f"process exited before ready: {' '.join(cmd[:4])}...")
        if line.startswith(ready_prefix):
            return proc, line[len(ready_prefix):].strip()


def spawn_head(
    *,
    port: int = 0,
    host: str = "127.0.0.1",
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    extra_args: Tuple[str, ...] = (),
    timeout_s: float = 60.0,
) -> Tuple[subprocess.Popen, Dict[str, Any]]:
    """Start a head server process; returns (proc, ready-info dict with
    address/session_dir/authkey_hex)."""
    cmd = [sys.executable, "-m", "ray_tpu_torch._private.head", "--port", str(port), "--host", host]
    if num_cpus is not None:
        cmd += ["--num-cpus", str(num_cpus)]
    if num_gpus is not None:
        cmd += ["--num-gpus", str(num_gpus)]
    if resources:
        cmd += ["--resources", json.dumps(resources)]
    cmd += list(extra_args)
    proc, payload = spawn_and_wait_ready(cmd, HEAD_READY_PREFIX, timeout_s=timeout_s)
    return proc, json.loads(payload)


def spawn_node_daemon(
    head_address: str,
    *,
    shm_dir: str,
    resources: Optional[Dict[str, float]] = None,
    labels: Optional[Dict[str, str]] = None,
    authkey_hex: Optional[str] = None,
    timeout_s: float = 60.0,
) -> Tuple[subprocess.Popen, str]:
    """Start a node daemon joined to `head_address`; returns (proc, node_id_hex)."""
    env = _repo_env(
        {"RAY_TPU_TORCH_AUTHKEY_HEX": authkey_hex} if authkey_hex else None
    )
    cmd = [
        sys.executable, "-m", "ray_tpu_torch._private.node_daemon",
        "--address", head_address,
        "--shm-dir", shm_dir,
        "--resources", json.dumps(resources or {}),
        "--labels", json.dumps(labels or {}),
    ]
    proc, payload = spawn_and_wait_ready(cmd, NODE_READY_PREFIX, env=env, timeout_s=timeout_s)
    return proc, payload
