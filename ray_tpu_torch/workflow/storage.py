"""Workflow storage: one directory per workflow, one pickle per completed step.

Reference: `python/ray/workflow/workflow_storage.py` — durable step results +
workflow metadata under a storage URL. Subset: local filesystem (the seam a
remote-fs backend would slot into), atomic writes via tmp+rename.

GPU delta: the DAG, its arguments and each step's output are written with
``serialization.dumps_to_host`` (cloudpickle with the runtime's tensor
reducer), so a device tensor lands as a CPU tensor and the supervisor, a CPU
task, can load what the driver wrote.
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.serialization import dumps_to_host

DEFAULT_ROOT = os.environ.get("RAY_TPU_TORCH_WORKFLOW_ROOT", os.path.expanduser("~/.ray_tpu_torch/workflows"))


class WorkflowStorage:
    def __init__(self, workflow_id: str, root: Optional[str] = None):
        self.workflow_id = workflow_id
        self.dir = os.path.join(root or DEFAULT_ROOT, workflow_id)
        # Directories are created lazily by the WRITE paths: read-only calls
        # (get_status of a typo'd id) must not pollute the storage root.

    def _ensure_dirs(self) -> None:
        os.makedirs(os.path.join(self.dir, "steps"), exist_ok=True)

    # -- dag / metadata ----------------------------------------------------
    def save_dag(self, dag, args, kwargs) -> None:
        self._ensure_dirs()
        self._atomic_write(
            os.path.join(self.dir, "dag.pkl"),
            dumps_to_host({"dag": dag, "args": args, "kwargs": kwargs}),
        )

    def load_dag(self):
        with open(os.path.join(self.dir, "dag.pkl"), "rb") as f:
            d = pickle.loads(f.read())
        return d["dag"], d["args"], d["kwargs"]

    def set_status(self, status: str) -> None:
        self._ensure_dirs()
        self._atomic_write(os.path.join(self.dir, "STATUS"), status.encode())

    def get_status(self) -> str:
        try:
            with open(os.path.join(self.dir, "STATUS")) as f:
                return f.read().strip()
        except FileNotFoundError:
            return "NOT_FOUND"

    # -- step results ------------------------------------------------------
    def _step_path(self, step_id: str) -> str:
        return os.path.join(self.dir, "steps", f"{step_id}.pkl")

    def has_step(self, step_id: str) -> bool:
        return os.path.exists(self._step_path(step_id))

    def save_step(self, step_id: str, value: Any) -> None:
        self._ensure_dirs()
        self._atomic_write(self._step_path(step_id), dumps_to_host(value))

    def load_step(self, step_id: str) -> Any:
        with open(self._step_path(step_id), "rb") as f:
            return pickle.loads(f.read())

    def completed_steps(self) -> List[str]:
        try:
            return [
                f[:-4]
                for f in os.listdir(os.path.join(self.dir, "steps"))
                if f.endswith(".pkl")
            ]
        except FileNotFoundError:
            return []

    # -- util --------------------------------------------------------------
    def _atomic_write(self, path: str, data: bytes) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def delete(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


def list_workflows(root: Optional[str] = None) -> Dict[str, str]:
    base = root or DEFAULT_ROOT
    out = {}
    if os.path.isdir(base):
        for wid in os.listdir(base):
            st = WorkflowStorage(wid, base).get_status()
            out[wid] = st
    return out
