"""Workflow executor: run a DAG with per-step durability and resume.

Reference: `python/ray/workflow/workflow_executor.py` + `task_executor.py`.
Each FunctionNode is a durable step: its result is fetched and persisted
before dependents consume it, so a crash at any point resumes from the last
completed step. Step ids are deterministic DFS positions over the persisted
DAG, so a resumed run maps steps 1:1. Execution runs inside a supervisor task
(`_supervise`) — the workflow survives the submitting driver, and `run_async`
returns immediately with its ObjectRef.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.dag import ClassMethodNode, ClassNode, DAGNode, FunctionNode, InputNode
from ray_tpu_torch.workflow.storage import WorkflowStorage, list_workflows

RESULT_STEP = "__result__"


def _assign_step_ids(dag: DAGNode) -> Dict[int, str]:
    """Deterministic DFS numbering: the same persisted DAG yields the same ids
    on every resume."""
    ids: Dict[int, str] = {}
    counter = [0]

    def visit(node: DAGNode):
        if id(node) in ids:
            return
        for child in node._children():
            visit(child)
        name = getattr(getattr(node, "_rf", None), "__name__", type(node).__name__)
        ids[id(node)] = f"step-{counter[0]}-{name}"
        counter[0] += 1

    visit(dag)
    return ids


def _execute_durable(dag: DAGNode, store: WorkflowStorage, args, kwargs) -> Any:
    ids = _assign_step_ids(dag)
    memo: Dict[int, Any] = {}

    def resolve(node):
        if not isinstance(node, DAGNode):
            return node
        key = id(node)
        if key in memo:
            return memo[key]
        if isinstance(node, InputNode):
            value = node._run({}, args, kwargs or {})
        elif isinstance(node, (ClassNode, ClassMethodNode)):
            raise TypeError(
                "workflows execute function DAGs; actors are not durable steps "
                "(matches the reference's task-based workflow model)"
            )
        elif isinstance(node, FunctionNode):
            sid = ids[key]
            if store.has_step(sid):
                value = store.load_step(sid)
            else:
                a = [resolve(x) for x in node._bound_args]
                kw = {k: resolve(v) for k, v in node._bound_kwargs.items()}
                rf = node._rf.options(**node._options) if node._options else node._rf
                value = ray_tpu_torch.get(rf.remote(*a, **kw))
                store.save_step(sid, value)
        else:
            raise TypeError(f"unsupported DAG node in workflow: {type(node)}")
        memo[key] = value
        return value

    return resolve(dag)


@ray_tpu_torch.remote(num_cpus=0.1)
def _supervise(workflow_id: str, root: Optional[str]):
    store = WorkflowStorage(workflow_id, root)
    dag, args, kwargs = store.load_dag()
    store.set_status("RUNNING")
    try:
        result = _execute_durable(dag, store, args, kwargs)
    except Exception:
        store.set_status("FAILED")
        raise
    store.save_step(RESULT_STEP, result)
    store.set_status("SUCCESSFUL")
    return result


def _head_pinned_supervise():
    """The supervisor must see the same filesystem the driver wrote the DAG
    to: pin it to the head node (selected by its 'head' label, not list
    position). On multi-node clusters `storage_root` must be a shared
    filesystem (same requirement as the reference's storage URL)."""
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy
    from ray_tpu_torch._private.worker import global_worker

    nodes = global_worker.context.nodes()
    head = next((n for n in nodes if n.get("labels", {}).get("head") == "1"), None)
    if head is None and nodes:
        head = nodes[0]
    if head is not None:
        return _supervise.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                head["node_id"], soft=False
            )
        )
    return _supervise


def run_async(
    dag: DAGNode,
    args: Tuple = (),
    kwargs: Optional[dict] = None,
    *,
    workflow_id: Optional[str] = None,
    storage_root: Optional[str] = None,
):
    """Persist the DAG and launch the supervisor; returns its ObjectRef."""
    import uuid

    workflow_id = workflow_id or f"wf-{uuid.uuid4().hex[:10]}"
    store = WorkflowStorage(workflow_id, storage_root)
    store.save_dag(dag, args, kwargs or {})
    store.set_status("PENDING")
    ref = _head_pinned_supervise().remote(workflow_id, storage_root)
    return workflow_id, ref


def run(
    dag: DAGNode,
    args: Tuple = (),
    kwargs: Optional[dict] = None,
    *,
    workflow_id: Optional[str] = None,
    storage_root: Optional[str] = None,
):
    _, ref = run_async(
        dag, args, kwargs, workflow_id=workflow_id, storage_root=storage_root
    )
    return ray_tpu_torch.get(ref)


def resume(workflow_id: str, storage_root: Optional[str] = None, *, force: bool = False):
    """Re-run a workflow from its last completed step (reference:
    `workflow.resume`). Completed steps load from storage; the rest execute.

    RUNNING/PENDING workflows are refused by default — a second supervisor
    would concurrently re-run non-checkpointed steps. After a HARD crash
    (head/supervisor killed, status stuck at RUNNING with no live supervisor)
    pass ``force=True`` to take over."""
    store = WorkflowStorage(workflow_id, storage_root)
    status = store.get_status()
    if status == "NOT_FOUND":
        raise ValueError(f"no workflow '{workflow_id}'")
    if status in ("RUNNING", "PENDING") and not force:
        raise ValueError(
            f"workflow '{workflow_id}' is {status}; a live supervisor may still "
            "own it. If it died uncleanly (head crash), resume with force=True."
        )
    if store.has_step(RESULT_STEP):
        return store.load_step(RESULT_STEP)
    return ray_tpu_torch.get(_head_pinned_supervise().remote(workflow_id, storage_root))


def get_output(workflow_id: str, storage_root: Optional[str] = None):
    store = WorkflowStorage(workflow_id, storage_root)
    if not store.has_step(RESULT_STEP):
        raise ValueError(f"workflow '{workflow_id}' has no completed result")
    return store.load_step(RESULT_STEP)


def get_status(workflow_id: str, storage_root: Optional[str] = None) -> str:
    return WorkflowStorage(workflow_id, storage_root).get_status()


def list_all(storage_root: Optional[str] = None) -> Dict[str, str]:
    return list_workflows(storage_root)


def delete(workflow_id: str, storage_root: Optional[str] = None) -> None:
    WorkflowStorage(workflow_id, storage_root).delete()
