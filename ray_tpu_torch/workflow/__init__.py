"""Workflow: durable DAG execution with per-step checkpointing and resume.

Reference: `python/ray/workflow/` (~10.2k LoC — `workflow_executor.py`,
`workflow_storage.py`, `api.py`): a DAG's steps run as tasks, every step's
result is durably logged, and a crashed/interrupted workflow resumes from the
last completed step instead of recomputing.

Redesign here: the DAG IR is `ray_tpu_torch.dag` (same nodes the Serve graph uses);
storage is a filesystem directory (one subdir per workflow, one pickle per
completed step keyed by a deterministic step id). `run(dag, workflow_id=...)`
executes; `resume(workflow_id)` re-runs the same DAG skipping completed steps.

    from ray_tpu_torch import workflow
    wf = b.bind(a.bind(InputNode()))
    result = workflow.run(wf, args=(5,), workflow_id="job1")
    # after a crash:
    result = workflow.resume("job1")
"""

from ray_tpu_torch.workflow.execution import (
    delete,
    get_output,
    get_status,
    list_all,
    resume,
    run,
    run_async,
)

__all__ = [
    "run",
    "run_async",
    "resume",
    "get_output",
    "get_status",
    "list_all",
    "delete",
]
