"""Lazy task/actor DAG IR: `.bind()` composes a graph, `.execute()` runs it.

Reference: `python/ray/dag/` (`dag_node.py`, `function_node.py`,
`class_node.py`, `input_node.py`, ~2.5k LoC) — the IR Serve compiles deployment
graphs from and Workflow executes durably. Here the same surface:

    @ray_tpu_torch.remote
    def a(x): ...
    @ray_tpu_torch.remote
    def b(y): ...
    dag = b.bind(a.bind(InputNode()))
    ref = dag.execute(5)          # submits a() then b() as normal tasks

Nodes: FunctionNode (task), ClassNode (actor ctor), ClassMethodNode (method on
a bound actor), InputNode (the execute-time argument).
"""

from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputNode,
)

__all__ = [
    "DAGNode",
    "FunctionNode",
    "ClassNode",
    "ClassMethodNode",
    "InputNode",
]
