"""DAG node IR and the recursive executor.

Reference seam: `python/ray/dag/dag_node.py` (`DAGNode._execute_impl`,
`_apply_recursive`). Execution resolves children bottom-up: every FunctionNode
becomes a submitted task whose ObjectRefs feed parent args (the scheduler's
dependency tracking pipelines the whole graph without any barrier here);
ClassNode creates the actor once per execute; InputNode substitutes the
execute-time arguments.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


class DAGNode:
    """Base: a lazily bound call with possibly-nested child nodes in args."""

    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- traversal ---------------------------------------------------------
    def _children(self) -> List["DAGNode"]:
        out = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    def _resolve_args(self, memo, input_args, input_kwargs):
        args = [
            a._execute_impl(memo, input_args, input_kwargs) if isinstance(a, DAGNode) else a
            for a in self._bound_args
        ]
        kwargs = {
            k: v._execute_impl(memo, input_args, input_kwargs) if isinstance(v, DAGNode) else v
            for k, v in self._bound_kwargs.items()
        }
        return args, kwargs

    # -- execution ---------------------------------------------------------
    def execute(self, *args, **kwargs):
        """Run the DAG; returns the root's ObjectRef (or actor handle for a
        root ClassNode)."""
        memo: Dict[int, Any] = {}
        return self._execute_impl(memo, args, kwargs)

    def _execute_impl(self, memo, input_args, input_kwargs):
        key = id(self)
        if key not in memo:
            memo[key] = self._run(memo, input_args, input_kwargs)
        return memo[key]

    def _run(self, memo, input_args, input_kwargs):
        raise NotImplementedError


class InputNode(DAGNode):
    """Placeholder for the argument passed to `.execute(...)`. A bare
    InputNode resolves to the single positional arg; `InputNode()[i]` /
    `.attr` style access is intentionally out of scope (reference supports it
    via InputAttributeNode)."""

    def __init__(self):
        super().__init__((), {})

    def _run(self, memo, input_args, input_kwargs):
        if len(input_args) == 1 and not input_kwargs:
            return input_args[0]
        if not input_args and not input_kwargs:
            return None
        return (input_args, input_kwargs)


class FunctionNode(DAGNode):
    def __init__(self, remote_function, args, kwargs, options=None):
        super().__init__(args, kwargs)
        self._rf = remote_function
        self._options = options or {}

    def _run(self, memo, input_args, input_kwargs):
        args, kwargs = self._resolve_args(memo, input_args, input_kwargs)
        rf = self._rf.options(**self._options) if self._options else self._rf
        return rf.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """A bound actor constructor. Executing creates the actor; method nodes
    hang off it via `.method.bind(...)`."""

    def __init__(self, actor_class, args, kwargs, options=None):
        super().__init__(args, kwargs)
        self._ac = actor_class
        self._options = options or {}

    def _run(self, memo, input_args, input_kwargs):
        args, kwargs = self._resolve_args(memo, input_args, input_kwargs)
        ac = self._ac.options(**self._options) if self._options else self._ac
        return ac.remote(*args, **kwargs)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClassMethodBinder(self, name)


class _ClassMethodBinder:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._cn = class_node
        self._m = method_name

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._cn, self._m, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._cn = class_node
        self._m = method_name

    def _children(self):
        return super()._children() + [self._cn]

    def _run(self, memo, input_args, input_kwargs):
        handle = self._cn._execute_impl(memo, input_args, input_kwargs)
        args, kwargs = self._resolve_args(memo, input_args, input_kwargs)
        return getattr(handle, self._m).remote(*args, **kwargs)
