"""The port's DAG API (``ray_tpu_torch.dag``) against the JAX package's
(``ray_tpu.dag``) on the CPU: both runtimes run in this process, and each
graph is bound and executed through each package with the same inputs.

The first three cases are the DAG cases of ``tests/test_dag_workflow.py``,
held here against the JAX package (the Tune and workflow suites' harness
also runs that file against the port). The rest hold the nodes' options,
keyword arguments, an actor constructed once per ``execute`` and a root
InputNode.
"""

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.dag import InputNode as JaxInputNode
from ray_tpu_torch.dag import InputNode as TorchInputNode

TIMEOUT_S = 30


@pytest.fixture(scope="module")
def both():
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _run(graph):
    """``graph(package, InputNode)`` -> (root node, execute args), executed
    through each package: (JAX's result, the port's)."""
    out = []
    for pkg, input_node in ((ray_tpu, JaxInputNode), (ray_tpu_torch, TorchInputNode)):
        dag, args = graph(pkg, input_node)
        ref = dag.execute(*args)
        out.append(pkg.get(ref, timeout=TIMEOUT_S) if isinstance(ref, pkg.ObjectRef) else ref)
    return out


def test_function_dag_execute(both):
    def graph(pkg, InputNode):
        @pkg.remote
        def double(x):
            return x * 2

        @pkg.remote
        def add(a, b):
            return a + b

        return add.bind(double.bind(InputNode()), double.bind(3)), (5,)

    jax_out, torch_out = _run(graph)
    assert jax_out == torch_out == 16  # 5*2 + 3*2


def test_dag_diamond_shares_node(both):
    def graph(pkg, InputNode):
        @pkg.remote
        def bump(x):
            import os

            return x + 1, os.getpid()

        @pkg.remote
        def pair(a, b):
            return (a, b)

        shared = bump.bind(InputNode())
        return pair.bind(shared, shared), (1,)  # the shared node executes once

    jax_out, torch_out = _run(graph)
    for (a, pid_a), (b, pid_b) in (jax_out, torch_out):
        assert a == b == 2 and pid_a == pid_b
    assert [x[0] for x in jax_out] == [x[0] for x in torch_out]


def test_actor_dag(both):
    def graph(pkg, InputNode):
        @pkg.remote
        class Counter:
            def __init__(self, start):
                self.n = start

            def add(self, k):
                self.n += k
                return self.n

        node = Counter.bind(10)
        return node.add.bind(InputNode()), (5,)

    jax_out, torch_out = _run(graph)
    assert jax_out == torch_out == 15


def test_one_actor_per_execute_and_kwargs(both):
    def graph(pkg, InputNode):
        @pkg.remote
        class Acc:
            def __init__(self, start=0):
                self.n = start

            def add(self, k):
                self.n += k
                return self.n

        @pkg.remote
        def combine(a, b, scale=1):
            return (a + b) * scale

        acc = Acc.bind(start=100)
        first = acc.add.bind(InputNode())
        second = acc.add.bind(first)  # the same actor: 100 + x, then + (100 + x)
        return combine.bind(first, second, scale=InputNode()), (3,)

    jax_out, torch_out = _run(graph)
    assert jax_out == torch_out == (103 + 206) * 3


def test_input_node_root_and_options(both):
    def graph(pkg, InputNode):
        return InputNode(), ((1, 2),)

    assert _run(graph) == [(1, 2), (1, 2)]

    def with_options(pkg, InputNode):
        @pkg.remote
        def named():
            return "ok"

        from importlib import import_module

        FunctionNode = import_module(f"{pkg.__name__}.dag").FunctionNode
        return FunctionNode(named, (), {}, options={"num_cpus": 0.5}), ()

    assert _run(with_options) == ["ok", "ok"]


def test_bind_builds_nodes_of_the_ports_dag():
    from ray_tpu_torch.dag import ClassMethodNode, ClassNode, DAGNode, FunctionNode

    @ray_tpu_torch.remote
    def f(x):
        return x

    @ray_tpu_torch.remote
    class A:
        def m(self):
            return 1

    node = f.bind(TorchInputNode())
    cls = A.bind()
    assert isinstance(node, FunctionNode) and isinstance(cls, ClassNode)
    assert isinstance(cls.m.bind(), ClassMethodNode) and isinstance(node, DAGNode)
    assert node._children() and isinstance(node._children()[0], TorchInputNode)
    assert ray_tpu_torch.dag.__all__ == ray_tpu.dag.__all__
