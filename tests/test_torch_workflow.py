"""The port's durable workflows (``ray_tpu_torch.workflow``) against the JAX
package's (``ray_tpu.workflow``) on the CPU: both runtimes run in this
process, and the same DAG runs through each package's ``workflow.run`` with
the same arguments and a storage root of its own. The outputs, statuses,
stored step ids and resume behaviour must be the same, exactly.
"""

import glob
import os

import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import workflow as jworkflow
from ray_tpu.dag import InputNode as JaxInputNode
from ray_tpu_torch import workflow as tworkflow
from ray_tpu_torch.dag import InputNode as TorchInputNode

PACKAGES = ((ray_tpu, jworkflow, JaxInputNode), (ray_tpu_torch, tworkflow, TorchInputNode))


@pytest.fixture
def both():
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _steps(root, wid):
    return sorted(os.path.basename(p)[:-4] for p in glob.glob(os.path.join(root, wid, "steps",
                                                                           "*.pkl")))


def test_workflow_dag_matches_jax(both, tmp_path):
    # A diamond with keyword arguments and a constant: every step stored once
    # under the same deterministic id, the same output, status and listing.
    seen = []
    for pkg, workflow, InputNode in PACKAGES:
        @pkg.remote
        def scale(x, k=1):
            return x * k

        @pkg.remote
        def add(a, b, c=0):
            return a + b + c

        x = scale.bind(InputNode(), k=3)
        dag = add.bind(x, scale.bind(x, k=2), c=add.bind(x, 1))
        root = str(tmp_path / pkg.__name__)
        out = workflow.run(dag, args=(5,), workflow_id="diamond", storage_root=root)
        seen.append((out, workflow.get_status("diamond", root),
                     workflow.get_output("diamond", root), workflow.list_all(root),
                     _steps(root, "diamond")))
    assert seen[1] == seen[0]
    assert seen[1][0] == 15 + 30 + 16 and seen[1][1] == "SUCCESSFUL"


def _make_flaky(pkg, marker, counter):
    @pkg.remote
    def counted(x):
        with open(counter, "a") as f:
            f.write("run\n")
        return x + 100

    @pkg.remote
    def flaky(y):
        import os

        if not os.path.exists(marker):
            open(marker, "w").write("1")
            raise RuntimeError("simulated crash")
        return y * 2

    return counted, flaky


def test_workflow_resume_matches_jax(both, tmp_path):
    # The second step fails once: the run raises and the workflow is FAILED;
    # resume loads the first step from storage (it ran once) and finishes.
    seen = []
    for pkg, workflow, InputNode in PACKAGES:
        root = str(tmp_path / pkg.__name__)
        os.makedirs(root)
        counter = os.path.join(root, "counted.log")
        counted, flaky = _make_flaky(pkg, os.path.join(root, "marker"), counter)
        dag = flaky.bind(counted.bind(InputNode()))
        with pytest.raises(Exception, match="simulated crash"):
            workflow.run(dag, args=(1,), workflow_id="wf", storage_root=root)
        failed = (workflow.get_status("wf", root), _steps(root, "wf"))
        with pytest.raises(ValueError, match="no completed result"):
            workflow.get_output("wf", root)
        out = workflow.resume("wf", root)
        with open(counter) as f:
            runs = f.read().count("run")
        seen.append((failed, out, workflow.get_status("wf", root), runs, _steps(root, "wf"),
                     workflow.resume("wf", root)))
    assert seen[1] == seen[0]
    assert seen[1][0][0] == "FAILED" and seen[1][1] == 202 and seen[1][3] == 1


def test_workflow_run_async_delete_and_refusals_match_jax(both, tmp_path):
    seen = []
    for pkg, workflow, InputNode in PACKAGES:
        @pkg.remote
        def ident(x):
            return x

        root = str(tmp_path / pkg.__name__)
        wid, ref = workflow.run_async(ident.bind(InputNode()), args=(7,), storage_root=root)
        value = pkg.get(ref, timeout=30)
        with pytest.raises(ValueError, match="no workflow"):
            workflow.resume("missing", root)
        workflow.delete(wid, root)
        seen.append((value, workflow.get_status(wid, root), workflow.list_all(root)))
    assert seen[1] == seen[0] == (7, "NOT_FOUND", {})


def test_workflow_stores_device_tensors_on_the_host(both, tmp_path):
    # The DAG's arguments and each step's output are written by the
    # host-lowering pickler, so a tensor the driver passes comes back as a
    # CPU tensor from storage, and the supervisor, a CPU task, loads it.
    @ray_tpu_torch.remote
    def double(t):
        return t * 2

    root = str(tmp_path / "wf")
    arg = torch.arange(4.0)
    out = tworkflow.run(double.bind(TorchInputNode()), args=(arg,), workflow_id="t",
                        storage_root=root)
    assert torch.equal(out, arg * 2)
    with open(os.path.join(root, "t", "dag.pkl"), "rb") as f:
        assert b"_tensor_from_numpy" in f.read()
    step = os.path.join(root, "t", "steps", _steps(root, "t")[-1] + ".pkl")
    with open(step, "rb") as f:
        assert b"_tensor_from_numpy" in f.read()
    stored = tworkflow.get_output("t", root)
    assert stored.device.type == "cpu" and torch.equal(stored, arg * 2)
