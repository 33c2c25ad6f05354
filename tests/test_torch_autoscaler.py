"""The port's autoscaler (``ray_tpu_torch/autoscaler/``) against the JAX
package's, and the node daemon's GPU ids, on the CPU.

- The same ``autoscaler_state`` snapshots through both packages'
  ``StandardAutoscaler`` with recording providers: the same launches by type,
  with the same node configs, and the same terminations by node, in order.
- ``Monitor`` with ``FakeMultiNodeProvider`` in both packages over the same
  pending work: the same launches, the work done, the nodes gone after idle.
- ``LocalDaemonProvider``: a real node daemon holding logical ``GPU: 1``,
  launched for a pending ``GPU_SLICE`` gang and terminated after idle, its
  process and its workers gone.
- A node daemon gives its GPU actors the device ids of its own
  ``CUDA_VISIBLE_DEVICES``, and labels its node with its NVLink domain.
- The GCP GPU provider's ``gcloud`` commands, through a fake runner.
- A nano GPT ``TorchTrainer`` fit whose ``GPU_SLICE`` gang waits for an
  autoscaled daemon node, against ``JaxTrainer`` whose ``TPU_SLICE`` gang
  waits for the JAX package's own autoscaler: the same decisions, and losses
  within rtol 1e-5 (the tolerance of ``tests/test_torch_train.py``).

No GPU is touched: the GPUs are logical, and the trainer runs on the CPU.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import autoscaler as port_autoscaler
from ray_tpu_torch.autoscaler import (
    AutoscalerConfig,
    GcpGpuInstancesProvider,
    LocalDaemonProvider,
    Monitor,
    NodeTypeConfig,
)
from ray_tpu_torch.cluster_utils import Cluster

RTOL = 1e-5


class RecordingProvider:
    """Records create/terminate calls; ids are ``<type>-<n>``."""

    def __init__(self):
        self.created, self.terminated = [], []

    def create_node(self, node_type, node_config):
        self.created.append((node_type, node_config))
        return f"{node_type}-{len(self.created)}"

    def terminate_node(self, nid):
        self.terminated.append(nid)

    def non_terminated_nodes(self):
        return []


def _node(nid, resources, available=None, idle_s=0.0, busy=0, actors=0):
    return {"node_id": nid, "resources": dict(resources),
            "available": dict(resources if available is None else available), "labels": {},
            "alive": True, "busy_workers": busy, "actors": actors, "idle_s": idle_s,
            "is_daemon": True}


def _state(nodes=(), pending=(), bundles=()):
    return {"pending_tasks": list(pending), "pending_bundles": list(bundles),
            "nodes": list(nodes)}


H100 = {"CPU": 2, "GPU": 1}
HGX = {"CPU": 8, "GPU": 8}
CPU4 = {"CPU": 4}

# Each scenario: node types (name -> resources, max_workers, min_workers), the
# idle timeout, and the steps: a snapshot and, optionally, explicit demand
# (request_resources) set before it.
SCENARIOS = {
    "pending_tasks": (
        {"cpu4": (CPU4, 10, 0)}, 60.0,
        [(_state([_node("head", CPU4, {"CPU": 0})], pending=[{"CPU": 2}] * 2), None)]),
    "demand_consumes_capacity": (
        {"cpu2": ({"CPU": 2}, 10, 0)}, 60.0,
        [(_state([_node("head", CPU4, {"CPU": 2})], pending=[{"CPU": 2}] * 3), None)]),
    "pg_bundles": (
        {"cpu2": ({"CPU": 2}, 10, 0)}, 60.0,
        [(_state(bundles=[{"CPU": 1}, {"CPU": 1}, {"CPU": 2}]), None)]),
    "explicit_demand": (
        {"h100": (H100, 10, 0)}, 60.0,
        [(_state([_node("head", CPU4)]), [{"GPU": 1}] * 2),
         (_state([_node("head", CPU4), _node("h100-1", H100), _node("h100-2", H100)]), []),
         ]),
    "gpu_shapes": (
        {"cpu4": (CPU4, 10, 0), "h100": (H100, 10, 0), "hgx": (HGX, 10, 0)}, 60.0,
        [(_state([_node("head", CPU4, {"CPU": 1})],
                 pending=[{"GPU": 1}, {"CPU": 3}, {"CPU": 1, "GPU": 8}, {"GPU": 0.5}],
                 bundles=[{"CPU": 1, "GPU": 1}] * 2), None)]),
    "max_workers": (
        {"h100": (H100, 2, 0)}, 60.0,
        [(_state(bundles=[{"CPU": 1, "GPU": 1}] * 5), None),
         (_state([_node("h100-1", H100, {"CPU": 1, "GPU": 0}, actors=1),
                  _node("h100-2", H100, {"CPU": 1, "GPU": 0}, actors=1)],
                 bundles=[{"CPU": 1, "GPU": 1}] * 3), None)]),
    "max_launches_per_update": (
        {"cpu4": (CPU4, 10, 0)}, 60.0,
        [(_state(pending=[{"CPU": 4}] * 7), None)]),
    "min_workers": (
        {"base": ({"CPU": 2}, 10, 2), "h100": (H100, 4, 1)}, 5.0,
        [(_state(), None),
         (_state([_node("base-1", {"CPU": 2}, idle_s=100.0),
                  _node("base-2", {"CPU": 2}, idle_s=100.0),
                  _node("h100-3", H100, idle_s=100.0)]), None)]),
    "idle_nodes": (
        {"h100": (H100, 10, 1)}, 5.0,
        [(_state(bundles=[{"CPU": 1, "GPU": 1}] * 4), None),
         (_state([_node("h100-1", H100, idle_s=100.0),
                  _node("h100-2", H100, idle_s=100.0, actors=1),
                  _node("h100-3", H100, idle_s=1.0),
                  _node("h100-4", H100, idle_s=100.0, busy=1)]), None),
         (_state([_node("h100-2", H100, idle_s=100.0),
                  _node("h100-3", H100, idle_s=100.0),
                  _node("h100-4", H100, idle_s=100.0)]), None)]),
}


def _decisions(pkg_autoscaler, scenario):
    types, idle_timeout_s, steps = scenario
    cfg = pkg_autoscaler.AutoscalerConfig(
        node_types={name: pkg_autoscaler.NodeTypeConfig(resources=dict(res), max_workers=mx,
                                                        min_workers=mn)
                    for name, (res, mx, mn) in types.items()},
        idle_timeout_s=idle_timeout_s)
    provider = RecordingProvider()
    scaler = pkg_autoscaler.StandardAutoscaler(cfg, provider)
    out = []
    for state, request in steps:
        if request is not None:
            scaler.request_resources(request)
        out.append(scaler.update(state))
    return out, provider.created, provider.terminated


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autoscaler_decisions_match_jax(name):
    from ray_tpu import autoscaler as jax_autoscaler

    ref = _decisions(jax_autoscaler, SCENARIOS[name])
    ours = _decisions(port_autoscaler, SCENARIOS[name])
    assert ours == ref
    # Each scenario decides something.
    assert any(step["launched"] or step["terminated"] for step in ours[0]), ours


def test_gcp_gpu_provider_commands():
    calls = []

    def runner(cmd, **kw):
        calls.append(cmd)
        return type("R", (), {"returncode": 0, "stdout": ""})()

    prov = GcpGpuInstancesProvider(project="proj", zone="us-central1-a",
                                   head_address="10.0.0.1:6379", runner=runner)
    cmd = prov._create_command("node1", {"machine_type": "a3-highgpu-8g"})
    joined = " ".join(cmd)
    assert cmd[:5] == ["gcloud", "compute", "instances", "create", "node1"]
    assert "--machine-type=a3-highgpu-8g" in cmd and "--maintenance-policy=TERMINATE" in cmd
    assert "--project=proj" in cmd and "--zone=us-central1-a" in cmd
    assert "python -m ray_tpu_torch start --address 10.0.0.1:6379" in joined
    nid = prov.create_node("h100_x8", {"machine_type": "a3-highgpu-8g"})
    assert nid.startswith("raytpu-torch-h100-x8-") and prov.non_terminated_nodes() == [nid]
    assert calls[-1][4] == nid
    prov.terminate_node(nid)
    assert calls[-1][:5] == ["gcloud", "compute", "instances", "delete", nid]
    assert prov.non_terminated_nodes() == []
    failing = GcpGpuInstancesProvider(
        "p", "z", "h:1", runner=lambda cmd, **kw: type("R", (), {"returncode": 1,
                                                                "stdout": "quota"})())
    with pytest.raises(RuntimeError, match="quota"):
        failing.create_node("h100", {"machine_type": "a3-highgpu-1g"})


# ------------------------------------------------------------------ Monitor, virtual nodes
class _Recording:
    """Wraps a provider, recording launches (types) and terminations (by the
    order of the launch that made the node)."""

    def __init__(self, inner):
        self.inner, self.launched, self.terminated, self._ids = inner, [], [], []

    def create_node(self, node_type, node_config):
        nid = self.inner.create_node(node_type, node_config)
        self.launched.append(node_type)
        self._ids.append(nid)
        return nid

    def terminate_node(self, nid):
        self.terminated.append(self._ids.index(nid))
        self.inner.terminate_node(nid)

    def non_terminated_nodes(self):
        return self.inner.non_terminated_nodes()


def _wait(cond, timeout_s, what):
    deadline = time.time() + timeout_s
    while not cond():
        assert time.time() < deadline, what
        time.sleep(0.1)


def _monitor_run(pkg, pkg_autoscaler):
    """Three tasks that need a resource only an autoscaled node type holds,
    two of which the type's max_workers allows."""
    pkg.init(num_cpus=2)
    try:
        cfg = pkg_autoscaler.AutoscalerConfig(
            node_types={"special": pkg_autoscaler.NodeTypeConfig(
                resources={"CPU": 1, "special": 1}, max_workers=2)},
            idle_timeout_s=1.0)
        provider = _Recording(pkg_autoscaler.FakeMultiNodeProvider())
        monitor = pkg_autoscaler.Monitor(cfg, provider, interval_s=0.2)
        monitor.start()
        try:
            @pkg.remote(resources={"special": 1})
            def needs_special(i):
                return i * i

            out = pkg.get([needs_special.remote(i) for i in range(3)], timeout=60)
            _wait(lambda: "special" not in pkg.cluster_resources(), 30, "no scale-down")
        finally:
            monitor.stop()
        # Terminations by launch, in any order: when each node's idle clock
        # runs out depends on when its last task ended.
        return out, provider.launched, sorted(provider.terminated)
    finally:
        pkg.shutdown()


def test_monitor_with_fake_nodes_matches_jax():
    import ray_tpu
    from ray_tpu import autoscaler as jax_autoscaler

    ref = _monitor_run(ray_tpu, jax_autoscaler)
    ours = _monitor_run(ray_tpu_torch, port_autoscaler)
    assert ours == ref == ([0, 1, 4], ["special", "special"], [0, 1])


# ------------------------------------------------------------------ real node daemons
def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.fixture
def real_cluster():
    c = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0}, real=True)
    yield c
    c.shutdown()


def test_daemon_gives_its_gpu_actors_its_own_device_ids(monkeypatch, real_cluster):
    # The daemon reads its own CUDA_VISIBLE_DEVICES, as init() and the head
    # do: logical GPU 1 under "3" hands its num_gpus=1 actor "3", not "0".
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    one = real_cluster.add_node(num_cpus=1, num_gpus=1)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5,7")
    two = real_cluster.add_node(num_cpus=2, num_gpus=2)
    monkeypatch.setenv(ray_tpu_torch._private.accelerators.gpu.NVLINK_DOMAIN_ENV, "rack-9")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    unset = real_cluster.add_node(num_cpus=1, num_gpus=1)

    @ray_tpu_torch.remote(num_gpus=1, num_cpus=0)
    class Holder:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    def on(node, n):
        opts = {"scheduling_strategy": NodeAffinitySchedulingStrategy(node.hex(), soft=False)}
        return [Holder.options(**opts).remote() for _ in range(n)]

    holders = {"one": on(one, 1), "two": on(two, 2), "unset": on(unset, 1)}
    seen = {k: sorted(ray_tpu_torch.get([h.visible.remote() for h in hs], timeout=60))
            for k, hs in holders.items()}
    assert seen == {"one": ["3"], "two": ["5", "7"], "unset": ["0"]}
    labels = {n["node_id"]: n["labels"] for n in ray_tpu_torch.nodes()}
    import socket

    assert labels[one.hex()]["gpu_nvlink_domain"] == socket.gethostname()
    assert labels[unset.hex()]["gpu_nvlink_domain"] == "rack-9"
    head = [lab for lab in labels.values() if lab.get("head") == "1"]
    assert head and "gpu_nvlink_domain" not in head[0]  # the head holds no GPU


def test_local_daemon_provider_scales_a_gpu_node_up_and_down(monkeypatch, real_cluster):
    from ray_tpu_torch.util import gpu_slice_placement_group, remove_placement_group
    from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    provider = _Recording(LocalDaemonProvider(real_cluster.address))
    monitor = Monitor(AutoscalerConfig(
        node_types={"h100": NodeTypeConfig(resources={"CPU": 1, "GPU": 1}, max_workers=1)},
        idle_timeout_s=1.0), provider, interval_s=0.2)
    monitor.start()
    try:
        assert ray_tpu_torch.cluster_resources().get("GPU", 0) == 0
        pg = gpu_slice_placement_group(num_hosts=1, gpus_per_host=1, cpus_per_host=1)
        assert pg.wait(timeout_seconds=60)
        # The daemon registers before it reports ready to the provider.
        _wait(lambda: provider.launched, 30, "create_node did not return")
        (nid,) = provider.inner.non_terminated_nodes()
        daemon_pid = provider.inner.pid(nid)

        @ray_tpu_torch.remote(num_gpus=1, num_cpus=1)
        class Holder:
            def where(self):
                return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()

        h = Holder.options(scheduling_strategy=PlacementGroupSchedulingStrategy(pg)).remote()
        visible, worker_pid = ray_tpu_torch.get(h.where.remote(), timeout=60)
        assert visible == "3"
        (node,) = [n for n in ray_tpu_torch.nodes() if n["node_id"] == nid]
        assert node["labels"]["autoscaler_node_type"] == "h100"
        assert "gpu_nvlink_domain" in node["labels"]
        assert ray_tpu_torch.cluster_resources()["GPU"] == 1.0
        # The node holds the actor past the idle timeout: it stays.
        time.sleep(1.5)
        assert provider.terminated == []
        ray_tpu_torch.kill(h)
        remove_placement_group(pg)
        t_idle = time.time()
        _wait(lambda: provider.terminated, 30, "the idle GPU node was not terminated")
        # The idle clock starts when the node's last work left, not at the
        # actor's start (the monitor polls every 0.2 s).
        assert time.time() - t_idle >= 1.0 - 0.2
        _wait(lambda: not _pid_alive(daemon_pid) and not _pid_alive(worker_pid), 15,
              "the daemon or its worker outlived the node")
        _wait(lambda: ray_tpu_torch.cluster_resources().get("GPU", 0) == 0, 15,
              "the cluster still counts the node's GPU")
    finally:
        monitor.stop()
        for nid in provider.inner.non_terminated_nodes():  # after a failure
            provider.inner.terminate_node(nid)
    assert provider.launched == ["h100"] and provider.terminated == [0]
    assert provider.inner.non_terminated_nodes() == []


# ------------------------------------------------------------------ a trainer on an autoscaled node
STEPS = 3
LR = 1e-3


def _nano_inputs():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import GPTConfig, create_train_state, default_optimizer

    state = create_train_state(GPTConfig.nano(dtype=jnp.float32), jax.random.PRNGKey(0),
                               default_optimizer(learning_rate=LR))
    params = jax.tree.map(np.asarray, state.params)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 33)).astype(np.int32)
    return {"params": params, "tokens": tokens, "lr": LR, "steps": STEPS}


def _autoscaled_fit(pkg, cluster_cls, pkg_autoscaler, resources, fit):
    """A real head with no accelerator, a Monitor over a LocalDaemonProvider
    with one node type of ``resources``, ``fit()`` (whose gang needs that
    node), then the idle node's termination. Returns the losses and the
    decisions."""
    cluster = cluster_cls(head_node_args={"num_cpus": 2}, real=True)
    try:
        provider = _Recording(pkg_autoscaler.LocalDaemonProvider(cluster.address))
        monitor = pkg_autoscaler.Monitor(pkg_autoscaler.AutoscalerConfig(
            node_types={"accel_host": pkg_autoscaler.NodeTypeConfig(
                resources=dict(resources), max_workers=1)},
            idle_timeout_s=1.0), provider, interval_s=0.2)
        monitor.start()
        try:
            result = fit()
            _wait(lambda: provider.terminated, 60, "the idle node was not terminated")
        finally:
            monitor.stop()
            for nid in provider.inner.non_terminated_nodes():  # after a failure
                provider.inner.terminate_node(nid)
        assert result.error is None, result.error
        return result.metrics["losses"], provider.launched, provider.terminated
    finally:
        cluster.shutdown()


def _make_jax_loop():
    def loop(config):
        import jax
        import jax.numpy as jnp

        from ray_tpu.air import session
        from ray_tpu.models import GPTConfig, TrainState, default_optimizer, make_train_step

        cfg = GPTConfig.nano(dtype=jnp.float32)
        opt = default_optimizer(learning_rate=config["lr"])
        params = jax.tree.map(jnp.asarray, config["params"])
        state = TrainState(params=params, opt_state=opt.init(params), step=jnp.asarray(0))
        step = make_train_step(cfg, opt, donate=False)
        losses = []
        for _ in range(config["steps"]):
            state, m = step(state, {"tokens": jnp.asarray(config["tokens"])})
            losses.append(float(m["loss"]))
        session.report({"losses": losses})

    return loop


def _make_port_loop():
    def loop(config):
        import torch

        from ray_tpu_torch.air import session
        from ray_tpu_torch.models import GPTConfig, TrainState, default_optimizer, make_train_step
        from ray_tpu_torch.models.convert import params_from_numpy

        cfg = GPTConfig.nano(dtype=torch.float32)
        opt = default_optimizer(learning_rate=config["lr"])
        params = params_from_numpy(config["params"], "cpu", requires_grad=True)
        state = TrainState(params=params, opt_state=opt.init(params), step=0)
        step = make_train_step(cfg, opt)
        losses = []
        for _ in range(config["steps"]):
            state, m = step(state, {"tokens": torch.as_tensor(config["tokens"])})
            losses.append(m["loss"].item())
        session.report({"losses": losses, "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})

    return loop


def test_trainer_gang_waits_for_an_autoscaled_node_as_jax_trainer_does():
    import ray_tpu
    from ray_tpu import autoscaler as jax_autoscaler
    from ray_tpu.air import ScalingConfig as JScalingConfig
    from ray_tpu.cluster_utils import Cluster as JCluster
    from ray_tpu.train.jax import JaxTrainer

    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    config = _nano_inputs()
    ref = _autoscaled_fit(ray_tpu, JCluster, jax_autoscaler, {"CPU": 2, "TPU": 1}, lambda: JaxTrainer(
        _make_jax_loop(), train_loop_config=config,
        scaling_config=JScalingConfig(num_workers=1, use_tpu=True,
                                      placement_strategy="TPU_SLICE")).fit())
    ours = _autoscaled_fit(ray_tpu_torch, Cluster, port_autoscaler, {"CPU": 2, "GPU": 1},
                           lambda: TorchTrainer(
        _make_port_loop(), train_loop_config=config, backend_config=TorchConfig(device="cpu"),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                     placement_strategy="GPU_SLICE")).fit())
    assert ours[1:] == ref[1:] == (["accel_host"], [0])
    assert len(ours[0]) == len(ref[0]) == STEPS
    np.testing.assert_allclose(ours[0], ref[0], rtol=RTOL)
    assert ours[0][-1] < ours[0][0]
