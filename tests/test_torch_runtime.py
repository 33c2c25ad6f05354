"""The port's one-node runtime (ray_tpu_torch) against the JAX package's
(ray_tpu) on the CPU: the same small programs run through one runtime and then
the other, and their results must be equal exactly. Then what only the port
has: GPU device ids per actor (logical GPUs; no CUDA is touched), and workers
that load neither jax nor ray_tpu."""

import os
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

RUNTIMES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}


def _scheduling(rt):
    """The placement-group scheduling strategy class of runtime ``rt``."""
    return __import__(f"{rt.__name__}.util.scheduling_strategies",
                      fromlist=["x"]).PlacementGroupSchedulingStrategy


def _placement(rt):
    return __import__(f"{rt.__name__}.util.placement_group", fromlist=["x"])


# ------------------------------------------------------------------ programs
def prog_object_ref_args(rt):
    @rt.remote
    def square(x):
        return x * x

    @rt.remote
    def add(a, b):
        return a + b

    refs = [square.remote(i) for i in range(5)]
    total = add.remote(add.remote(refs[0], refs[1]), square.remote(refs[2]))
    return rt.get(refs) + [rt.get(total)]


def prog_put_get_8mb(rt):
    a = np.random.default_rng(0).standard_normal(1 << 20)  # 8 MB of float64
    back = rt.get(rt.put(a))

    @rt.remote
    def stats(x):
        return float(x.sum()), x.dtype.str, x.shape

    return back.tobytes() == a.tobytes(), rt.get(stats.remote(rt.put(a)))


def prog_wait(rt):
    @rt.remote
    def slow(x):
        time.sleep(1.0)
        return x

    ready_refs = [rt.put(i) for i in range(2)]
    slow_ref = slow.remote(7)
    ready, not_ready = rt.wait(ready_refs + [slow_ref], num_returns=2, timeout=30)
    first = (sorted(rt.get(ready)), len(not_ready))
    ready, not_ready = rt.wait(ready_refs + [slow_ref], num_returns=3, timeout=30)
    return first, (sorted(rt.get(ready)), len(not_ready))


def prog_actor(rt):
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def add(self, k):
            self.n += k
            return self.n

    c = Counter.remote(10)
    return rt.get([c.add.remote(k) for k in range(5)])


def prog_kill(rt):
    @rt.remote
    class Echo:
        def ping(self, x):
            return x

    a = Echo.remote()
    before = rt.get(a.ping.remote("up"))
    rt.kill(a)
    try:
        rt.get(a.ping.remote("down"), timeout=30)
        after = None
    except Exception as e:  # the runtime's own RayActorError
        after = type(e).__name__
    return before, after


def prog_strict_pack(rt):
    pgm = _placement(rt)
    pg = pgm.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_PACK")
    ok = pg.ready(timeout=30)

    @rt.remote(num_cpus=1)
    class Where:
        def node(self):
            return rt.get_runtime_context().get_node_id()

    actors = [
        Where.options(scheduling_strategy=_scheduling(rt)(
            placement_group=pg, placement_group_bundle_index=i)).remote()
        for i in range(2)
    ]
    same_node = len(set(rt.get([a.node.remote() for a in actors]))) == 1
    too_big = pgm.placement_group([{"CPU": 3}, {"CPU": 3}], strategy="STRICT_PACK")
    fits = too_big.ready(timeout=0.5)
    pgm.remove_placement_group(too_big)
    pgm.remove_placement_group(pg)
    return ok, same_node, fits


PROGRAMS = {f.__name__: f for f in (prog_object_ref_args, prog_put_get_8mb, prog_wait,
                                    prog_actor, prog_kill, prog_strict_pack)}


@pytest.fixture(scope="module")
def results():
    """Every program through ray_tpu, then through ray_tpu_torch: one runtime
    at a time, each started with init(num_cpus=4) and shut down after."""
    out = {}
    for name, rt in RUNTIMES.items():
        rt.init(num_cpus=4)
        try:
            out[name] = {p: prog(rt) for p, prog in PROGRAMS.items()}
        finally:
            rt.shutdown()
    return out


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_program_matches_ray_tpu(results, program):
    assert results["ray_tpu_torch"][program] == results["ray_tpu"][program]


def test_programs_give_the_expected_values(results):
    r = results["ray_tpu_torch"]
    assert r["prog_object_ref_args"] == [0, 1, 4, 9, 16, 17]
    assert r["prog_put_get_8mb"][0] is True
    assert r["prog_wait"] == (([0, 1], 1), ([0, 1, 7], 0))
    assert r["prog_actor"] == [10, 11, 13, 16, 20]
    assert r["prog_kill"] == ("up", "RayActorError")
    assert r["prog_strict_pack"] == (True, True, False)


# ------------------------------------------------------------------ the port alone
@pytest.fixture(params=[(None, 2, ["0", "1"]), ("3,5", None, ["3", "5"])],
                ids=["num_gpus=2", "CUDA_VISIBLE_DEVICES=3,5"])
def port_gpus(request, monkeypatch):
    """The port with two logical GPUs (no CUDA is used): given as num_gpus=2,
    or counted from the driver's CUDA_VISIBLE_DEVICES, whose ids the node
    then hands out. Yields the ids the node's actors should see."""
    visible, num_gpus, ids = request.param
    if visible is not None:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    ray_tpu_torch.init(num_cpus=4, num_gpus=num_gpus)
    yield ids
    ray_tpu_torch.shutdown()


def test_gpu_actors_get_distinct_device_ids_and_reuse_freed_ones(port_gpus):
    rt = ray_tpu_torch
    assert rt.cluster_resources()["GPU"] == 2

    @rt.remote(num_gpus=1)
    class Holder:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    a, b = Holder.remote(), Holder.remote()
    ids = rt.get([a.visible.remote(), b.visible.remote()])
    assert sorted(ids) == port_gpus
    rt.kill(a)
    deadline = time.time() + 30
    while rt.available_resources().get("GPU", 0) < 1 and time.time() < deadline:
        time.sleep(0.05)
    c = Holder.remote()
    assert rt.get(c.visible.remote(), timeout=30) == ids[0]


def _visible_actor(rt, **options):
    @rt.remote(**options)
    class Visible:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    return Visible


def test_actors_without_gpus_see_none_and_fractions_pack(port_gpus):
    rt = ray_tpu_torch
    # An actor that holds no GPU must not inherit the driver's devices.
    assert rt.get(_visible_actor(rt).remote().visible.remote(), timeout=30) == ""
    # Two halves share one id, so a whole GPU is still free for a third actor.
    half = _visible_actor(rt, num_gpus=0.5)
    h1, h2 = half.remote(), half.remote()
    assert rt.get([h1.visible.remote(), h2.visible.remote()], timeout=30) == [port_gpus[0]] * 2
    whole = _visible_actor(rt, num_gpus=1).remote()
    assert rt.get(whole.visible.remote(), timeout=30) == port_gpus[1]


def test_a_whole_gpu_waits_while_fractions_hold_every_id():
    rt = ray_tpu_torch
    rt.init(num_cpus=6, num_gpus=3)
    try:
        part = _visible_actor(rt, num_gpus=0.6)
        parts = [part.remote() for _ in range(3)]
        assert sorted(rt.get([p.visible.remote() for p in parts], timeout=30)) == ["0", "1", "2"]
        # The totals admit one more GPU (1.2 free), but no id is whole.
        assert rt.available_resources()["GPU"] == pytest.approx(1.2)
        whole = _visible_actor(rt, num_gpus=1).remote()
        ready, _ = rt.wait([whole.visible.remote()], timeout=2)
        assert not ready
        freed = rt.get(parts[1].visible.remote())
        rt.kill(parts[1])
        assert rt.get(whole.visible.remote(), timeout=30) == freed
    finally:
        rt.shutdown()


def test_tasks_get_no_device_ids_and_a_gpu_less_node_has_no_gpu(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    ray_tpu_torch.init(num_cpus=4)
    try:
        assert "GPU" not in ray_tpu_torch.cluster_resources()

        @ray_tpu_torch.remote
        def visible():
            return os.environ.get("CUDA_VISIBLE_DEVICES")

        # Tasks inherit the driver's environment: no ids of their own.
        assert ray_tpu_torch.get(visible.remote()) == ""
    finally:
        ray_tpu_torch.shutdown()


def test_port_workers_load_no_jax_and_no_ray_tpu():
    ray_tpu_torch.init(num_cpus=4)
    try:
        @ray_tpu_torch.remote
        def loaded():
            import sys

            return sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                          or m == "ray_tpu" or m.startswith("ray_tpu."))

        @ray_tpu_torch.remote
        class Probe:
            def loaded(self):
                return loaded.remote()

        assert ray_tpu_torch.get(loaded.remote()) == []
        assert ray_tpu_torch.get(ray_tpu_torch.get(Probe.remote().loaded.remote())) == []
    finally:
        ray_tpu_torch.shutdown()
