"""The port's collectives (ray_tpu_torch.util.collective) on the CPU.

- The TCP group, through the port's runtime, on the cases of
  ``tests/test_collective.py``: the op suite across 3 ranks, reduce to
  root, ordered point-to-point, the large-payload ring allreduce (sum, mean,
  max, over a Unix socket) and the product reduce, against the JAX package's
  TCP group running the same program on the same numpy inputs through its own
  runtime: equal, exactly. World-1 semantics in the calling process.
- The device group (``backend="nccl"``) with ``device="cpu"``, which runs
  gloo, in 2- and 3-rank gangs: every op and every ``ReduceOp``, the
  ``*_multidevice`` variants over two local CPU "devices", ``sendrecv``
  permutations and eager send/recv, against numpy.
- Without ``device="cpu"`` the device group refuses CPU tensors (and, with
  no GPU, refuses to start).
- A timed allreduce in a 2-worker gloo ``TorchTrainer`` loop lands in its
  step's collective bucket.
"""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

RING_WORLD = 3


def _make_tcp_program(pkg):
    """One rank of the TCP cases, for the package named ``pkg``."""

    def program(rank, world, n_ring_floats):
        import importlib

        import numpy as np

        col = importlib.import_module(f"{pkg}.util.collective")
        types = importlib.import_module(f"{pkg}.util.collective.types")
        g = "tcp_cases"
        col.init_collective_group(world, rank, backend="tcp", group_name=g)
        out = {}
        out["allreduce"] = col.allreduce(np.full((2,), float(rank + 1)), g)
        out["bcast"] = col.broadcast(
            np.full((2,), 42.0) if rank == 0 else np.zeros(2), src_rank=0, group_name=g)
        out["gather"] = col.allgather(np.array([float(rank)]), g)
        out["rs"] = col.reducescatter(np.arange(4, dtype=np.float64), g)
        out["reduce"] = col.reduce(np.ones(3) * (rank + 1), dst_rank=0, group_name=g)
        out["product"] = col.allreduce(np.full((2,), 2.0), g, op=types.ReduceOp.PRODUCT)
        if rank == 0:
            col.send(np.array([1.0]), dst_rank=1, group_name=g)
            col.send(np.array([2.0]), dst_rank=1, group_name=g)
        elif rank == 1:
            a = col.recv((1,), np.float64, src_rank=0, group_name=g)
            b = col.recv((1,), np.float64, src_rank=0, group_name=g)
            out["p2p"] = (float(a[0]), float(b[0]))
        x = np.arange(n_ring_floats, dtype=np.float32) * (rank + 1)
        for op in ("sum", "mean", "max"):
            out[f"ring_{op}"] = col.allreduce(x.copy(), g, op=types.ReduceOp(op))
        grp = col.get_group(g)
        out["ring_family"] = grp._ring_next.family.name if grp._ring_next is not None else None
        col.barrier(g)
        out["rank"] = col.get_rank(g)
        col.destroy_collective_group(g)
        return out

    return program


def _run_gang(pkg_module, program, world, *args):
    task = pkg_module.remote(num_cpus=1)(program)
    return pkg_module.get([task.remote(r, world, *args) for r in range(world)], timeout=180)


def _ring_floats():
    from ray_tpu_torch.util.collective.collective_group import tcp_group

    return (tcp_group._RING_THRESHOLD_BYTES // 4) * 3 + 5  # past the ring threshold, odd tail


@pytest.fixture(scope="module")
def reference():
    """The JAX package's TCP group on the cases, before the port's runtime."""
    ray_tpu.init(num_cpus=4)
    try:
        return _run_gang(ray_tpu, _make_tcp_program("ray_tpu"), RING_WORLD, _ring_floats())
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port(reference):
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_tcp_group_matches_the_jax_packages(reference, port):
    ours = _run_gang(port, _make_tcp_program("ray_tpu_torch"), RING_WORLD, _ring_floats())
    base = np.arange(_ring_floats(), dtype=np.float32)
    for r, (out, ref) in enumerate(zip(ours, reference)):
        assert out.keys() == ref.keys()
        for key in out:
            if key == "gather":
                assert [a.tolist() for a in out[key]] == [a.tolist() for a in ref[key]]
            elif isinstance(out[key], np.ndarray):
                np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
            else:
                assert out[key] == ref[key], key
        # And the values tests/test_collective.py holds the JAX package to.
        np.testing.assert_allclose(out["allreduce"], np.full((2,), 6.0))
        np.testing.assert_allclose(out["bcast"], np.full((2,), 42.0))
        assert [float(x[0]) for x in out["gather"]] == [0.0, 1.0, 2.0]
        np.testing.assert_allclose(out["rs"], np.array_split(np.arange(4) * 3.0, 3)[r])
        if r == 0:
            np.testing.assert_allclose(out["reduce"], np.full(3, 6.0))
        else:
            assert out["reduce"] is None
        np.testing.assert_allclose(out["product"], np.full((2,), 8.0))
        assert out.get("p2p", (1.0, 2.0)) == (1.0, 2.0)
        np.testing.assert_allclose(out["ring_sum"], base * 6.0, rtol=1e-6)
        np.testing.assert_allclose(out["ring_mean"], base * 2.0, rtol=1e-6)
        np.testing.assert_allclose(out["ring_max"], base * 3.0, rtol=1e-6)
        assert out["ring_family"] == "AF_UNIX" and out["rank"] == r


def test_world_one_groups(port):
    from ray_tpu_torch.util import collective as col

    col.init_collective_group(1, 0, backend="tcp", group_name="solo_tcp")
    x = np.arange(3.0)
    np.testing.assert_allclose(col.allreduce(x, "solo_tcp"), x)
    assert col.get_collective_group_size("solo_tcp") == 1
    col.destroy_collective_group("solo_tcp")
    # The device group on gloo, world 1: every op is its own identity; a
    # send to itself raises (sendrecv is the self-loop).
    col.init_collective_group(1, 0, backend="xla", group_name="solo_dev", device="cpu")
    t = torch.arange(4.0)
    assert torch.equal(col.allreduce(t.clone(), "solo_dev"), t)
    assert torch.equal(col.sendrecv(t, [(0, 0)], "solo_dev"), t)
    assert torch.equal(col.sendrecv(t, [], "solo_dev"), torch.zeros(4))
    assert torch.equal(col.allgather(t, "solo_dev")[0], t)
    out = col.allreduce_multidevice([torch.full((2,), 2.0)], "solo_dev", op="product")
    assert torch.equal(out[0], torch.full((2,), 2.0))
    with pytest.raises(ValueError, match="itself"):
        col.send(t, 0, "solo_dev")
    with pytest.raises(RuntimeError, match="already initialized"):
        col.init_collective_group(1, 0, group_name="solo_dev", device="cpu")
    col.destroy_collective_group("solo_dev")
    assert not col.is_group_initialized("solo_dev")


def _make_device_program():
    def program(rank, world):
        import torch

        from ray_tpu_torch.util import collective as col
        from ray_tpu_torch.util.collective import ReduceOp

        g = f"dev{world}"
        col.init_collective_group(world, rank, backend="nccl", group_name=g, device="cpu",
                                  devices=["cpu", "cpu"])
        out = {"rank": col.get_rank(g), "size": col.get_collective_group_size(g)}

        def x():
            return torch.arange(6, dtype=torch.float32) + rank + 1

        for op in ReduceOp:
            out[f"allreduce_{op.value}"] = col.allreduce(x(), g, op).numpy()
            rows = torch.arange(world * 2, dtype=torch.float32) + rank + 1
            out[f"reducescatter_{op.value}"] = col.reducescatter(rows, g, op).numpy()
            md = col.allreduce_multidevice([x(), 2 * x()], g, op)
            out[f"allreduce_multidevice_{op.value}"] = [t.numpy() for t in md]
        out["bf16_sum"] = col.allreduce(x().to(torch.bfloat16), g).float().numpy()
        red = col.reduce(x(), dst_rank=world - 1, group_name=g)
        out["reduce"] = None if red is None else red.numpy()
        out["broadcast"] = col.broadcast(x(), src_rank=1, group_name=g).numpy()
        out["allgather"] = [t.numpy() for t in col.allgather(x(), g)]
        out["allgather_multidevice"] = [t.numpy() for t in
                                        col.allgather_multidevice([x(), 2 * x()], g)]
        rows = torch.arange(world * 4, dtype=torch.float32).reshape(world * 2, 2) + rank
        out["reducescatter_multidevice"] = [
            t.numpy() for t in col.reducescatter_multidevice([rows, 10 * rows], g)]
        ring = [(i, (i + 1) % world) for i in range(world)]
        out["sendrecv_ring"] = col.sendrecv(x(), ring, g).numpy()
        out["sendrecv_one"] = col.sendrecv(x(), [(0, 1)], g).numpy()
        if rank == 0:
            col.send(torch.tensor([1.0, 2.0]), 1, g)
            col.send(torch.tensor([3.0, 4.0]), 1, g)
        elif rank == 1:
            out["p2p"] = [col.recv((2,), torch.float32, 0, g).tolist() for _ in range(2)]
        col.barrier(g)
        col.destroy_collective_group(g)
        return out

    return program


@pytest.mark.parametrize("world", [2, 3])
def test_device_group_on_gloo_every_op(port, world):
    outs = _run_gang(port, _make_device_program(), world)
    xs = [np.arange(6, dtype=np.float32) + r + 1 for r in range(world)]
    rows = [np.arange(world * 2, dtype=np.float32) + r + 1 for r in range(world)]
    red = {"sum": np.sum, "mean": np.mean, "product": np.prod, "min": np.min, "max": np.max}
    md_in = [v for x in xs for v in (x, 2 * x)]
    rs_md = [np.arange(world * 4, dtype=np.float32).reshape(world * 2, 2) + r for r in range(world)]
    rs_md_total = sum(a + 10 * a for a in rs_md)
    for r, out in enumerate(outs):
        assert (out["rank"], out["size"]) == (r, world)
        for op, fn in red.items():
            np.testing.assert_allclose(out[f"allreduce_{op}"], fn(xs, axis=0), rtol=1e-6)
            np.testing.assert_allclose(out[f"reducescatter_{op}"],
                                       fn(rows, axis=0)[2 * r: 2 * r + 2], rtol=1e-6)
            for t in out[f"allreduce_multidevice_{op}"]:
                np.testing.assert_allclose(t, fn(md_in, axis=0), rtol=1e-6)
        np.testing.assert_allclose(out["bf16_sum"], np.sum(xs, axis=0))
        if r == world - 1:
            np.testing.assert_allclose(out["reduce"], np.sum(xs, axis=0))
        else:
            assert out["reduce"] is None
        np.testing.assert_array_equal(out["broadcast"], xs[1])
        for got, want in zip(out["allgather"], xs):
            np.testing.assert_array_equal(got, want)
        assert len(out["allgather_multidevice"]) == 2 * world
        for got, want in zip(out["allgather_multidevice"], md_in):
            np.testing.assert_array_equal(got, want)
        for i, got in enumerate(out["reducescatter_multidevice"]):
            k = 2 * r + i  # this rank's i-th local device's slice of 2 * world
            np.testing.assert_array_equal(got, rs_md_total[k: k + 1])
        np.testing.assert_array_equal(out["sendrecv_ring"], xs[(r - 1) % world])
        np.testing.assert_array_equal(out["sendrecv_one"], xs[0] if r == 1 else np.zeros(6))
        if r == 1:
            assert out["p2p"] == [[1.0, 2.0], [3.0, 4.0]]


def test_device_group_refuses_the_cpu_unless_asked(monkeypatch):
    from ray_tpu_torch.util.collective.collective_group.nccl_group import NCCLGroup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NCCLGroup(1, 0, "no_gpu")
    with pytest.raises(ValueError, match="'cpu' or None"):
        NCCLGroup(1, 0, "bad_device", device="cuda")
    # A group on the GPU given a CPU tensor (built without its process
    # group, so the check runs without a GPU).
    g = NCCLGroup.__new__(NCCLGroup)
    g.group_name, g.on_cpu, g.device = "gpu_group", False, torch.device("cuda", 0)
    for call in (lambda: g.allreduce(torch.ones(2)), lambda: g.broadcast(torch.ones(2)),
                 lambda: g.allgather(torch.ones(2)), lambda: g.sendrecv(torch.ones(2), [])):
        with pytest.raises(ValueError, match="device='cpu'"):
            call()
    with pytest.raises(TypeError, match="torch tensors"):
        g.allreduce(np.ones(2))


def _make_timed_loop():
    def loop(config):
        import time

        import torch
        import torch.distributed as dist

        from ray_tpu_torch.air import session
        from ray_tpu_torch.util import collective as col
        from ray_tpu_torch.util.collective import collective

        rank = dist.get_rank()
        col.init_collective_group(2, rank, backend="nccl", group_name="timed", device="cpu")
        before = collective._STATS["time_s"]
        t0 = time.perf_counter()
        for _ in range(5):
            col.allreduce(torch.ones(1 << 16), "timed")
        spent = time.perf_counter() - t0
        session.report({"step": 1})
        clock = session._get_session()._clock
        session.report({"in_ops_s": collective._STATS["time_s"] - before, "loop_s": spent,
                        "collective_bucket_s": clock.snapshot()["phases"]["collective"]})
        col.destroy_collective_group("timed")

    return loop


def test_timed_allreduce_lands_in_the_collective_bucket(port):
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    result = TorchTrainer(_make_timed_loop(), scaling_config=ScalingConfig(num_workers=2)).fit()
    assert result.error is None, result.error
    m = result.metrics
    assert 0 < m["in_ops_s"] <= m["loop_s"]
    # The step that ran the allreduces moved their seconds out of step_exec.
    assert m["collective_bucket_s"] == pytest.approx(m["in_ops_s"], rel=1e-6)
