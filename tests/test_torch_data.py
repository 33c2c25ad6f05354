"""The port's Data library (``ray_tpu_torch.data``) against the JAX package's
(``ray_tpu.data``) on the CPU: both runtimes run in this process, and the same
numpy inputs (a fixed seed) go through the same calls in each.

Results must be equal, in the order each package promises: transforms,
``random_shuffle(seed=)``, ``sort``, ``repartition``, ``split``, ``zip``,
``limit`` and ``iter_batches`` keep a block order both packages fix, so they
are compared as they come; ``groupby`` rows come sorted by key in both;
``streaming_split`` hands blocks to whichever consumer asks first, so its
splits are compared as sorted sets of rows with the split sizes ``equal=True``
promises. ``iter_torch_batches(device="cpu")`` is held against the JAX
package's default (CPU tensors). The GPU seams of the port are checked on
logical GPUs: no CUDA is touched.
"""

import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jd
from ray_tpu.data.datasource import write_tfrecords as j_write_tfrecords
from ray_tpu_torch import data as td
from ray_tpu_torch.data.datasource import write_tfrecords as t_write_tfrecords

# A pool whose actor fails in __init__ must fail the consuming call within
# this many seconds (the pool's first call raises the actor's creation error).
INIT_FAILURE_LIMIT_S = 60


@pytest.fixture(scope="module")
def both():
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _items(n=60, seed=0):
    rng = np.random.default_rng(seed)
    return [{"k": int(k), "g": int(g), "v": float(v)}
            for k, g, v in zip(rng.permutation(n), rng.integers(0, 4, n), rng.standard_normal(n))]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


def _run(fn):
    """``fn(data_module)`` through each package: (JAX's, the port's)."""
    return fn(jd), fn(td)


def test_map_batches_with_tasks(both):
    def pipeline(d):
        return (d.from_items(_items(), parallelism=4)
                .map_batches(lambda b: {"k": b["k"] * 2, "v": b["v"] + 1.0}, batch_size=7)
                .filter(lambda r: r["k"] % 4 == 0).take_all())

    _same(*_run(pipeline))


def test_map_batches_with_actors(both):
    def pipeline(d):
        class Scale:
            def __init__(self, c):
                self.c = c

            def __call__(self, b):
                return {"k": b["k"], "v": b["v"] * self.c}

        return (d.from_items(_items(), parallelism=6)
                .map(lambda r: {"k": r["k"] + 1, "v": r["v"]})
                .map_batches(Scale, fn_constructor_args=(3.0,), compute="actors", num_actors=2)
                .take_all())

    jax_rows, port_rows = _run(pipeline)
    _same(jax_rows, port_rows)
    assert len(port_rows) == 60


@pytest.mark.parametrize("seed", [0, 7])
def test_random_shuffle_with_a_seed(both, seed):
    jax_rows, port_rows = _run(lambda d: d.range(200, parallelism=4).random_shuffle(seed=seed)
                               .take_all())
    _same(jax_rows, port_rows)
    assert [r["id"] for r in port_rows] != list(range(200))


@pytest.mark.parametrize("descending", [False, True])
def test_sort(both, descending):
    _same(*_run(lambda d: d.from_items(_items(), parallelism=5)
                .sort("k", descending=descending).take_all()))


def test_groupby_aggregates(both):
    def aggs(d):
        ds = d.from_items(_items(), parallelism=3)
        return [ds.groupby("g").count().take_all(), ds.groupby("g").sum("v").take_all(),
                ds.groupby("g").mean("v").take_all(), ds.groupby("g").max("k").take_all()]

    for a, b in zip(*_run(aggs)):
        _same(a, b)


def test_repartition_split_zip_and_limit(both):
    def ops(d):
        re = d.range(103, parallelism=7).repartition(4)
        splits = d.range(103, parallelism=5).split(4, equal=True)
        uneven = d.range(40, parallelism=6).split(3)
        zipped = d.range(10).zip(d.range(10).map_batches(lambda x: {"id2": x["id"] * 3}))
        return ([re.num_blocks(), re.take_all()],
                [s.take_all() for s in splits], [s.take_all() for s in uneven],
                zipped.take_all(), d.range(50, parallelism=3).limit(7).take_all())

    (jre, jsplits, juneven, jzip, jlimit), (tre, tsplits, tuneven, tzip, tlimit) = _run(ops)
    assert jre[0] == tre[0] == 4
    _same(jre[1], tre[1])
    assert [len(s) for s in tsplits] == [25, 25, 25, 25]
    for a, b in zip(jsplits + juneven, tsplits + tuneven):
        _same(a, b)
    _same(jzip, tzip)
    _same(jlimit, tlimit)
    assert [r["id"] for r in tlimit] == list(range(7))


@pytest.mark.parametrize("drop_last", [False, True])
def test_iter_batches(both, drop_last):
    jb, tb = _run(lambda d: list(d.range(100, parallelism=7)
                                 .iter_batches(batch_size=32, drop_last=drop_last)))
    assert [len(b["id"]) for b in tb] == ([32] * 3 if drop_last else [32, 32, 32, 4])
    _same(jb, tb)


def test_streaming_split_equal(both):
    def consume_splits(d, runtime):
        its = d.range(64, parallelism=8).streaming_split(2, equal=True)

        @runtime.remote
        def consume(it):
            return [int(x) for b in it.iter_batches(batch_size=8) for x in b["id"]]

        return runtime.get([consume.remote(it) for it in its], timeout=120), its[0].stats()

    (j0, j1), jstats = consume_splits(jd, ray_tpu)
    (t0, t1), tstats = consume_splits(td, ray_tpu_torch)
    assert sorted(j0 + j1) == sorted(t0 + t1) == list(range(64))
    assert tstats["blocks_out"] == jstats["blocks_out"] == 8
    # equal=True: each split ends with k or k+1 blocks.
    assert abs(tstats["blocks_per_split"][0] - tstats["blocks_per_split"][1]) <= 1


def test_tfrecords_round_trip_across_the_packages(both, tmp_path):
    rows = [{"name": b"alice", "score": 1.5, "age": 30, "xs": [1.0, 2.0]},
            {"name": b"bob", "score": 2.5, "age": -40, "xs": [3.0, 4.0]}]
    t_write_tfrecords(rows, str(tmp_path / "port.tfrecord"))
    j_write_tfrecords(rows, str(tmp_path / "jax.tfrecord"))
    assert (tmp_path / "port.tfrecord").read_bytes() == (tmp_path / "jax.tfrecord").read_bytes()
    for path in ("port.tfrecord", "jax.tfrecord"):
        jax_rows, port_rows = _run(lambda d: d.read_tfrecords(str(tmp_path / path)).take_all())
        _same(jax_rows, port_rows)
        assert [r["name"] for r in port_rows] == [b"alice", b"bob"]


def test_iter_torch_batches_on_the_cpu(both):
    jax_batches = list(jd.range(20, parallelism=3).map_batches(
        lambda b: {"id": b["id"], "x": b["id"].astype(np.float32) / 2}).iter_torch_batches(
        batch_size=8, dtypes={"x": torch.float64}))
    port_batches = list(td.range(20, parallelism=3).map_batches(
        lambda b: {"id": b["id"], "x": b["id"].astype(np.float32) / 2}).iter_torch_batches(
        batch_size=8, dtypes={"x": torch.float64}, device="cpu"))
    assert len(jax_batches) == len(port_batches) == 3
    for a, b in zip(jax_batches, port_batches):
        assert sorted(a) == sorted(b) == ["id", "x"]
        for k in a:
            assert b[k].device.type == "cpu" and b[k].dtype == a[k].dtype
            assert torch.equal(a[k], b[k])
    it = td.range(12, parallelism=2).streaming_split(1)[0]
    got = torch.cat([b["id"] for b in it.iter_torch_batches(batch_size=5, device="cpu")])
    assert got.tolist() == list(range(12))


def test_iter_torch_batches_without_a_device_needs_a_gpu(both, monkeypatch):
    # The port's rule: no device means the GPU, raising without one (the JAX
    # package gives CPU tensors; ROADMAP.md Queue 3).
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(iter(td.range(8).iter_torch_batches(batch_size=4)))
    it = td.range(8).streaming_split(1)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(iter(it.iter_torch_batches(batch_size=4)))


def test_actor_pool_holds_its_gpu_share(both):
    def where(b):
        import os

        return {"id": b["id"], "visible": np.array([os.environ.get("CUDA_VISIBLE_DEVICES")]
                                                     * len(b["id"]))}

    class Where:
        def __call__(self, b):
            return where(b)

    rows = td.range(16, parallelism=4).map_batches(Where, compute="actors", num_actors=2,
                                                     num_gpus=0.5).take_all()
    assert sorted(int(r["id"]) for r in rows) == list(range(16))
    assert {str(r["visible"]) for r in rows} == {"0"}
    # Without a share the pool's actors see no GPU, as the reference's pool.
    rows = td.range(4).map_batches(Where, compute="actors", num_actors=1).take_all()
    assert {str(r["visible"]) for r in rows} == {""}
    with pytest.raises(ValueError, match="num_gpus applies to compute='actors'"):
        td.range(4).map_batches(where, num_gpus=1)


def test_actor_pool_beyond_the_cluster_gpus_raises(both):
    class Ident:
        def __call__(self, b):
            return b

    ds = td.range(8).map_batches(Ident, compute="actors", num_actors=3, num_gpus=0.5)
    with pytest.raises(ValueError, match=r"asks for 1.5 GPU \(3 actors x 0.5\) but the "
                                         r"cluster has 1"):
        ds.take_all()
    # No share is held once earlier pools' actors are gone.
    deadline = time.monotonic() + 30
    while ray_tpu_torch.available_resources().get("GPU") != 1.0:
        assert time.monotonic() < deadline, ray_tpu_torch.available_resources()
        time.sleep(0.1)


def test_actor_init_failure_fails_the_consumer(both):
    class Broken:
        def __init__(self):
            raise RuntimeError("the UDF's constructor failed")

        def __call__(self, b):
            return b

    caught = []

    def consume():
        try:
            td.range(16, parallelism=4).map_batches(Broken, compute="actors").take_all()
        except Exception as e:  # noqa: BLE001 - the test reads what was raised
            caught.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(INIT_FAILURE_LIMIT_S)
    assert not t.is_alive(), f"take_all still running after {INIT_FAILURE_LIMIT_S} s"
    assert len(caught) == 1 and isinstance(caught[0], ray_tpu_torch.exceptions.RayActorError)
    assert "creation" in str(caught[0])
