"""Elastic resharding and the preemption chaos lab of the port
(``ray_tpu_torch.train.torch.resharding``, ``ray_tpu_torch.util.preemption``)
against the JAX package's (``ray_tpu.train.jax.resharding``,
``ray_tpu.util.preemption``), on the CPU.

- The rule matching, ``shard_bounds`` (against ``np.array_split``), the
  shard/gather round trip at even and uneven splits and the 4 -> 3 reshard
  equal the reference's functions on the same trees, for numpy leaves and for
  CPU tensors.
- ``device_put_tree`` places a whole tree on a world-1 ``DeviceMesh`` and
  raises where the reference leaves a leaf on the host.
- A 4-worker elastic ``TorchTrainer`` whose loop stashes its shard with
  ``stash_checkpoint(rules=)`` loses rank 1 to a seeded SIGKILL at round 5,
  re-forms at world 3 from the in-memory mirrors, and finishes bit-exact (the
  counterpart of ``tests/test_elastic.py::test_elastic_shrink_bit_exact``).
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.train.jax import resharding as jres
from ray_tpu.util.preemption import PreemptionSchedule as JSchedule
from ray_tpu_torch.train.torch import resharding as res
from ray_tpu_torch.util.preemption import (
    PreemptionEvent,
    PreemptionSchedule,
    PreemptionSimulator,
)

RULES = [("w", ("data", None)), (".*", ())]


def _same_tree(a, b):
    fa, fb = jres.tree_paths(a), jres.tree_paths(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y), k


def _as_tensors(tree):
    return {k: _as_tensors(v) if isinstance(v, dict) else torch.as_tensor(np.asarray(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_match_partition_rules_equals_jax(leaves):
    tree = {"layer": {"kernel": np.zeros((8, 4)), "bias": np.zeros(4)}, "count": np.float64(3)}
    if leaves == "torch":
        tree = _as_tensors(tree)
    rules = [("kernel", ("data", None)), (".*", ())]
    specs = res.match_partition_rules(rules, tree)
    assert specs == jres.match_partition_rules(rules, tree)
    assert specs == {"layer/kernel": ("data", None), "layer/bias": (), "count": ()}
    with pytest.raises(ValueError, match="no partition rule"):
        res.match_partition_rules([("kernel", ("data", None))], tree)


def test_shard_bounds_match_array_split_and_jax():
    for dim in (6, 7, 12, 13):
        for world in (1, 2, 3, 4, 5):
            splits = np.array_split(np.arange(dim), world)
            for rank in range(world):
                start, stop = res.shard_bounds(dim, world, rank)
                assert (start, stop) == jres.shard_bounds(dim, world, rank)
                assert np.array_equal(np.arange(dim)[start:stop], splits[rank])
    # Not torch.chunk's cut: 10 over 4 is 3, 3, 2, 2 here, 3, 3, 3, 1 there.
    assert [np.subtract(*res.shard_bounds(10, 4, r)[::-1]) for r in range(4)] == [3, 3, 2, 2]


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_shard_gather_roundtrip_equals_jax(leaves):
    tree = {"w": np.arange(28.0).reshape(7, 4), "step": np.float64(9)}
    for world in (2, 3, 4):  # 7 rows: world 3 -> 3/2/2, world 4 -> 2/2/2/1
        ours = {r: res.shard_for_rank(_as_tensors(tree) if leaves == "torch" else tree, RULES,
                                      world, r) for r in range(world)}
        ref = {r: jres.shard_for_rank(tree, RULES, world, r) for r in range(world)}
        for r in range(world):
            _same_tree(ours[r], ref[r])
        rebuilt = res.gather_tree(ours, RULES)
        assert isinstance(rebuilt["w"], torch.Tensor if leaves == "torch" else np.ndarray)
        _same_tree(rebuilt, jres.gather_tree(ref, RULES))
        _same_tree(rebuilt, tree)


def test_shards_hold_no_view_of_the_whole_tree():
    tree = _as_tensors({"w": np.arange(24.0).reshape(6, 4)})
    shard = res.shard_for_rank(tree, RULES, 3, 1)
    tree["w"].add_(1.0)
    assert np.array_equal(shard["w"].numpy(), np.arange(8.0, 16.0).reshape(2, 4))


def test_reshard_across_world_sizes_equals_jax():
    tree = {"w": np.arange(24.0).reshape(6, 4), "step": np.float64(1)}
    shards4 = {r: res.shard_for_rank(tree, RULES, 4, r) for r in range(4)}
    rebuilt = res.gather_tree(shards4, RULES)
    for r in range(3):
        mine = res.reshard(rebuilt, RULES, 3, r)
        _same_tree(mine, res.shard_for_rank(tree, RULES, 3, r))
        _same_tree(mine, jres.reshard(jres.gather_tree(
            {k: jres.shard_for_rank(tree, RULES, 4, k) for k in range(4)}, RULES), RULES, 3, r))
    ck = {"elastic_step": 5, "state": rebuilt, "rules": RULES}
    assert res.resume_state(ck) == jres.resume_state(ck)
    with pytest.raises(KeyError):
        res.resume_state({"state": rebuilt})


def test_device_put_tree_places_on_a_mesh_or_raises():
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from ray_tpu_torch.parallel import MeshSpec

    tree = {"w": np.arange(24.0).reshape(6, 4), "step": np.float64(3)}
    assert res.device_put_tree(tree, RULES) is tree  # no mesh: the host tree
    port = __import__("socket").socket()
    port.bind(("127.0.0.1", 0))
    addr = f"tcp://127.0.0.1:{port.getsockname()[1]}"
    port.close()
    dist.init_process_group("gloo", init_method=addr, rank=0, world_size=1)
    try:
        mesh = MeshSpec(data=1).build(device="cpu")
        placed = res.device_put_tree(tree, RULES, mesh)
        assert isinstance(placed["w"], DTensor) and placed["w"].device.type == "cpu"
        assert placed["w"].placements[0] == Shard(0)
        assert np.array_equal(placed["w"].full_tensor().numpy(), tree["w"])
        assert float(placed["step"].to_local()) == 3.0
        with pytest.raises(ValueError, match="lacks"):
            res.device_put_tree(tree, [("w", ("rows", None)), (".*", ())], mesh)
    finally:
        dist.destroy_process_group()


def test_seeded_schedule_equals_jax():
    a = PreemptionSchedule.seeded(7, n_events=4, world_size=4)
    assert a.events == PreemptionSchedule.seeded(7, n_events=4, world_size=4).events
    ref = JSchedule.seeded(7, n_events=4, world_size=4)
    assert [(e.at_round, e.rank, e.mode, e.grace_s) for e in a.events] == \
        [(e.at_round, e.rank, e.mode, e.grace_s) for e in ref.events]
    assert a.events != PreemptionSchedule.seeded(8, n_events=4, world_size=4).events
    with pytest.raises(ValueError, match="mode must be one of"):
        PreemptionEvent(at_round=1, rank=0, mode="meteor")


# ------------------------------------------------------------------ the elastic shrink
def _expected_loss(steps: int) -> float:
    # sum(arange(24)) + 24 * steps: exact in float64 at these magnitudes.
    return 276.0 + 24.0 * steps


def _make_train_fn(steps: int, sleep_s: float = 0.02):
    """Each rank holds the whole toy state, stashes its shard every step with
    the rules, and resumes from the gathered tree (``resume_state``)."""

    def train_fn(config):
        import time

        from ray_tpu_torch.air import session
        from ray_tpu_torch.train.torch import resharding

        rank, world = session.get_world_rank(), session.get_world_size()
        full = {"w": torch.arange(24.0, dtype=torch.float64).reshape(6, 4),
                "step": np.float64(0)}
        start = 0
        ck = session.get_checkpoint()
        if ck is not None:
            start, st, _ = resharding.resume_state(ck.to_dict())
            full = {"w": torch.as_tensor(st["w"]), "step": np.float64(start)}
        for s in range(start, steps):
            time.sleep(sleep_s)
            full["w"] = full["w"] + 1.0
            full["step"] = np.float64(s + 1)
            session.stash_checkpoint(resharding.shard_for_rank(full, config["rules"], world, rank),
                                     rules=config["rules"], step=s + 1)
            session.report({"step": s + 1, "loss": float(full["w"].sum()), "world": world})

    return train_fn


def test_elastic_shrink_bit_exact():
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.air import FailureConfig, RunConfig, ScalingConfig
    from ray_tpu_torch.train import DataParallelTrainer

    steps = 30
    ray_tpu_torch.init(num_cpus=8)
    sim = PreemptionSimulator(
        PreemptionSchedule([PreemptionEvent(at_round=5, rank=1, mode="kill")])).install()
    try:
        result = DataParallelTrainer(
            _make_train_fn(steps), train_loop_config={"rules": RULES},
            scaling_config=ScalingConfig(num_workers=4, elastic=True),
            run_config=RunConfig(failure_config=FailureConfig(max_failures=0)),
        ).fit()
        events = global_worker.context.cluster_events({"kind": "train_gang_resize"})
    finally:
        sim.uninstall()
        ray_tpu_torch.shutdown()
    assert result.error is None, result.error
    assert result.metrics["step"] == steps and result.metrics["world"] == 3
    assert result.metrics["loss"] == _expected_loss(steps)  # bit-exact
    assert [f["mode"] for f in sim.fired] == ["kill"]
    assert len(events) == 1
    data = events[0]["data"]
    assert (data["old_world"], data["new_world"], data["direction"]) == (4, 3, "shrink")
    # No disk checkpoint existed: the state came from the in-memory mirrors.
    assert data["ckpt_source"] == "memory" and data["step"] >= 1
