"""GPU_SLICE placement (``ray_tpu_torch/util/gpu_topology_policy.py`` and the
scheduler's ``_plan_gpu_slice``) against the JAX package's TPU_SLICE.

The end-to-end scenarios mirror ``tests/test_tpu_topology.py``'s on NVLink
domain labels (``gpu_nvlink_domain``) instead of ICI host coordinates: a
gang from one domain, the full domain, never mixing domains, best fit, the
fallback without labels, heterogeneous bundles falling back. Without labels
both strategies fall back to STRICT_SPREAD placement, and there the port's
GPU_SLICE must choose the same nodes, by the order they were added, as the
JAX package's TPU_SLICE. The clusters are virtual nodes of an in-process
runtime (``cluster_utils.Cluster``), one package at a time.
"""

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.gpu_topology_policy import DOMAIN_LABEL, choose_domain_hosts
from ray_tpu_torch.util.placement_group import (
    VALID_STRATEGIES,
    gpu_slice_placement_group,
    placement_group,
)


@pytest.fixture
def cluster():
    c = Cluster(head_node_args={"num_cpus": 1})
    yield c
    c.shutdown()


def _chosen(cluster, pg):
    rec = cluster._scheduler.pgs[PlacementGroupID.from_hex(pg.id)]
    return [b.node for b in rec.bundles]


def _domain_nodes(cluster, domain, count, gpus=8, cpus=2):
    return [cluster.add_node(num_cpus=cpus, num_gpus=gpus, labels={DOMAIN_LABEL: domain})
            for _ in range(count)]


# ------------------------------------------------------------------ pure policy
def test_choose_domain_hosts_takes_one_domain_in_the_given_order():
    domains = {"a": ["a0", "a1", "a2", "a3"], "b": ["b0", "b1"]}
    assert choose_domain_hosts(domains, 2) == ["b0", "b1"]  # best fit: b is exactly 2
    assert choose_domain_hosts(domains, 3) == ["a0", "a1", "a2"]
    assert choose_domain_hosts(domains, 4) == ["a0", "a1", "a2", "a3"]
    assert choose_domain_hosts(domains, 5) is None  # never a mix of a and b
    assert choose_domain_hosts({}, 1) is None and choose_domain_hosts(domains, 0) is None


def test_choose_domain_hosts_ties_and_duplicates():
    # Equal sizes: the domain whose name sorts first, whatever the dict order.
    assert choose_domain_hosts({"z": ["z0", "z1"], "m": ["m0", "m1"]}, 2) == ["m0", "m1"]
    # A host listed twice counts once.
    assert choose_domain_hosts({"a": ["h", "h", "g"]}, 2) == ["h", "g"]
    assert choose_domain_hosts({"a": ["h", "h"]}, 2) is None


# ------------------------------------------------------------------ end-to-end
def test_gpu_slice_takes_its_hosts_from_one_domain(cluster):
    nodes = _domain_nodes(cluster, "hgx-a", 8)
    pg = gpu_slice_placement_group(num_hosts=4, gpus_per_host=8, cpus_per_host=1)
    assert pg.wait(timeout_seconds=30)
    # Four distinct hosts of the domain, in the order they joined.
    assert _chosen(cluster, pg) == nodes[:4]


def test_gpu_slice_full_domain(cluster):
    nodes = _domain_nodes(cluster, "nvl-rack", 8)
    pg = gpu_slice_placement_group(num_hosts=8, gpus_per_host=8, cpus_per_host=1)
    assert pg.wait(timeout_seconds=30)
    assert _chosen(cluster, pg) == nodes


def test_gpu_slice_never_mixes_domains(cluster):
    # Domain A has only 3 free hosts, domain B has 8: a gang of 4 comes from
    # B alone, although A's hosts joined first.
    in_a = _domain_nodes(cluster, "A", 3, cpus=1)
    in_b = _domain_nodes(cluster, "B", 8, cpus=1)
    pg = gpu_slice_placement_group(num_hosts=4, gpus_per_host=8, cpus_per_host=1)
    assert pg.wait(timeout_seconds=30)
    chosen = _chosen(cluster, pg)
    assert set(chosen) <= set(in_b) and not set(chosen) & set(in_a)


def test_gpu_slice_best_fit_keeps_the_large_domain_whole(cluster):
    big = _domain_nodes(cluster, "big", 8)
    small = _domain_nodes(cluster, "small", 4)
    pg = gpu_slice_placement_group(num_hosts=4, gpus_per_host=8, cpus_per_host=1)
    assert pg.wait(timeout_seconds=30)
    assert _chosen(cluster, pg) == small
    # The large domain is still whole for a gang of 8.
    pg8 = gpu_slice_placement_group(num_hosts=8, gpus_per_host=8, cpus_per_host=1)
    assert pg8.wait(timeout_seconds=30)
    assert _chosen(cluster, pg8) == big


def test_gpu_slice_counts_only_hosts_with_room(cluster):
    # One host of the domain is taken: best fit sees 3 free hosts there.
    first = _domain_nodes(cluster, "A", 4, gpus=1)
    other = _domain_nodes(cluster, "B", 4, gpus=1)
    held = placement_group([{"GPU": 1}], strategy="STRICT_PACK")
    assert held.wait(timeout_seconds=30)
    taken = _chosen(cluster, held)[0]
    pg = gpu_slice_placement_group(num_hosts=3, gpus_per_host=1, cpus_per_host=1)
    assert pg.wait(timeout_seconds=30)
    chosen = _chosen(cluster, pg)
    assert taken in first and chosen == [n for n in first if n != taken]
    assert not set(chosen) & set(other)


def test_gpu_slice_falls_back_without_labels(cluster):
    # No labels anywhere: STRICT_SPREAD-style placement on distinct hosts,
    # in the order they joined (the 1-CPU head first).
    nodes = [cluster.add_node(num_cpus=2) for _ in range(3)]
    pg = placement_group([{"CPU": 1}] * 3, strategy="GPU_SLICE")
    assert pg.wait(timeout_seconds=30)
    assert _chosen(cluster, pg) == [cluster.head_node_id] + nodes[:2]


def test_gpu_slice_heterogeneous_bundles_fall_back(cluster):
    # A bundle bigger than any labelled host: spread placement on the big
    # unlabelled node instead of pending forever.
    _domain_nodes(cluster, "A", 4, gpus=1, cpus=1)
    big = cluster.add_node(num_cpus=8)
    pg = placement_group([{"CPU": 1}, {"CPU": 8}], strategy="GPU_SLICE")
    assert pg.wait(timeout_seconds=30)
    chosen = _chosen(cluster, pg)
    assert chosen[1] == big and len(set(chosen)) == 2


def test_gpu_slice_too_few_hosts_stays_pending_and_is_demand(cluster):
    # One labelled host and none without a label that fits: the gang of two
    # waits, and the autoscaler sees both bundles as demand.
    _domain_nodes(cluster, "A", 1, gpus=1)
    pg = gpu_slice_placement_group(num_hosts=2, gpus_per_host=1, cpus_per_host=1)
    assert not pg.wait(timeout_seconds=0.5)
    state = ray_tpu_torch._private.worker.global_worker.context.autoscaler_state()
    assert state["pending_bundles"] == [{"CPU": 1.0, "GPU": 1.0}] * 2
    _domain_nodes(cluster, "A", 1, gpus=1)
    assert pg.wait(timeout_seconds=30)


# ------------------------------------------------------------------ a lost host
def _slice_on_a0_a1(cluster, gpus_per_host):
    """Domains a and b of two 8-GPU hosts each; a gang of two placed on
    [a0, a1]; then a1 dies. Returns (a0, b0, b1, pg)."""
    a0, a1 = _domain_nodes(cluster, "a", 2)
    b0, b1 = _domain_nodes(cluster, "b", 2)
    pg = gpu_slice_placement_group(num_hosts=2, gpus_per_host=gpus_per_host, cpus_per_host=1)
    assert pg.wait(timeout_seconds=30)
    assert _chosen(cluster, pg) == [a0, a1]
    assert cluster.remove_node(a1)
    return a0, b0, b1, pg


def _state(cluster, pg):
    return cluster._scheduler.pgs[PlacementGroupID.from_hex(pg.id)].state


def test_gpu_slice_that_loses_its_domains_last_free_host_waits_as_demand(cluster):
    # g = 8: a0 is full, a has no host left, b is free. The lost bundle is
    # never placed on b (two domains): the gang waits and is demand.
    a0, b0, b1, pg = _slice_on_a0_a1(cluster, 8)
    assert not pg.wait(timeout_seconds=0.5)
    assert _chosen(cluster, pg) == [a0, None]
    assert _state(cluster, pg) == "RESCHEDULING"
    state = ray_tpu_torch._private.worker.global_worker.context.autoscaler_state()
    assert state["pending_bundles"] == [{"CPU": 1.0, "GPU": 8.0}]


def test_gpu_slice_never_re_places_on_a_host_it_holds(cluster):
    # g = 4: a0 has room for the lost bundle too, but one host twice is not a
    # gang of two hosts; b is another domain. So the gang waits.
    a0, b0, b1, pg = _slice_on_a0_a1(cluster, 4)
    assert not pg.wait(timeout_seconds=0.5)
    assert _chosen(cluster, pg) == [a0, None]
    assert _state(cluster, pg) == "RESCHEDULING"


@pytest.mark.parametrize("gpus_per_host", [8, 4])
def test_gpu_slice_re_places_on_a_fresh_host_of_its_domain(cluster, gpus_per_host):
    a0, b0, b1, pg = _slice_on_a0_a1(cluster, gpus_per_host)
    assert not pg.wait(timeout_seconds=0.5)
    (a2,) = _domain_nodes(cluster, "a", 1)
    assert pg.wait(timeout_seconds=30)
    assert _chosen(cluster, pg) == [a0, a2]
    assert _state(cluster, pg) == "CREATED"
    state = ray_tpu_torch._private.worker.global_worker.context.autoscaler_state()
    assert state["pending_bundles"] == []


def test_gpu_slice_placed_by_the_fallback_re_places_on_any_free_distinct_host(cluster):
    # No labels: the gang took distinct hosts by STRICT_SPREAD's rule, and
    # keeps that rule when a host dies: any free host it does not hold, a
    # labelled one included, never a host it holds.
    n0, n1, n2 = (cluster.add_node(num_cpus=2) for _ in range(3))
    pg = placement_group([{"CPU": 2}] * 2, strategy="GPU_SLICE")
    assert pg.wait(timeout_seconds=30)
    assert _chosen(cluster, pg) == [n0, n1]
    assert cluster.remove_node(n1)
    assert pg.wait(timeout_seconds=30)
    assert _chosen(cluster, pg) == [n0, n2]
    assert cluster.remove_node(n2)
    assert not pg.wait(timeout_seconds=0.5)  # n0 has no room for a second bundle
    (a0,) = _domain_nodes(cluster, "a", 1)
    assert pg.wait(timeout_seconds=30)
    assert _chosen(cluster, pg) == [n0, a0]
    assert _state(cluster, pg) == "CREATED"


def test_choose_domain_hosts_excludes_held_hosts_and_keeps_the_pinned_domain():
    domains = {"a": ["a0", "a2"], "b": ["b0", "b1"]}
    assert choose_domain_hosts(domains, 1, exclude=["a0"], domain="a") == ["a2"]
    assert choose_domain_hosts(domains, 2, exclude=["a0"], domain="a") is None
    assert choose_domain_hosts(domains, 1, exclude=["a0", "a2"], domain="a") is None
    assert choose_domain_hosts(domains, 1, exclude=["b0"]) == ["b1"]


def test_tpu_slice_raises_naming_gpu_slice(cluster):
    assert "GPU_SLICE" in VALID_STRATEGIES and "TPU_SLICE" not in VALID_STRATEGIES
    with pytest.raises(ValueError, match="GPU_SLICE"):
        placement_group([{"CPU": 1}], strategy="TPU_SLICE")
    with pytest.raises(ValueError, match="GPU_SLICE"):
        gpu_slice_placement_group(1, strategy="TPU_SLICE")


# ------------------------------------------------------------------ against the JAX package
# Nodes (CPU, accelerators) added in this order after a 1-CPU head, and the
# gangs asked for in turn: without labels, each package's slice strategy falls
# back to STRICT_SPREAD placement.
UNLABELLED = [(2, 4), (1, 4), (2, 0), (4, 4), (1, 4)]
GANGS = [(2, 4, 1), (1, 4, 1), (3, 0, 1)]  # (hosts, accelerators a host, CPUs a host)


def _placements(cluster, make_gang, pgs):
    """Each gang's bundles as the indices, in order of addition, of the nodes
    that hold them (0 is the head); None for a gang that cannot be placed."""
    ids = [cluster.head_node_id] + [cluster.add_node(num_cpus=c, **acc) for c, acc in
                                    ((c, make_gang.accel(a)) for c, a in UNLABELLED)]
    out = []
    for hosts, accel, cpus in GANGS:
        pg = make_gang(hosts, accel, cpus)
        if not pg.wait(timeout_seconds=5):
            out.append(None)
            continue
        rec = cluster._scheduler.pgs[pgs(pg.id)]
        out.append([ids.index(b.node) for b in rec.bundles])
    return out


def test_gpu_slice_without_labels_places_as_the_jax_tpu_slice():
    import ray_tpu
    from ray_tpu._private.ids import PlacementGroupID as JPlacementGroupID
    from ray_tpu.cluster_utils import Cluster as JCluster
    from ray_tpu.util.placement_group import placement_group as j_placement_group

    def j_gang(hosts, chips, cpus):
        bundles = [{"CPU": cpus, **({"TPU": float(chips)} if chips else {})}] * hosts
        return j_placement_group(bundles, strategy="TPU_SLICE")

    j_gang.accel = lambda a: {"num_tpus": a}

    def gang(hosts, gpus, cpus):
        bundles = [{"CPU": cpus, **({"GPU": float(gpus)} if gpus else {})}] * hosts
        return placement_group(bundles, strategy="GPU_SLICE")

    gang.accel = lambda a: {"num_gpus": a}

    jc = JCluster(head_node_args={"num_cpus": 1})
    try:
        ref = _placements(jc, j_gang, JPlacementGroupID.from_hex)
    finally:
        jc.shutdown()
    assert not ray_tpu.is_initialized()
    c = Cluster(head_node_args={"num_cpus": 1})
    try:
        ours = _placements(c, gang, PlacementGroupID.from_hex)
    finally:
        c.shutdown()
    assert ours == ref
    # The scenario places every gang, on distinct nodes each.
    assert all(p is not None and len(set(p)) == len(p) for p in ours), ours
