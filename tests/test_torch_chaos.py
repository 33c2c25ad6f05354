"""The port's NodeKiller (``ray_tpu_torch/util/chaos.py``) against the JAX
package's, on virtual clusters of the same shape.

With the same seed and the same nodes, both killers take the same victims,
by the order the nodes were added (respawned nodes count as added after the
ones before them). A respawned node gets back its accelerators: the port's its
``GPU`` (``num_gpus``), where the JAX package's gets back its ``TPU``. Every
kill lands in ``timeline()`` as a ``chaos`` span.
"""

import time

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.chaos import NodeKiller

# (CPU, accelerators) of the nodes added after the head, in order.
NODES = [(2, 1), (1, 0), (2, 2), (4, 1)]
KILLS = 4
SEED = 7


class _Recorded:
    """A cluster that records every node added through it, in order."""

    def __init__(self, cluster):
        self.cluster, self.added = cluster, []

    def add_node(self, num_cpus=1, resources=None, **accel):
        node_id = self.cluster.add_node(num_cpus=num_cpus, resources=resources, **accel)
        self.added.append(node_id.hex())
        return node_id

    def remove_node(self, node_id):
        return self.cluster.remove_node(node_id)


def _churn(pkg, cluster_cls, killer_cls, accel_kw, accel_name):
    cluster = cluster_cls(head_node_args={"num_cpus": 1})
    try:
        rec = _Recorded(cluster)
        for cpus, accel in NODES:
            rec.add_node(num_cpus=cpus, **({accel_kw: accel} if accel else {}))
        killer = killer_cls(rec, interval_s=0.05, respawn=True, max_kills=KILLS, seed=SEED)
        killer.start()
        deadline = time.time() + 60
        while len(killer.respawns) < KILLS and time.time() < deadline:
            time.sleep(0.05)
        killer.stop()
        victims = [rec.added.index(nid) for nid in killer.kills]
        alive = {n["node_id"]: n["resources"] for n in pkg.nodes() if n["alive"]}
        # Each node alive at the end (the head aside) by order of addition,
        # with its CPU and accelerators.
        shape = [(rec.added.index(nid), res.get("CPU"), res.get(accel_name, 0))
                 for nid, res in alive.items() if nid in rec.added]
        spans = [(e["name"], e["args"]["node_id"], e["args"]["kill_index"])
                 for e in pkg.timeline() if e.get("cat") == "chaos"]
        return victims, sorted(shape), (spans, killer.kills)
    finally:
        cluster.shutdown()


def test_node_killer_takes_the_same_victims_and_respawns_gpus():
    import ray_tpu
    from ray_tpu.cluster_utils import Cluster as JCluster
    from ray_tpu.util.chaos import NodeKiller as JNodeKiller

    ref_victims, ref_shape, _ = _churn(ray_tpu, JCluster, JNodeKiller, "num_tpus", "TPU")
    victims, shape, (spans, kills) = _churn(ray_tpu_torch, Cluster, NodeKiller, "num_gpus",
                                            "GPU")
    assert len(victims) == KILLS and victims == ref_victims
    assert shape == ref_shape
    # The respawns hold what the nodes they replace held, GPUs included.
    assert sorted((c, a) for _, c, a in shape) == sorted(
        (float(c), float(a)) for c, a in NODES)
    # Each kill is one zero-length span, in the order of the kills.
    assert spans == [("node_kill", nid, i + 1) for i, nid in enumerate(kills)]
