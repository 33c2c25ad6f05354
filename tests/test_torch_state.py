"""The port's state API (``ray_tpu_torch.util.state``) and critical-path
attribution (``ray_tpu_torch._private.critical_path``) against the JAX
package's, on the CPU.

``critical_path`` is pure float arithmetic over plain dicts: the same spans
and stage stamps, made from a numpy seed, must give the same attributions
within 1e-9 (the same operations in the same order give equal floats; the
tolerance only allows for a platform's rounding). The state API reads the
runtime's live tables: both runtimes run in this process, the same small
workload goes through each, and the listings must carry the same keys, the
same ``TASK_STAGES`` and the same ``timeline()`` event categories. The port's
actor listing adds two keys of its own, ``resources`` and ``gpu_ids``.
"""

import json
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu._private import critical_path as j_cp
from ray_tpu.util import state as j_state
from ray_tpu_torch._private import critical_path as t_cp
from ray_tpu_torch.util import state as t_state

CP_TOL = 1e-9
PORT_ACTOR_KEYS = {"resources", "gpu_ids"}


def _traces(seed=0, n=6):
    """``n`` request traces in the shapes the runtime records (a Serve
    request over a router over a task's submit and execute, a transfer, a
    collective and a custom span), at random times, and each task's stage
    stamps, a few of them out of order (three clocks)."""
    rng = np.random.default_rng(seed)
    spans, stages = [], {}
    for t in range(n):
        t0 = float(rng.uniform(0, 100))
        d = rng.uniform(0.001, 0.05, 12)
        trace = f"trace{t:02d}"
        task = f"{t:02d}" + "ab" * 11
        stamps = np.cumsum(np.concatenate([[t0 + d[0]], d[1:7]]))
        stamps[3] -= float(rng.uniform(0, 2 * d[3]))  # skew: may go backwards
        stages[task] = dict(zip(("submit", "queued", "lease_granted", "args_fetched",
                                 "exec_start", "exec_end", "result_stored"), map(float, stamps)))
        end = float(stamps[-1] + d[7])

        def span(sid, parent, kind, name, start, stop, **attrs):
            spans.append({"trace_id": trace, "span_id": f"{trace}-{sid}", "parent_id":
                          f"{trace}-{parent}" if parent else None, "kind": kind, "name": name,
                          "start": start, "end": stop, "status": "OK", "attributes": attrs})

        span("req", None, "request", "POST /app", t0, end + d[8])
        span("route", "req", "router", "route", t0 + d[0] / 2, end)
        span("sub", "route", "submit", "f.remote", float(stamps[0]), float(stamps[1]),
             task_id=task)
        span("exe", "sub", "execute", "f", float(stamps[4]), float(stamps[5]), task_id=task)
        span("xfer", "exe", "transfer", "pull", float(stamps[2]), float(stamps[2] + d[9]))
        if t % 2:
            span("coll", "exe", "collective", "allreduce", float(stamps[4] + d[10] / 4),
                 float(stamps[4] + d[10] / 2))
            span("app", "exe", "custom", "load", float(stamps[4]), float(stamps[4] + d[11]))
        if t == n - 1:
            spans[-1]["status"] = "ERROR"
            spans[-1]["keep"] = "tail"
    # One span still open, one orphan whose parent was never recorded.
    spans.append({"trace_id": "trace00", "span_id": "open", "parent_id": None,
                  "kind": "custom", "name": "open", "start": 1.0, "end": None})
    spans.append({"trace_id": "trace01", "span_id": "orphan", "parent_id": "lost",
                  "kind": "custom", "name": "orphan", "start": spans[0]["start"],
                  "end": spans[0]["start"] + 0.01})
    return spans, stages


def _close(a, b, path="out"):
    """a == b, floats within CP_TOL, same structure and keys."""
    if isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= CP_TOL, (path, a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def test_critical_path_constants_match():
    for name in ("KIND_COMPONENT", "STAGE_COMPONENTS", "COMPONENTS"):
        assert getattr(t_cp, name) == getattr(j_cp, name), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_critical_path_attribution_matches(seed):
    spans, stages = _traces(seed)
    by_trace = j_cp.group_traces(spans)
    assert t_cp.group_traces(spans) == by_trace
    for tid, trace in by_trace.items():
        _close(t_cp.trace_intervals(trace, stages), j_cp.trace_intervals(trace, stages))
        _close(t_cp.attribute(trace, stages), j_cp.attribute(trace, stages))
        _close(t_cp.trace_summary(tid, trace), j_cp.trace_summary(tid, trace))
    for limit in (0, 3, 200):
        _close(t_cp.latency_report(spans, stages, limit=limit),
               j_cp.latency_report(spans, stages, limit=limit))
    attr = t_cp.attribute(by_trace["trace01"], stages)
    assert abs(sum(attr["components"].values()) - attr["total_s"]) <= 1e-5  # rounded to 1e-6
    assert t_cp.attribute([], {}) == j_cp.attribute([], {})


@pytest.fixture
def both():
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4, num_gpus=2)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _workload(pkg):
    """Tasks (one of them failing), an actor with a call, a put and a
    dependency chain through ``pkg``; returns when all have finished."""
    @pkg.remote
    def square(x):
        return x * x

    @pkg.remote
    def fail():
        raise ValueError("boom")

    @pkg.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def add(self, k):
            self.n += k
            return self.n

    ref = pkg.put(np.arange(1000))
    out = pkg.get([square.remote(i) for i in range(4)] + [square.remote(pkg.get(ref)[3])])
    assert out == [0, 1, 4, 9, 9]
    with pytest.raises(Exception):
        pkg.get(fail.remote())
    c = Counter.remote()
    assert pkg.get(c.add.remote(3)) == 3
    return ref, c


def _keys(rows):
    return sorted({k for r in rows for k in r})


def _wait_finished(state, n):
    deadline = time.time() + 30
    while time.time() < deadline:
        done = [t for t in state.list_tasks() if t["state"] in ("FINISHED", "FAILED")]
        if len(done) >= n:
            return
        time.sleep(0.1)


def test_state_api_matches(both, tmp_path):
    assert t_state.TASK_STAGES == j_state.TASK_STAGES
    assert t_state.STAGE_INTERVALS == j_state.STAGE_INTERVALS
    keep = (_workload(ray_tpu), _workload(ray_tpu_torch))
    for state in (j_state, t_state):
        _wait_finished(state, 8)

    j_sum, t_sum = j_state.summarize(), t_state.summarize()
    assert sorted(t_sum) == sorted(j_sum)
    assert sorted(t_sum["task_latency"]) == sorted(j_sum["task_latency"])
    for k in t_sum["task_latency"]:
        assert sorted(t_sum["task_latency"][k]) == sorted(j_sum["task_latency"][k])
    assert t_sum["tasks_by_state"] == j_sum["tasks_by_state"]
    assert (t_sum["nodes"], t_sum["actors"]) == (j_sum["nodes"], j_sum["actors"]) == (1, 1)
    assert t_sum["cluster_resources"]["GPU"] == 2.0 and "TPU" not in t_sum["cluster_resources"]

    j_tasks, t_tasks = j_state.list_tasks(), t_state.list_tasks()
    assert _keys(t_tasks) == _keys(j_tasks)
    assert sorted(t["name"] for t in t_tasks) == sorted(t["name"] for t in j_tasks)
    j_dur = _keys(t["stage_durations"] for t in j_tasks if "stage_durations" in t)
    assert _keys(t["stage_durations"] for t in t_tasks if "stage_durations" in t) == j_dur
    assert set(j_dur) <= set(t_state.STAGE_INTERVALS)
    assert _keys(t_state.list_nodes()) == _keys(j_state.list_nodes())
    assert _keys(t_state.list_objects()) == _keys(j_state.list_objects())
    assert _keys(t_state.list_actors()) == sorted(set(_keys(j_state.list_actors()))
                                                   | PORT_ACTOR_KEYS)
    assert sorted(t_state.memory_summary()) == sorted(j_state.memory_summary())
    assert t_state.training_report() == j_state.training_report() == {"gangs": {}}

    j_tl = j_state.timeline(str(tmp_path / "j.json"))
    t_tl = t_state.timeline(str(tmp_path / "t.json"))
    assert {e["cat"] for e in t_tl} == {e["cat"] for e in j_tl} >= {"task", "task_stage"}
    assert _keys(t_tl) == _keys(j_tl)
    assert [e["ts"] for e in t_tl] == sorted(e["ts"] for e in t_tl)
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == t_tl
    assert ray_tpu_torch.timeline() and {e["cat"] for e in ray_tpu_torch.timeline()} == {
        e["cat"] for e in t_tl}
    del keep


def test_actor_listing_shows_gpu_share_and_device_ids():
    ray_tpu_torch.init(num_cpus=4, num_gpus=2)
    try:
        @ray_tpu_torch.remote(num_gpus=1)
        class OnGPU:
            def visible(self):
                import os

                return os.environ.get("CUDA_VISIBLE_DEVICES")

        @ray_tpu_torch.remote(num_cpus=1)
        class OnCPU:
            def visible(self):
                import os

                return os.environ.get("CUDA_VISIBLE_DEVICES")

        g, c = OnGPU.options(name="g").remote(), OnCPU.options(name="c").remote()
        assert ray_tpu_torch.get([g.visible.remote(), c.visible.remote()]) == ["0", ""]
        actors = {a["name"]: a for a in t_state.list_actors()}
        assert actors["g"]["resources"].get("GPU") == 1.0 and actors["g"]["gpu_ids"] == ["0"]
        assert "GPU" not in actors["c"]["resources"] and actors["c"]["gpu_ids"] == []
        (node,) = t_state.list_nodes()
        assert node["resources"]["GPU"] == 2.0 and node["available"]["GPU"] == 1.0
        ray_tpu_torch.kill(g)
        deadline = time.time() + 30
        while t_state.list_nodes()[0]["available"]["GPU"] < 2.0 and time.time() < deadline:
            time.sleep(0.05)
        actors = {a["name"]: a for a in t_state.list_actors()}
        assert actors["g"]["state"] == "DEAD" and actors["g"]["gpu_ids"] == []
        assert t_state.list_nodes()[0]["available"]["GPU"] == 2.0
    finally:
        ray_tpu_torch.shutdown()
