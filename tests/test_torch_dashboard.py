"""The port's dashboard (``ray_tpu_torch.dashboard``) against the JAX
package's (``ray_tpu.dashboard``), on the CPU.

The JAX package serves its routes with aiohttp; the port with the standard
library's ``http.server``, because the card's machine has no web package.
Each dashboard runs in a process of its own over a runtime that ran the same
small workload, and answers the same requests: every kind in ``VALID_KINDS``,
the bad queries the reference answers with a JSON 400, an unknown kind (a
JSON 404 that lists the kinds), ``/metrics`` and ``/``. Both must give the
same status codes and JSON key sets, and the same 400 and 404 bodies. The
port's process finds packages named aiohttp, fastapi and starlette that raise
on import, first on its path.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("aiohttp", "fastapi", "starlette")
# The port's actor listing adds two keys of its own.
PORT_ACTOR_KEYS = {"resources", "gpu_ids"}

# (kind, query): each kind of VALID_KINDS with the query the reference takes,
# and the caller errors it answers with a JSON 400 or 404.
REQUESTS = [
    ("actors", ""), ("alerts", ""), ("cluster", ""), ("events", "?limit=5"), ("jobs", ""),
    ("latency", ""), ("memory", ""), ("nodes", ""), ("objects", "?limit=3"),
    ("profile", "?duration=0.2"), ("serve", ""),
    ("series", "?name=ray_tpu_scheduler_tasks_dispatched_total"), ("stacks", ""),
    ("tasks", "?limit=2"), ("timeline", ""), ("traces", ""), ("train", ""),
    ("jobs", "?job=ffffffff"), ("serve", "?app=nope"), ("traces", "?trace_id=nope"),
    ("series", ""), ("series", "?name=x&labels=[1]"), ("tasks", "?limit=nope"),
    ("profile", "?duration=soon"), ("nope", ""),
]

PROBE = """\
import json, sys, time, urllib.error, urllib.request
import {pkg}
from {pkg}.dashboard import start_dashboard
from {pkg}.dashboard.head import DashboardServer

{pkg}.init(num_cpus=2)


@{pkg}.remote
def square(x):
    return x * x


@{pkg}.remote
class Counter:
    def add(self, k):
        return k


assert {pkg}.get([square.remote(i) for i in range(3)]) == [0, 1, 4]
c = Counter.remote()
assert {pkg}.get(c.add.remote(2)) == 2
ref = {pkg}.put(list(range(100)))
time.sleep(0.5)  # a telemetry tick: the scheduler's counters reach /metrics
server = start_dashboard(port=0)
base = f"http://127.0.0.1:{{server.port}}"


def get(path):
    try:
        with urllib.request.urlopen(base + path, timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type", ""), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read().decode()


out = {{"kinds": list(DashboardServer.VALID_KINDS), "api": []}}
for kind, query in {requests!r}:
    status, ctype, body = get(f"/api/{{kind}}{{query}}")
    out["api"].append([kind, query, status, ctype.split(";")[0], json.loads(body)])
status, ctype, text = get("/metrics")
out["metrics"] = [status, ctype.split(";")[0], "ray_tpu_scheduler_tasks_dispatched_total" in text]
status, ctype, html = get("/")
out["index"] = [status, ctype.split(";")[0], "{pkg} dashboard" in html,
                all(f'id="{{t}}-table"' in html for t in ("nodes", "actors", "tasks", "jobs"))]
out["missing"] = get("/api/")[0]
server.stop()
{pkg}.shutdown()
out["web_modules"] = sorted(m for m in ("aiohttp", "fastapi", "starlette") if m in sys.modules)
print("PROBE " + json.dumps(out, default=str))
"""


def _probe(pkg, tmp_path, block=False):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH" and
           not k.startswith("RAY_TPU_")}
    env["JAX_PLATFORMS"] = "cpu"
    path = [ROOT]
    if block:
        for name in BLOCKED:
            (tmp_path / name).mkdir()
            (tmp_path / name / "__init__.py").write_text(
                f"raise ImportError('{name} is blocked')\n")
        path.insert(0, str(tmp_path))
    env["PYTHONPATH"] = os.pathsep.join(path)
    proc = subprocess.run(
        [sys.executable, "-c", PROBE.format(pkg=pkg, requests=REQUESTS)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("PROBE ")]
    assert proc.returncode == 0 and lines, (pkg, proc.stdout[-3000:], proc.stderr[-3000:])
    return json.loads(lines[-1][len("PROBE "):])


def _shape(kind, payload):
    """What must agree between the packages: a dict's keys (a process-keyed
    dict's with the ids cut off), a list's element keys."""
    if isinstance(payload, dict):
        keys = {k.split(":")[0] for k in payload} if kind == "stacks" else set(payload)
        return "dict", sorted(keys)
    if isinstance(payload, list):
        keys = {k for e in payload if isinstance(e, dict) for k in e}
        if kind == "actors":
            keys |= PORT_ACTOR_KEYS
        return "list", sorted(keys)
    return type(payload).__name__, None


def test_dashboard_matches_jax_without_web_packages(tmp_path):
    jax = _probe("ray_tpu", tmp_path)
    port = _probe("ray_tpu_torch", tmp_path, block=True)
    assert port["kinds"] == jax["kinds"]
    assert {kind for kind, _ in REQUESTS} == set(jax["kinds"]) | {"nope"}
    for (kind, query, j_status, j_ctype, j_body), (_, _, t_status, t_ctype, t_body) in zip(
            jax["api"], port["api"]):
        where = f"/api/{kind}{query}"
        assert t_status == j_status, (where, t_status, j_status, t_body)
        assert t_ctype == j_ctype == "application/json", where
        if j_status == 200:
            assert _shape(kind, t_body) == _shape(kind, j_body), where
            if kind == "actors":
                assert {k for a in t_body for k in a} >= PORT_ACTOR_KEYS
        else:
            assert t_body == j_body, where
    statuses = {(k, q): s for k, q, s, _, _ in port["api"]}
    assert [s for (k, q), s in statuses.items() if s != 200] == [400] * 7 + [404]
    assert statuses[("nope", "")] == 404
    assert port["api"][-1][4]["valid"] == port["kinds"]
    assert port["metrics"] == jax["metrics"] == [200, "text/plain", True]
    assert port["index"] == jax["index"] == [200, "text/html", True, True]
    assert port["missing"] == jax["missing"] == 404
    assert port["web_modules"] == []
