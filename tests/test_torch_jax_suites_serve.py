"""The JAX package's own Serve suites, run against the port.

The files below are copied unedited into a temporary directory, with two
renames applied to their text: ``\\bray_tpu\\b`` -> ``ray_tpu_torch`` and
``RAY_TPU_`` -> ``RAY_TPU_TORCH_`` (the port's package and its environment
keys). They run in three pytest subprocesses, each serially and under one
time limit, and their junit XML gives each test's outcome. Each JAX test id is one
parametrized case here, which passes only if that test passed against the
port. A test that cannot run against the port is in ``EXCLUDED`` with its
reason, and is deselected, not run.

The suites default to Serve's fixed HTTP port 8000. The subprocess loads
``PORT_PLUGIN``, which makes the port's default HTTP port ephemeral (0) in
that process before any test runs, so no case binds 8000: the copies read
the bound port back through ``serve.http_port()``.
"""

import os
import re
import shutil
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
FILES = ["conftest.py", "test_serve.py", "test_serve_advanced.py", "test_serve_batching.py",
         "test_serve_ingress.py", "test_serve_multiplex.py", "test_serve_pernode.py"]
TIMEOUT_S = 140

PORT_PLUGIN = '''"""Make the port's default Serve HTTP port ephemeral in this process."""
from ray_tpu_torch.serve import api
from ray_tpu_torch.serve._private import common


def pytest_configure(config):
    common.DEFAULT_HTTP_PORT = 0
    api.DEFAULT_HTTP_PORT = 0  # serve.start reads it at call time
    api.run.__kwdefaults__["port"] = 0
    api._get_proxy.__defaults__ = (True, 0)
'''

# Every test of the files above, by id (file::name). A test added to one of
# the files fails test_every_jax_test_is_run_or_excluded until it is listed.
TEST_IDS = [
    *(f"test_serve.py::{n}" for n in (
        "test_deploy_and_handle", "test_function_deployment_and_replicas",
        "test_composition_graph", "test_http_ingress", "test_redeploy_new_version",
        "test_replica_failure_recovery", "test_autoscaling_scales_up",
        "test_long_poll_pushes_replica_changes", "test_dead_replica_push_updates_other_routers")),
    *(f"test_serve_advanced.py::{n}" for n in (
        "test_asgi_ingress", "test_streaming_http_response", "test_streaming_python_handle",
        "test_two_deployment_graph_with_streamed_response", "test_dag_driver",
        "test_dag_driver_multi_route", "test_streaming_http_incremental_arrival",
        "test_route_live_immediately_after_run")),
    *(f"test_serve_batching.py::{n}" for n in (
        "test_batch_coalesces_concurrent_calls", "test_batch_flushes_on_timeout",
        "test_batch_error_propagates_to_all_waiters", "test_batch_wrong_length_return_raises",
        "test_batch_instances_do_not_share_queues", "test_batch_requires_async_and_valid_options",
        "test_batch_free_function_form", "test_batch_queue_rebinds_across_event_loops",
        "test_batch_queue_recovers_from_cancelled_first_loop", "test_serve_batch_over_http",
        "test_sync_deployment_parallel_under_concurrency", "test_serve_batch_in_replica")),
    *(f"test_serve_ingress.py::{n}" for n in (
        "test_batch_queue_cap_sheds_immediately", "test_batch_shed_timeout_vs_flush_race",
        "test_batch_shed_reason_survives_the_wire", "test_listener_slots_stable_across_50_redeploys",
        "test_proxy_sheds_over_app_cap_and_recovers", "test_router_inflight_cap_sheds",
        "test_replica_drain_zero_dropped_requests", "test_slo_autoscaling_scales_on_p95",
        "test_dashboard_api_serve", "test_proxy_failover_under_load",
        "test_proxy_wire_drain_and_directory")),
    *(f"test_serve_multiplex.py::{n}" for n in (
        "test_multiplexed_lru_and_single_flight", "test_multiplexed_unload_hook_and_errors",
        "test_multiplexed_requires_async_and_model_id",
        "test_multiplexed_deployment_handle_and_context", "test_multiplexed_over_http_header",
        "test_multiplexed_streaming_generator", "test_model_affinity_routing",
        "test_model_affinity_load_escape")),
    "test_serve_pernode.py::test_per_node_proxies",
    "test_serve_pernode.py::test_proxy_crash_recovers",
]

_CLUSTER_UTILS = ("imports ray_tpu_torch.cluster_utils (virtual multi-node clusters), "
                  "not ported yet: ROADMAP.md Queue 1 items 2 and 8")
EXCLUDED = {
    "test_serve_ingress.py::test_dashboard_api_serve": (
        "imports ray_tpu_torch.dashboard.head, not ported yet: ROADMAP.md Queue 1 item 2"),
    "test_serve_ingress.py::test_proxy_failover_under_load": _CLUSTER_UTILS,
    "test_serve_ingress.py::test_proxy_wire_drain_and_directory": _CLUSTER_UTILS,
    "test_serve_pernode.py::test_per_node_proxies": _CLUSTER_UTILS,
    "test_serve_pernode.py::test_proxy_crash_recovers": (
        _CLUSTER_UTILS + "; and it needs a fixed port to survive a proxy restart (a port-0 "
        "proxy has no restart by design), which would bind 8000 here"),
}
RUN = [t for t in TEST_IDS if t not in EXCLUDED]


def _copy_renamed(dst):
    os.makedirs(os.path.join(dst, "tests"))
    for name in FILES:
        with open(os.path.join(TESTS, name)) as f:
            text = f.read()
        text = re.sub(r"\bray_tpu\b", "ray_tpu_torch", text).replace("RAY_TPU_", "RAY_TPU_TORCH_")
        with open(os.path.join(dst, "tests", name), "w") as f:
            f.write(text)
    with open(os.path.join(dst, "serve_port_plugin.py"), "w") as f:
        f.write(PORT_PLUGIN)


def _outcomes(xml_path):
    out = {}
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        name = f"{case.get('classname').split('.')[-1]}.py::{case.get('name')}"
        bad = [c for c in case if c.tag in ("failure", "error", "skipped")]
        out[name] = ("passed", "") if not bad else (bad[0].tag, (bad[0].get("message") or "")[:2000])
    return out


# The cases run in three pytest subprocesses at once, split by file, so that
# each stays well inside TIMEOUT_S on a loaded machine; a shard that does not
# finish in time fails its own cases only.
SHARDS = (("test_serve.py", "test_serve_multiplex.py"),
          ("test_serve_advanced.py", "test_serve_batching.py"),
          ("test_serve_ingress.py", "test_serve_pernode.py"))


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("jax_suites_serve"))
    _copy_renamed(dst)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = os.pathsep.join([dst, ROOT])
    shards = []
    for i, files in enumerate(SHARDS):
        ids = [t for t in RUN if t.split("::")[0] in files]
        xml_path = os.path.join(dst, f"junit{i}.xml")
        cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist",
               "-p", "no:randomly", "-p", "serve_port_plugin", f"--junitxml={xml_path}",
               *(f"tests/{t}" for t in ids)]
        shards.append((ids, xml_path, subprocess.Popen(
            cmd, cwd=dst, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    results, logs = {}, ""
    deadline = time.monotonic() + TIMEOUT_S
    for ids, xml_path, proc in shards:
        try:
            out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            why = f"its shard took over {TIMEOUT_S} s against the port:\n{out[-2000:]}"
            results.update({t: ("timeout", why) for t in ids})
            continue
        if os.path.exists(xml_path):
            results.update(_outcomes(xml_path))
        else:
            results.update({t: ("no junit XML", f"rc {proc.returncode}:\n{out[-2000:]}")
                            for t in ids})
        logs += out
    yield results, logs
    shutil.rmtree(dst, ignore_errors=True)


def test_every_jax_test_is_run_or_excluded():
    import ast

    found = []
    for name in FILES[1:]:
        with open(os.path.join(TESTS, name)) as f:
            tree = ast.parse(f.read())
        found += [f"{name}::{n.name}" for n in tree.body
                  if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]
    assert sorted(found) == sorted(TEST_IDS)
    assert set(EXCLUDED) <= set(TEST_IDS) and all(EXCLUDED.values())


def test_port_plugin_makes_the_default_port_ephemeral():
    # The plugin's patch points must exist in the port, or the copies would
    # bind 8000 (DEFAULT_HTTP_PORT) in a run that has other Serve suites.
    from ray_tpu_torch.serve import api
    from ray_tpu_torch.serve._private import common

    assert common.DEFAULT_HTTP_PORT == api.DEFAULT_HTTP_PORT == 8000
    assert api.run.__kwdefaults__["port"] == 8000
    assert api._get_proxy.__defaults__ == (True, 8000)


@pytest.mark.parametrize("test_id", RUN)
def test_jax_suite_passes_against_the_port(outcomes, test_id):
    results, log = outcomes
    outcome, message = results.get(test_id, ("not run", log[-2000:]))
    assert outcome == "passed", f"{test_id}: {outcome}\n{message}"
