"""The JAX package's own cluster suites, run against the port.

The files below (the autoscaler, chaos, placement groups and the util host
libraries: Queue, ActorPool, multiprocessing.Pool, joblib) are copied
unedited into a temporary directory, with these renames applied to their
text:

- ``\\bray_tpu\\b`` -> ``ray_tpu_torch`` and ``RAY_TPU_`` ->
  ``RAY_TPU_TORCH_``: the port's package and its environment keys;
- ``num_tpus`` -> ``num_gpus`` in both its spellings: the port's nodes and
  tasks count GPUs;
- ``tpu_slice_placement_group`` -> ``gpu_slice_placement_group`` and
  ``chips_per_host`` -> ``gpus_per_host``: the port's gang of one bundle a
  host, which takes its hosts from one NVLink domain where the JAX package's
  takes a sub-box of a TPU slice;
- ``TpuQueuedResourcesProvider`` -> ``GcpGpuInstancesProvider``: the port's
  cloud provider, which the autoscaler file imports at its top; the one test
  that drives it is excluded below.

They run in two pytest subprocesses, one after the other, each serially and
under one time limit (the real-node cases start processes of their own, so
the shards do not run at once beside the rest of the tier-1 run), with ``PYTHONPATH`` set to the copies and the repo (the real-node cases
start a head and node daemons), and their junit XML gives each test's
outcome. Each JAX test id (with its parameters) is one parametrized case
here, which passes only if that test passed against the port. A test that
cannot run against the port is in ``EXCLUDED`` with its reason, and is
deselected, not run.

``tests/test_tpu_topology.py`` is not copied: it holds the ICI torus's
geometry (host grids, contiguous sub-boxes, wraparound), which the GPU policy
does not have; ``tests/test_torch_placement.py`` carries its end-to-end
scenarios on NVLink domain labels.
"""

import glob
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
# Two shards of about equal time (about 20 s each here), together well inside
# TIMEOUT_S on a loaded machine; a shard that does not finish in time fails
# its own cases only, and the next shard gets what time is left.
SHARDS = (("test_autoscaler.py", "test_chaos.py"),
          ("test_placement_group.py", "test_util_ecosystem.py"))
FILES = ["conftest.py", *(f for shard in SHARDS for f in shard)]
TIMEOUT_S = 200

RENAMES = (
    (r"\bray_tpu\b", "ray_tpu_torch"),
    (r"RAY_TPU_", "RAY_TPU_TORCH_"),
    (r"\bnum_tpus\b", "num_gpus"),
    (r"--num-tpus", "--num-gpus"),
    (r"\btpu_slice_placement_group\b", "gpu_slice_placement_group"),
    (r"\bchips_per_host\b", "gpus_per_host"),
    (r"\bTpuQueuedResourcesProvider\b", "GcpGpuInstancesProvider"),
)

# Every test of the files above, by id (file::name[parameters]). A test added
# to one of the files fails test_every_jax_test_is_run_or_excluded until it is
# listed.
TEST_IDS = [
    *(f"test_autoscaler.py::{n}" for n in (
        "test_scale_up_for_unmet_demand", "test_demand_fitting_consumes_capacity",
        "test_max_workers_cap_and_tpu_demand", "test_min_workers_floor",
        "test_idle_scale_down_respects_activity_and_min", "test_pg_bundles_create_demand",
        "test_tpu_queued_resources_commands", "test_end_to_end_fake_provider",
        "test_request_resources_prewarms")),
    *(f"test_chaos.py::{n}" for n in (
        "test_tasks_survive_node_churn[False]", "test_tasks_survive_node_churn[True]",
        "test_actor_restart_survives_node_kill")),
    *(f"test_placement_group.py::{n}" for n in (
        "test_pack_pg_basic", "test_strict_spread_needs_enough_nodes",
        "test_strict_pack_infeasible", "test_pg_bundle_index_and_capacity", "test_actor_in_pg",
        "test_remove_pg_releases_resources", "test_tpu_slice_pg_on_fake_hosts",
        "test_invalid_bundles_rejected")),
    *(f"test_util_ecosystem.py::{n}" for n in (
        "test_queue_basic", "test_queue_maxsize_and_batches", "test_queue_across_tasks",
        "test_queue_blocking_get_unblocks_on_put", "test_actor_pool_map_ordered",
        "test_actor_pool_map_unordered", "test_actor_pool_submit_get_next",
        "test_actor_pool_ordered_despite_straggler", "test_actor_pool_push_pop",
        "test_actor_pool_get_next_timeout", "test_mp_pool_map_apply", "test_mp_pool_imap",
        "test_mp_pool_initializer_and_errors", "test_joblib_backend")),
]

EXCLUDED = {
    "test_autoscaler.py::test_tpu_queued_resources_commands": (
        "builds `gcloud compute tpus queued-resources` commands for a TPU pod slice; the "
        "port's cloud provider makes GPU VMs with `gcloud compute instances`, and "
        "tests/test_torch_autoscaler.py::test_gcp_gpu_provider_commands tests its "
        "commands instead"),
}
RUN = [t for t in TEST_IDS if t not in EXCLUDED]


def _rename(text):
    for pattern, repl in RENAMES:
        text = re.sub(pattern, repl, text)
    return text


def _copy_renamed(dst):
    os.makedirs(os.path.join(dst, "tests"))
    for name in FILES:
        with open(os.path.join(TESTS, name)) as f:
            text = f.read()
        with open(os.path.join(dst, "tests", name), "w") as f:
            f.write(_rename(text))


def _outcomes(xml_path):
    out = {}
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        name = f"{case.get('classname').split('.')[-1]}.py::{case.get('name')}"
        bad = [c for c in case if c.tag in ("failure", "error", "skipped")]
        out[name] = ("passed", "") if not bad else (bad[0].tag, (bad[0].get("message") or "")[:2000])
    return out


# Session and head directories of the port in /dev/shm, each named
# ray_tpu_torch_<kind>_<pid>_...
_SHM = ("/dev/shm/ray_tpu_torch_session_*", "/dev/shm/ray_tpu_torch_head_*")


def _shm_dirs():
    return {d for pattern in _SHM for d in glob.glob(pattern)}


def _remove_dead_dirs(before):
    """Remove the session and head directories that appeared during the run
    and whose process is gone (a killed head leaves its directory)."""
    for d in _shm_dirs() - before:
        try:
            os.kill(int(os.path.basename(d).split("_")[4]), 0)
        except ProcessLookupError:
            shutil.rmtree(d, ignore_errors=True)
        except (ValueError, IndexError, PermissionError):
            pass


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    before = _shm_dirs()
    dst = str(tmp_path_factory.mktemp("jax_suites_cluster"))
    _copy_renamed(dst)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = os.pathsep.join([dst, ROOT])
    results, logs = {}, ""
    deadline = time.monotonic() + TIMEOUT_S
    for i, files in enumerate(SHARDS):
        ids = [t for t in RUN if t.split("::")[0] in files]
        xml_path = os.path.join(dst, f"junit{i}.xml")
        cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist",
               "-p", "no:randomly", f"--junitxml={xml_path}", *(f"tests/{t}" for t in ids)]
        proc = subprocess.Popen(cmd, cwd=dst, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            why = f"the shards ran past their {TIMEOUT_S} s against the port:\n{out[-2000:]}"
            results.update({t: ("timeout", why) for t in ids})
            continue
        if os.path.exists(xml_path):
            results.update(_outcomes(xml_path))
        else:
            results.update({t: ("no junit XML", f"rc {proc.returncode}:\n{out[-2000:]}")
                            for t in ids})
        logs += out
    _remove_dead_dirs(before)
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
    assert sorted(found) == sorted({t.split("[")[0] for t in TEST_IDS})
    assert len(set(TEST_IDS)) == len(TEST_IDS)
    assert set(EXCLUDED) <= set(TEST_IDS) and all(EXCLUDED.values())


def test_renames_leave_no_tpu_name_outside_the_exclusions():
    # After the renames no copy names the JAX package, its keys, a TPU
    # argument or the TPU gang, except in the excluded test's body. (The
    # autoscaler's pure-logic cases keep "TPU" as a resource name: its
    # decisions do not depend on which names a node type holds.)
    for name in FILES:
        with open(os.path.join(TESTS, name)) as f:
            text = _rename(f.read())
        text = re.sub(r"def test_tpu_queued_resources_commands\(.*?\n\n\n", "", text, flags=re.S)
        assert not re.search(r"num[_-]tpus|chips_per_host|tpu_slice_placement_group|"
                             r"\bray_tpu\b|RAY_TPU_(?!TORCH_)|TpuQueued", text), name


@pytest.mark.parametrize("test_id", RUN)
def test_jax_suite_passes_against_the_port(outcomes, test_id):
    results, log = outcomes
    outcome, message = results.get(test_id, ("not run", log[-2000:]))
    assert outcome == "passed", f"{test_id}: {outcome}\n{message}"
