"""The JAX package's own Tune and workflow suites, run against the port.

The files below are copied unedited into a temporary directory, with two
renames applied to their text: ``\\bray_tpu\\b`` -> ``ray_tpu_torch`` and
``RAY_TPU_`` -> ``RAY_TPU_TORCH_`` (the port's package and its environment
keys). They run in two pytest subprocesses at once, each serially and under
one time limit, with ``PYTHONPATH`` set to the copies and the repo (the
restore test starts a driver of its own), and their junit XML gives each
test's outcome. Each JAX test id is one parametrized case here, which passes
only if that test passed against the port. A test that cannot run against
the port is in ``EXCLUDED`` with its reason, and is deselected, not run.

The port's RLlib learners default to the GPU (``num_gpus_per_learner=1``, a
documented divergence in ROADMAP.md Queue 3), where the reference's run on
the host. The subprocesses load ``CPU_LEARNER_PLUGIN``, which makes 0 the
default in that process before any test runs, so the callback cases of
``test_callbacks.py`` build their PPO with learners on the CPU, as the
reference's do.
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
FILES = ["conftest.py", "test_tune.py", "test_tune_stoppers.py", "test_tuner_restore.py",
         "test_callbacks.py", "test_dag_workflow.py"]
TIMEOUT_S = 240

CPU_LEARNER_PLUGIN = '''"""Make the port's RLlib learners default to the CPU in this process."""
from ray_tpu_torch.rllib.algorithms import algorithm

_init = algorithm.AlgorithmConfig.__init__


def _init_on_the_cpu(self, *args, **kwargs):
    _init(self, *args, **kwargs)
    self.num_gpus_per_learner = 0.0


def pytest_configure(config):
    algorithm.AlgorithmConfig.__init__ = _init_on_the_cpu
'''

# Every test of the files above, by id (file::name). A test added to one of
# the files fails test_every_jax_test_is_run_or_excluded until it is listed.
TEST_IDS = [
    *(f"test_tune.py::{n}" for n in (
        "test_variant_generation", "test_tuner_grid", "test_tuner_stop_criterion",
        "test_asha_prunes_bad_trials", "test_pbt_exploits_and_mutates", "test_trainer_in_tuner",
        "test_tpe_searcher_beats_random_on_quadratic",
        "test_random_searcher_through_adaptive_seam", "test_searcher_rejects_grid_axes",
        "test_median_stopping_rule")),
    *(f"test_tune_stoppers.py::{n}" for n in (
        "test_stopper_unit_behaviors", "test_stopper_stops_trials_in_runner",
        "test_stop_all_ends_experiment", "test_with_parameters_ships_large_objects")),
    *(f"test_tuner_restore.py::{n}" for n in (
        "test_restore_after_driver_kill", "test_restore_errored_trials")),
    *(f"test_callbacks.py::{n}" for n in (
        "test_tune_callbacks_lifecycle", "test_tune_callback_on_trial_error",
        "test_rllib_callbacks_driver_hooks", "test_rllib_callbacks_runner_side_hooks",
        "test_rllib_callbacks_multi_agent_runner_hooks", "test_rllib_callbacks_validation")),
    *(f"test_dag_workflow.py::{n}" for n in (
        "test_function_dag_execute", "test_dag_diamond_shares_node", "test_actor_dag",
        "test_workflow_runs_and_persists", "test_workflow_resume_skips_completed_steps",
        "test_workflow_run_async_and_delete")),
]

EXCLUDED = {}
RUN = [t for t in TEST_IDS if t not in EXCLUDED]

# The cases run in two pytest subprocesses at once, split by file, so that
# each stays well inside TIMEOUT_S on a loaded machine; a shard that does not
# finish in time fails its own cases only.
SHARDS = (("test_tune.py", "test_tune_stoppers.py"),
          ("test_tuner_restore.py", "test_callbacks.py", "test_dag_workflow.py"))


def _copy_renamed(dst):
    os.makedirs(os.path.join(dst, "tests"))
    for name in FILES:
        with open(os.path.join(TESTS, name)) as f:
            text = f.read()
        text = re.sub(r"\bray_tpu\b", "ray_tpu_torch", text).replace("RAY_TPU_", "RAY_TPU_TORCH_")
        with open(os.path.join(dst, "tests", name), "w") as f:
            f.write(text)
    with open(os.path.join(dst, "cpu_learner_plugin.py"), "w") as f:
        f.write(CPU_LEARNER_PLUGIN)


def _outcomes(xml_path):
    out = {}
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        name = f"{case.get('classname').split('.')[-1]}.py::{case.get('name')}"
        bad = [c for c in case if c.tag in ("failure", "error", "skipped")]
        out[name] = ("passed", "") if not bad else (bad[0].tag, (bad[0].get("message") or "")[:2000])
    return out


def _sessions():
    return set(glob.glob("/dev/shm/ray_tpu_torch_session_*"))


def _remove_dead_sessions(before):
    """Remove the session directories that appeared during the run and whose
    driver is gone: ``test_tuner_restore.py`` SIGKILLs a driver, and the
    copy's cleanup names the JAX package's directory, not the port's."""
    for d in _sessions() - before:
        pid = int(os.path.basename(d).split("_")[4])
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    before = _sessions()
    dst = str(tmp_path_factory.mktemp("jax_suites_tune"))
    _copy_renamed(dst)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = os.pathsep.join([dst, ROOT])
    shards = []
    for i, files in enumerate(SHARDS):
        ids = [t for t in RUN if t.split("::")[0] in files]
        xml_path = os.path.join(dst, f"junit{i}.xml")
        cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist",
               "-p", "no:randomly", "-p", "cpu_learner_plugin", f"--junitxml={xml_path}",
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
    _remove_dead_sessions(before)
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


def test_cpu_learner_plugin_patches_the_learners_default():
    # The plugin's patch point must exist in the port and hold the GPU
    # default it replaces, or the callback cases would meet the GPU default.
    from ray_tpu_torch.rllib.algorithms.algorithm import AlgorithmConfig

    assert AlgorithmConfig().num_gpus_per_learner == 1.0


@pytest.mark.parametrize("test_id", RUN)
def test_jax_suite_passes_against_the_port(outcomes, test_id):
    results, log = outcomes
    outcome, message = results.get(test_id, ("not run", log[-2000:]))
    assert outcome == "passed", f"{test_id}: {outcome}\n{message}"
