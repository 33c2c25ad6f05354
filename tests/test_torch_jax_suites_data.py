"""The JAX package's own Data suites, run against the port.

The files below are copied unedited into a temporary directory, with two
renames applied to their text: ``\\bray_tpu\\b`` -> ``ray_tpu_torch`` and
``RAY_TPU_`` -> ``RAY_TPU_TORCH_`` (the port's package and its environment
keys). They run in one pytest subprocess, serially and under its own time
limit, and its junit XML gives each test's outcome. Each JAX test id is one
parametrized case here, which passes only if that test passed against the
port. A test that cannot run against the port is in ``EXCLUDED`` with its
reason (the item of the module it waits for, the JAX-only API it calls, or
the documented divergence it meets), and is deselected, not run.
"""

import os
import re
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
FILES = ["conftest.py", "test_data.py", "test_data_arrow.py", "test_data_streaming.py",
         "test_datasource.py", "test_batch_predictor.py", "test_rllib_offline.py"]
# Only the Dataset cases of the offline RLlib file belong to Data.
ONLY = {"test_rllib_offline.py": {"test_dataset_reader_cycles", "test_bc_learns_from_ray_data_dataset"}}
TIMEOUT_S = 300

# Every test of the files above, by id (file::name). A test added to one of
# the files fails test_every_jax_test_is_run_or_excluded until it is listed.
TEST_IDS = [
    *(f"test_data.py::{n}" for n in (
        "test_range_count_take", "test_from_items_and_map", "test_map_batches_fusion_and_formats",
        "test_flat_map_and_columns", "test_repartition_and_limit", "test_random_shuffle",
        "test_sort", "test_groupby", "test_union_zip_aggregates", "test_iter_batches_stream",
        "test_split_equal_feeds_train_ingest", "test_file_roundtrips",
        "test_trainer_dataset_split_integration", "test_map_batches_actor_pool",
        "test_map_batches_actors_after_fused_ops", "test_write_read_roundtrip_all_formats",
        "test_from_arrow_to_arrow", "test_random_split_fractions", "test_iter_torch_batches")),
    *(f"test_data_arrow.py::{n}" for n in (
        "test_arrow_block_accessor_zero_conversion", "test_arrow_blocks_flow_through_map_batches",
        "test_parquet_reads_are_arrow_native", "test_string_heavy_groupby_stays_arrow",
        "test_arrow_sort_and_zip", "test_optimizer_applies_fusion_and_reorder",
        "test_optimizer_actor_segments_and_tail_fusion",
        "test_randomize_block_order_end_to_end")),
    *(f"test_data_streaming.py::{n}" for n in (
        "test_blocks_in_flight_bounded", "test_memory_budget_respected",
        "test_production_overlaps_consumption", "test_actor_pool_streams_without_materialize",
        "test_map_error_propagates", "test_early_abandon_stops_pipeline",
        "test_read_csv_streams", "test_streaming_through_global_op_barrier",
        "test_streaming_split_on_demand_and_equal",
        "test_streaming_split_trainer_ingest_pipelined")),
    *(f"test_datasource.py::{n}" for n in (
        "test_read_numpy", "test_read_binary_files", "test_tfrecords_roundtrip",
        "test_tfrecords_list_features", "test_custom_datasource_plugin",
        "test_runtime_env_plugin_seam", "test_conda_runtime_env_gated",
        "test_container_runtime_env_gated", "test_builtin_keys_not_overridable")),
    *(f"test_batch_predictor.py::{n}" for n in (
        "test_jax_predictor_direct", "test_jax_predictor_missing_params_key",
        "test_batch_predictor_over_dataset", "test_batch_predictor_keep_column_collision",
        "test_batch_predictor_with_gbdt")),
    "test_rllib_offline.py::test_dataset_reader_cycles",
    "test_rllib_offline.py::test_bc_learns_from_ray_data_dataset",
]

_JAX_PREDICTOR = ("calls JaxPredictor, the JAX-only predictor (the port's is TorchPredictor: "
                  "tests/test_torch_predictor.py holds them against each other)")
EXCLUDED = {
    "test_data.py::test_iter_torch_batches": (
        "documented divergence: iter_torch_batches() with no device gives GPU tensors "
        "in the port (raising without a GPU), CPU tensors in the reference "
        "(ROADMAP.md Queue 3); tests/test_torch_data.py holds device='cpu'"),
    "test_batch_predictor.py::test_jax_predictor_direct": _JAX_PREDICTOR,
    "test_batch_predictor.py::test_jax_predictor_missing_params_key": _JAX_PREDICTOR,
    "test_batch_predictor.py::test_batch_predictor_over_dataset": _JAX_PREDICTOR,
    "test_batch_predictor.py::test_batch_predictor_keep_column_collision": _JAX_PREDICTOR,
    "test_rllib_offline.py::test_bc_learns_from_ray_data_dataset": (
        "documented divergence: the port's learners default to the GPU "
        "(AlgorithmConfig.learners num_gpus_per_learner=1, raising without one; "
        "ROADMAP.md Queue 3); tests/test_torch_rllib_offline.py runs this case with "
        "num_gpus_per_learner=0"),
    "test_batch_predictor.py::test_batch_predictor_with_gbdt": (
        "waits for the GBDT trainers and XGBoostPredictor: ROADMAP.md Queue 1 item 13"),
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


def _outcomes(xml_path):
    out = {}
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        name = f"{case.get('classname').split('.')[-1]}.py::{case.get('name')}"
        bad = [c for c in case if c.tag in ("failure", "error", "skipped")]
        out[name] = ("passed", "") if not bad else (bad[0].tag, (bad[0].get("message") or "")[:2000])
    return out


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("jax_suites_data"))
    _copy_renamed(dst)
    xml_path = os.path.join(dst, "junit.xml")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = ROOT
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist",
           "-p", "no:randomly", f"--junitxml={xml_path}", *(f"tests/{t}" for t in RUN)]
    try:
        proc = subprocess.run(cmd, cwd=dst, env=env, capture_output=True, text=True,
                              timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"the JAX Data suites took over {TIMEOUT_S} s against the port:\n"
                    f"{(e.stdout or b'')[-4000:]!r}")
    if not os.path.exists(xml_path):
        pytest.fail(f"no junit XML (rc {proc.returncode}):\n{proc.stdout[-4000:]}\n"
                    f"{proc.stderr[-4000:]}")
    yield _outcomes(xml_path), proc.stdout
    shutil.rmtree(dst, ignore_errors=True)


def test_every_jax_test_is_run_or_excluded():
    import ast

    found = []
    for name in FILES[1:]:
        with open(os.path.join(TESTS, name)) as f:
            tree = ast.parse(f.read())
        found += [f"{name}::{n.name}" for n in tree.body
                  if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")
                  and n.name in ONLY.get(name, {n.name})]
    assert sorted(found) == sorted(TEST_IDS)
    assert set(EXCLUDED) <= set(TEST_IDS) and all(EXCLUDED.values())


@pytest.mark.parametrize("test_id", RUN)
def test_jax_suite_passes_against_the_port(outcomes, test_id):
    results, log = outcomes
    outcome, message = results.get(test_id, ("not run", log[-2000:]))
    assert outcome == "passed", f"{test_id}: {outcome}\n{message}"
