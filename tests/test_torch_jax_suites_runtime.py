"""The JAX package's own runtime suites, run against the port.

The files below are copied unedited into a temporary directory, with three
renames applied to their text: ``\\bray_tpu\\b`` -> ``ray_tpu_torch`` and
``RAY_TPU_`` -> ``RAY_TPU_TORCH_`` (the port's package and its environment
keys), and ``num_tpus`` -> ``num_gpus`` in both its spellings
(``\\bnum_tpus\\b`` -> ``num_gpus``, ``--num-tpus`` -> ``--num-gpus``): the
port's heads, clusters and CLI count GPUs and take no ``num_tpus``, and every
site of these files passes 0, so none of them needs a TPU. They run in four
pytest subprocesses at once, each serially and under one time limit, with
``PYTHONPATH`` set to the copies and the repo (several cases start drivers and
heads of their own), and their junit XML gives each test's outcome. Each JAX
test id (with its parameters) is one parametrized case here, which passes only
if that test passed against the port. A test that cannot run against the port
is in ``EXCLUDED`` with its reason, and is deselected, not run.

Two of the files start Serve, whose default HTTP port is the fixed 8000
that the JAX package's own Serve suites bind in the same run. The
subprocesses load the Serve harness's ``PORT_PLUGIN``, which makes the
port's default ephemeral (0): the copies read the bound port back from the
head's service directory.
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
from test_torch_jax_suites_serve import PORT_PLUGIN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
# The cases run in four pytest subprocesses at once, split by file into
# shards of about equal time (about 100 s each serial here), so that each
# stays well inside TIMEOUT_S on a loaded machine; a shard that does not
# finish in time fails its own cases only.
SHARDS = (
    ("test_jobs.py", "test_generators.py", "test_multinode.py", "test_memory_monitor.py"),
    ("test_basic.py", "test_introspection.py", "test_locality.py", "test_pipelining.py",
     "test_tracing.py"),
    ("test_obs_pipeline.py", "test_object_lifecycle.py", "test_actors.py",
     "test_trace_pipeline.py", "test_runtime_env.py", "test_control_plane_batching.py"),
    ("test_failures.py", "test_head_restart_recovery.py", "test_object_transfer.py",
     "test_native_arena.py", "test_telemetry.py", "test_detached_actors.py",
     "test_state_jobs_cli.py", "test_ownership.py", "test_log_streaming.py",
     "test_metrics_dashboard.py"),
)
FILES = ["conftest.py", *(f for shard in SHARDS for f in shard)]
TIMEOUT_S = 300

# Every test of the files above, by id (file::name[parameters]). A test added
# to one of the files fails test_every_jax_test_is_run_or_excluded until it is
# listed.
TEST_IDS = [
    *(f"test_jobs.py::{n}" for n in (
        "test_two_client_drivers_attribution_reconciles",
        "test_job_starved_alert_fires_and_resolves_live",
        "test_killed_driver_pending_tasks_sealed_into_ledger",
        "test_enable_obs_off_means_no_ledger", "test_enable_metrics_off_means_no_ledger",
        "test_inproc_job_surfaces_and_filters",
        "test_finished_jobs_ring_cap_and_snapshot_roundtrip",
        "test_finished_jobs_survive_head_restart")),
    *(f"test_state_jobs_cli.py::{n}" for n in (
        "test_list_tasks_objects_nodes", "test_timeline_chrome_trace",
        "test_job_submission_end_to_end", "test_job_failure_status",
        "test_job_uses_cluster_as_client_driver", "test_cli_start_status_list_stop")),
    *(f"test_introspection.py::{n}" for n in (
        "test_stack_dump_busy_spin_annotated", "test_stack_dump_oob_when_reader_wedged",
        "test_profile_merges_folded_stacks_across_workers", "test_profiler_knob_off_parity",
        "test_memory_summary_accounting_and_dead_holder_suspect",
        "test_memory_summary_flags_bytes_orphaned_by_owner_crash",
        "test_flight_recorder_captured_on_worker_suspect",
        "test_log_shipper_drop_counter_exported")),
    *(f"test_head_restart_recovery.py::{n}" for n in (
        "test_head_restart_mid_job_and_named_actor",
        "test_restored_owned_actor_is_killable_and_record_dropped",
        "test_daemon_rejoins_restarted_head")),
    *(f"test_metrics_dashboard.py::{n}" for n in (
        "test_metrics_counter_gauge_histogram", "test_metrics_merge_across_workers",
        "test_dashboard_rest_and_metrics", "test_gcs_persistence_across_head_restart")),
    *(f"test_telemetry.py::{n}" for n in (
        "test_task_events_carry_all_stages",
        "test_list_tasks_stage_durations_and_summarize_percentiles", "test_actor_call_stages",
        "test_unified_timeline_stages_and_span_links",
        "test_timeline_includes_collective_intervals", "test_internal_metrics_exported",
        "test_batching_metrics_and_coalesce_ratio",
        "test_prometheus_histogram_bucket_union_mismatched_boundaries", "test_knob_off_parity",
        "test_task_event_ring_buffer_cap")),
    *(f"test_detached_actors.py::{n}" for n in (
        "test_invalid_lifetime_rejected", "test_detached_survives_driver_owned_dies",
        "test_head_restart_restores_detached_actor")),
    *(f"test_obs_pipeline.py::{n}" for n in (
        "test_counter_rate_exact_under_known_traffic", "test_histogram_p95_over_time_exact",
        "test_gauge_carry_forward_and_aggregation", "test_retention_ring_and_label_cap_eviction",
        "test_alert_lifecycle_hysteresis_fake_clock",
        "test_default_pack_thresholds_resolve_from_config", "test_live_counter_rate_and_exec_p95",
        "test_dead_worker_prunes_kv_and_series_and_emits_event",
        "test_serve_shed_alert_fires_and_resolves_live",
        "test_suspect_node_alert_on_sigstopped_daemon",
        "test_departed_client_driver_prunes_kv_snapshots", "test_event_log_survives_head_restart",
        "test_enable_metrics_off_parity",
        "test_enable_obs_subknob_off_keeps_metrics_but_no_history",
        "test_dashboard_series_events_alerts_endpoints", "test_top_renderer_and_events_cli_shapes")),
    *(f"test_trace_pipeline.py::{n}" for n in (
        "test_serve_request_one_connected_trace_and_latency_report",
        "test_transfer_span_attaches_to_owning_context", "test_failed_pull_records_error_span",
        "test_seeded_sampling_determinism", "test_one_sampling_draw_per_root_across_paths",
        "test_router_span_flushed_on_route_failure",
        "test_unsampled_root_propagates_nothing_but_children_record",
        "test_tail_keep_preserves_slow_unsampled_spans",
        "test_buffer_bounded_when_enabled_before_init",
        "test_knob_off_parity_zero_spans_zero_traffic", "test_critical_path_attribution_synthetic",
        "test_trace_summary_and_grouping", "test_exemplar_pipeline_store_and_alert_link",
        "test_dashboard_traces_and_latency_endpoints", "test_flush_is_append_proportional")),
    *(f"test_basic.py::{n}" for n in (
        "test_put_get_roundtrip[inproc]", "test_put_get_roundtrip[head_process]",
        "test_put_get_large_numpy_zero_copy[inproc]",
        "test_put_get_large_numpy_zero_copy[head_process]", "test_simple_task[inproc]",
        "test_simple_task[head_process]", "test_task_with_kwargs_and_defaults[inproc]",
        "test_task_with_kwargs_and_defaults[head_process]", "test_task_dependencies[inproc]",
        "test_task_dependencies[head_process]", "test_task_large_args[inproc]",
        "test_task_large_args[head_process]", "test_num_returns[inproc]",
        "test_num_returns[head_process]", "test_nested_object_refs[inproc]",
        "test_nested_object_refs[head_process]", "test_nested_task_submission[inproc]",
        "test_nested_task_submission[head_process]", "test_error_propagation[inproc]",
        "test_error_propagation[head_process]", "test_dependency_error_propagates[inproc]",
        "test_dependency_error_propagates[head_process]", "test_wait[inproc]",
        "test_wait[head_process]", "test_wait_timeout_returns_partial[inproc]",
        "test_wait_timeout_returns_partial[head_process]", "test_get_timeout[inproc]",
        "test_get_timeout[head_process]", "test_options_name_and_resources[inproc]",
        "test_options_name_and_resources[head_process]", "test_infeasible_resources_pend[inproc]",
        "test_infeasible_resources_pend[head_process]",
        "test_cluster_and_available_resources[inproc]",
        "test_cluster_and_available_resources[head_process]",
        "test_auto_get_deduplication[inproc]", "test_auto_get_deduplication[head_process]",
        "test_put_objectref_rejected[inproc]", "test_put_objectref_rejected[head_process]",
        "test_remote_function_direct_call_rejected[inproc]",
        "test_remote_function_direct_call_rejected[head_process]",
        "test_config_env_override_tri_state")),
    *(f"test_actors.py::{n}" for n in (
        "test_actor_basic", "test_actor_method_ordering", "test_actor_method_error",
        "test_actor_constructor_error", "test_actor_death_fails_calls", "test_actor_restart",
        "test_named_actor", "test_named_actor_missing", "test_named_actor_duplicate_rejected",
        "test_get_if_exists", "test_kill_actor", "test_actor_handle_in_task",
        "test_actor_ready_protocol", "test_actor_task_from_actor",
        "test_threaded_actor_concurrency", "test_crashed_named_actor_frees_its_name",
        "test_concurrency_groups")),
    *(f"test_generators.py::{n}" for n in (
        "test_dynamic_num_returns[inproc]", "test_dynamic_num_returns[head_process]",
        "test_dynamic_zero_items[inproc]", "test_dynamic_zero_items[head_process]",
        "test_dynamic_error_fails_outer_ref[inproc]",
        "test_dynamic_error_fails_outer_ref[head_process]",
        "test_dynamic_generator_passed_to_task[inproc]",
        "test_dynamic_generator_passed_to_task[head_process]", "test_streaming_basic[inproc]",
        "test_streaming_basic[head_process]",
        "test_streaming_items_arrive_before_task_finishes[inproc]",
        "test_streaming_items_arrive_before_task_finishes[head_process]",
        "test_streaming_error_surfaces_at_failing_index[inproc]",
        "test_streaming_error_surfaces_at_failing_index[head_process]",
        "test_streaming_immediate_error[inproc]", "test_streaming_immediate_error[head_process]",
        "test_streaming_non_generator_return_errors[inproc]",
        "test_streaming_non_generator_return_errors[head_process]",
        "test_streaming_not_picklable[inproc]", "test_streaming_not_picklable[head_process]",
        "test_streaming_actor_method[inproc]", "test_streaming_actor_method[head_process]",
        "test_streaming_async_actor_generator[inproc]",
        "test_streaming_async_actor_generator[head_process]",
        "test_streaming_large_arrays_zero_copy[inproc]",
        "test_streaming_large_arrays_zero_copy[head_process]",
        "test_streaming_release_frees_unconsumed", "test_streaming_worker_consumes_stream[inproc]",
        "test_streaming_worker_consumes_stream[head_process]")),
    *(f"test_ownership.py::{n}" for n in (
        "test_owned_get_resolves_without_head_roundtrip",
        "test_owner_table_entry_forgotten_on_release", "test_borrowed_refs_fall_back_to_head",
        "test_owner_died_pending_task_raises_not_hangs",
        "test_reconstruction_only_while_owner_survives",
        "test_worker_crash_mid_submit_owner_died_fallout", "test_owner_crash_replay_determinism",
        "test_ownership_table_stats_surface")),
    *(f"test_object_lifecycle.py::{n}" for n in (
        "test_dropping_ref_frees_segment", "test_task_dependency_pins_object",
        "test_contained_ref_pinned_by_container", "test_worker_borrowed_ref_outlives_driver_ref",
        "test_put_loop_stays_under_capacity", "test_put_raises_when_full_and_recovers",
        "test_spilling_over_capacity_with_live_refs[files]",
        "test_spilling_over_capacity_with_live_refs[arena]",
        "test_reconstruction_after_segment_loss", "test_put_objects_are_not_reconstructable",
        "test_actor_restart_keeps_creation_args_alive", "test_lineage_gc_bounds_task_table",
        "test_lineage_gc_after_actor_death")),
    *(f"test_pipelining.py::{n}" for n in (
        "test_burst_larger_than_pool_completes", "test_pipelined_queue_preserves_fifo_per_worker",
        "test_cancel_task_queued_on_leased_worker", "test_nested_submission_no_deadlock",
        "test_worker_death_retries_whole_pipeline_window", "test_task_ids_unique_under_burst",
        "test_deeply_nested_submission_no_deadlock")),
    *(f"test_control_plane_batching.py::{n}" for n in (
        "test_fifo_interleaved_puts_and_submits[batched]",
        "test_fifo_interleaved_puts_and_submits[disabled]",
        "test_blocking_ops_flush_buffer_not_timer",
        "test_actor_death_mid_batch_fails_all_inflight",
        "test_worker_death_mid_batch_fails_pipelined_tasks",
        "test_disabled_knob_matches_batched_results", "test_batched_sender_framing_and_fifo")),
    *(f"test_runtime_env.py::{n}" for n in (
        "test_env_hash_and_isolation_predicate", "test_pip_env_isolated_from_siblings",
        "test_pip_env_actor", "test_working_dir", "test_py_modules",
        "test_runtime_env_setup_failure_surfaces", "test_env_workers_pooled_separately",
        "test_container_runtime_env_spawns_via_shim",
        "test_container_without_binary_fails_clearly", "test_conda_plugin_build_via_shim")),
    *(f"test_memory_monitor.py::{n}" for n in (
        "test_real_snapshot_sane", "test_fake_usage_file_overrides", "test_process_rss_self",
        "test_policy_retriable_fifo_kills_oldest_retriable",
        "test_policy_retriable_lifo_kills_newest_retriable",
        "test_policy_falls_back_to_nonretriable",
        "test_policy_group_by_owner_prefers_biggest_retriable_group", "test_policy_unknown_raises",
        "test_memory_hog_killed_retried_and_node_survives",
        "test_memory_hog_without_retries_raises_oom")),
    *(f"test_log_streaming.py::{n}" for n in (
        "test_remote_print_reaches_driver", "test_actor_stderr_reaches_driver",
        "test_worker_crash_pushes_error_channel", "test_log_to_driver_false_suppresses",
        "test_custom_pubsub_channel_inproc", "test_multiline_and_flush_batching")),
    *(f"test_tracing.py::{n}" for n in (
        "test_task_spans_propagate_trace", "test_error_span_status", "test_custom_spans_nest")),
    *(f"test_native_arena.py::{n}" for n in (
        "test_alloc_free_coalesce", "test_cross_process_visibility", "test_concurrent_allocators",
        "test_put_get_through_arena", "test_tasks_roundtrip_arena",
        "test_refdrop_frees_arena_allocation", "test_zero_copy_view_pins_allocation",
        "test_arena_full_falls_back_to_files", "test_cross_node_pull_of_arena_object")),
    *(f"test_object_transfer.py::{n}" for n in (
        "test_pull_priority_and_inflight_bound", "test_pull_dedup_coalesces_concurrent_readers",
        "test_pull_cancellation", "test_priority_upgrade_on_dedup",
        "test_admit_drain_survives_mass_synchronous_failures", "test_chunk_reassembly_many_chunks",
        "test_cross_node_get_bypasses_head", "test_relay_counters_observe_fallback",
        "test_locality_lease_placement_and_counter")),
    *(f"test_failures.py::{n}" for n in (
        "test_worker_crash_no_retries[inproc]", "test_worker_crash_no_retries[head_process]",
        "test_worker_crash_with_retry_succeeds[inproc]",
        "test_worker_crash_with_retry_succeeds[head_process]", "test_cancel_pending_task[inproc]",
        "test_cancel_pending_task[head_process]", "test_cancel_running_task_force[inproc]",
        "test_cancel_running_task_force[head_process]",
        "test_multinode_spread_and_node_failure[virtual]",
        "test_multinode_spread_and_node_failure[real]",
        "test_infeasible_becomes_feasible_on_new_node[virtual]",
        "test_infeasible_becomes_feasible_on_new_node[real]")),
    *(f"test_multinode.py::{n}" for n in (
        "test_daemon_node_runs_tasks", "test_cross_node_object_flow",
        "test_forced_pull_between_daemon_nodes", "test_actor_on_daemon_node",
        "test_daemon_kill_retries_task_elsewhere", "test_placement_group_across_real_nodes",
        "test_client_driver_kv_and_named_actors")),
    *(f"test_locality.py::{n}" for n in (
        "test_task_follows_its_argument", "test_small_args_do_not_drive_placement",
        "test_peer_direct_pull_between_daemons", "test_locality_yields_when_holder_saturated")),
]

EXCLUDED = {
    "test_ownership.py::test_owner_crash_replay_determinism": (
        "marked slow in the JAX package: the tier-1 run deselects it (-m 'not slow') "
        "there too"),
    "test_ownership.py::test_reconstruction_only_while_owner_survives": (
        "skips itself in both packages wherever the native arena backs object "
        "segments (it cannot unlink a slice of the arena, test_ownership.py:155), "
        "which it does on every machine with a C++ toolchain"),
    "test_log_streaming.py::test_multiline_and_flush_batching": (
        "races pytest's capfd in both packages: the worker's lines reach the driver's "
        "captured stderr from the head's thread just as the test's first readouterr() "
        "reads and truncates the capture file, and are lost (1 run in 3 to 6 alone on "
        "this CPU against either package; none of 10 with a 1 s pause before the first "
        "read)"),
}
RUN = [t for t in TEST_IDS if t not in EXCLUDED]


def _rename(text):
    text = re.sub(r"\bray_tpu\b", "ray_tpu_torch", text).replace("RAY_TPU_", "RAY_TPU_TORCH_")
    return re.sub(r"\bnum_tpus\b", "num_gpus", text).replace("--num-tpus", "--num-gpus")


def _copy_renamed(dst):
    os.makedirs(os.path.join(dst, "tests"))
    for name in FILES:
        with open(os.path.join(TESTS, name)) as f:
            text = f.read()
        with open(os.path.join(dst, "tests", name), "w") as f:
            f.write(_rename(text))
    with open(os.path.join(dst, "serve_port_plugin.py"), "w") as f:
        f.write(PORT_PLUGIN)


def _outcomes(xml_path):
    out = {}
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        name = f"{case.get('classname').split('.')[-1]}.py::{case.get('name')}"
        bad = [c for c in case if c.tag in ("failure", "error", "skipped")]
        out[name] = ("passed", "") if not bad else (bad[0].tag, (bad[0].get("message") or "")[:2000])
    return out


# Session, head and node directories of the port in /dev/shm, each named
# ray_tpu_torch_<kind>_<pid>_...
_SHM = ("/dev/shm/ray_tpu_torch_session_*", "/dev/shm/ray_tpu_torch_head_*")


def _shm_dirs():
    return {d for pattern in _SHM for d in glob.glob(pattern)}


def _remove_dead_dirs(before):
    """Remove the session and head directories that appeared during the run
    and whose process is gone: several cases SIGKILL a head or a driver, and
    nothing is left to remove what it made."""
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
    dst = str(tmp_path_factory.mktemp("jax_suites_runtime"))
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
    assert sorted(FILES[1:]) == sorted(set(FILES[1:]))


def test_renames_leave_no_tpu_argument():
    # The third rename covers every num_tpus of the copies, and each passes
    # 0: no copy asks for a TPU or names a TPU resource.
    for name in FILES:
        with open(os.path.join(TESTS, name)) as f:
            text = f.read()
        assert not re.search(r"num[_-]tpus\W+[1-9]|[\"']TPU[\"']|TPU_CHIPS", text), name
        renamed = _rename(text)
        assert not re.search(r"num[_-]tpus|\bray_tpu\b|RAY_TPU_(?!TORCH_)", renamed), name


@pytest.mark.parametrize("test_id", RUN)
def test_jax_suite_passes_against_the_port(outcomes, test_id):
    results, log = outcomes
    outcome, message = results.get(test_id, ("not run", log[-2000:]))
    assert outcome == "passed", f"{test_id}: {outcome}\n{message}"
