"""The JAX package's own tool, GBDT and runtime suites, run against the port.

The files below (GBDT; rt-lint and rt-verify with the lifecycle pass, the
schedule explorer, the arena's ThreadSanitizer stress and the wire fuzzer;
failpoints, elastic training, train observability, the Torch trainer and the
collective groups) are copied unedited into a temporary directory, with these
renames applied to their text:

- ``ray_tpu.train.jax import resharding`` -> ``ray_tpu_torch.train.torch
  import resharding``: the port's resharding sits with its trainer;
- ``\\bray_tpu\\b`` -> ``ray_tpu_torch`` and ``RAY_TPU_`` ->
  ``RAY_TPU_TORCH_``: the port's package and its environment keys;
- ``num_tpus`` -> ``num_gpus`` in both its spellings: the port's nodes count
  GPUs (every site of these files passes 0).

The devtools suites read the tree beside their own file (``REPO_ROOT =
dirname(tests/)``): the package, ``COMPONENTS.md`` and the native sources.
So the temporary directory holds links to the port's package and to the
repo's ``COMPONENTS.md`` beside the copied ``tests/``; ``PYTHONPATH`` puts the
repo first (and ``python -P`` keeps the copy's directory off ``sys.path``),
so the port is imported from its own path and its corpora
(``tools/fuzz_corpus``, ``tools/explore_corpus``, read only) are the repo's.

They run in three pytest subprocesses, one after the other, each serially and
under its own time limit (the runtime suites start processes of their own,
and load beside the rest of the tier-1 run makes the JAX package's own
timing bars late), and their junit XML gives each test's outcome. The
subprocesses load the Serve harness's ``PORT_PLUGIN``: a failpoint case
starts Serve, whose fixed default port the JAX package's Serve suites bind in
the same run. Each JAX test id (with its parameters) is one parametrized case
here, which passes only if that test passed against the port. A test that
cannot run against the port is in ``EXCLUDED`` with its reason, and is
deselected, not run.
"""

import glob
import os
import re
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest
from test_torch_jax_suites_serve import PORT_PLUGIN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
# Three shards of 40-100 s each here, run one after the other; a shard that
# does not finish in TIMEOUT_S fails its own cases only.
SHARDS = (
    ("test_gbdt.py", "test_static_analysis.py", "test_lifecycle.py", "test_explore.py",
     "test_arena_stress.py", "test_wire_fuzz.py"),
    ("test_failpoints.py",),
    ("test_elastic.py", "test_train_obs.py", "test_train_torch.py", "test_collective.py"),
)
FILES = ["conftest.py", *(f for shard in SHARDS for f in shard)]
TIMEOUT_S = 300
# What the copies read beside their tests/ directory.
LINKED = ("ray_tpu_torch", "COMPONENTS.md")

RENAMES = (
    (r"\bray_tpu\.train\.jax import resharding\b", "ray_tpu.train.torch import resharding"),
    (r"\bray_tpu\b", "ray_tpu_torch"),
    (r"RAY_TPU_", "RAY_TPU_TORCH_"),
    (r"\bnum_tpus\b", "num_gpus"),
    (r"--num-tpus", "--num-gpus"),
)

_MALFORMED = (
    "empty", "truncated-int", "truncated-float", "truncated-bytes-header",
    "truncated-bytes-payload", "truncated-str-payload", "truncated-tuple-items",
    "oversized-list-count", "oversized-tuple-count", "oversized-dict-count",
    "oversized-bytes-length", "unknown-type-byte", "trailing-bytes",
    "nesting-over-limit", "bad-utf8", "unhashable-dict-key", "hook-truncated",
    "hook-truncated-payload",
)

# Every test of the files above, by id (file::name[parameters]). A test added
# to one of the files fails test_every_jax_test_is_run_or_excluded until it is
# listed.
TEST_IDS = [
    *(f"test_gbdt.py::{n}" for n in (
        "test_xgboost_regression_converges", "test_xgboost_classification_and_batch_predict",
        "test_distributed_matches_single_worker",
        "test_resume_from_checkpoint_continues_boosting", "test_lightgbm_param_translation")),
    *(f"test_static_analysis.py::{n}" for n in (
        "test_protocol_good_fixture_is_clean", "test_protocol_bad_fixture_flags_all_drift_kinds",
        "test_protocol_never_sent_detected",
        "test_protocol_dynamic_tuple_registers_tag_without_arity_check",
        "test_blocking_bad_fixture_flags_reachable_sleep",
        "test_blocking_good_fixture_unreachable_and_guarded",
        "test_blocking_nested_thread_target_not_attributed",
        "test_blocking_untimed_waits_spelled_with_args_still_flagged",
        "test_blocking_loop_thread_only_annotation_is_a_root",
        "test_affinity_bad_fixture_flags_call_and_unlocked_store",
        "test_affinity_good_fixture_locked_store_is_clean",
        "test_affinity_lock_guarded_counts_as_locked",
        "test_affinity_closure_not_attributed_to_enclosing_function",
        "test_config_bad_fixture_flags_typo_dead_and_env", "test_config_good_fixture_is_clean",
        "test_config_rllib_style_config_objects_ignored", "test_metrics_bad_names_flagged",
        "test_metrics_hot_module_import_and_calls_flagged",
        "test_metrics_plain_int_bumps_are_fine_in_hot_modules",
        "test_metrics_alert_rules_and_event_kinds_cross_checked",
        "test_metrics_unregistered_emit_kind_flagged",
        "test_metrics_live_alert_pack_parses_as_literal",
        "test_failpoints_documented_names_are_clean",
        "test_failpoints_undocumented_and_bad_names_flagged",
        "test_ownership_head_table_access_flagged",
        "test_ownership_scheduler_module_itself_exempt",
        "test_allowlist_requires_justification_and_rejects_stale",
        "test_live_tree_is_clean_under_shipped_allowlist", "test_cli_exits_zero_on_live_tree",
        "test_grammar_is_a_pure_literal", "test_session_good_fixture_is_clean",
        "test_session_role_violation_flagged", "test_session_unmapped_module_flagged",
        "test_session_spec_coherence_checks", "test_session_stream_coverage",
        "test_lockorder_cycle_and_self_cycle_detected",
        "test_lockorder_clean_fixture_and_nested_def_excluded",
        "test_lockorder_guard_decorator_counts_as_held",
        "test_native_pass_bad_fixture_flags_all_kinds", "test_native_pass_good_fixture_is_clean",
        "test_stale_binary_guard", "test_checked_in_binaries_match_their_sources",
        "test_verify_live_tree_is_clean_under_shipped_allowlist",
        "test_verify_cli_exits_zero_on_live_tree", "test_session_spec_is_a_pure_literal",
        "test_parsed_ast_cache_shared_across_passes",
        "test_debug_invariants_guards_fire_in_subprocess",
        "test_debug_invariants_off_mode_is_identity",
        "test_cluster_runs_clean_under_debug_invariants")),
    *(f"test_lifecycle.py::{n}" for n in (
        "test_good_fixture_is_clean", "test_L1_undeclared_transition_and_bypass",
        "test_L2_initial_mismatch_default_and_init", "test_L3_unknown_state_and_machine",
        "test_L4_unauthorized_module", "test_L5_unknown_state_compare",
        "test_L6_unreachable_state", "test_L7_unattributed_write",
        "test_L8_old_arg_and_spec_incoherence", "test_missing_spec_is_a_violation",
        "test_spec_is_a_pure_literal_with_enough_machines",
        "test_spec_literal_parses_without_import",
        "test_live_tree_is_clean_under_shipped_allowlist",
        "test_cli_json_output_includes_lifecycle_pass",
        "test_runtime_monitor_enforces_spec_edges",
        "test_runtime_monitor_disabled_is_passthrough",
        "test_debug_invariants_env_arms_monitor")),
    *(f"test_explore.py::test_scenario_quiesces_clean[{n}]" for n in (
        "drain_vs_kill", "hb_verdict_vs_rejoin", "seal_vs_owner_death",
        "submit_vs_worker_death")),
    *(f"test_explore.py::{n}" for n in (
        "test_exploration_actually_permutes", "test_finds_planted_double_seal",
        "test_finds_planted_lost_task", "test_seeded_replay_determinism",
        "test_replay_reproduces_schedules", "test_replay_rejects_unknown_key",
        "test_sweep_writes_and_replays_corpus", "test_committed_corpus_replays",
        "test_harness_releases_fds")),
    *(f"test_arena_stress.py::{n}" for n in (
        "test_tsan_thread_stress", "test_multiprocess_fuzz_with_kill")),
    *(f"test_wire_fuzz.py::{n}" for n in (
        "test_magic_framed_garbage_is_wire_decode_error",
        "test_nesting_within_limit_accepted_beyond_rejected",
        "test_hook_payload_shape_errors_are_typed",
        "test_wire_max_frame_bytes_enforced_and_configurable",
        "test_wire_max_frame_bytes_is_a_config_knob",
        "test_valid_frames_still_roundtrip_both_codecs", "test_fuzz_smoke_with_corpus_replay",
        "test_fuzzer_detects_a_planted_untyped_error",
        "test_known_crasher_corpus_is_nonempty_and_rejects",
        "test_frame_map_matches_encoder_layout",
        "test_session_monitor_flags_out_of_state_frames", "test_session_monitor_stream_machine",
        "test_session_monitor_compiles_from_live_spec")),
    *(f"test_wire_fuzz.py::test_malformed_frames_raise_typed_errors[{n}-{c}]"
      for n in _MALFORMED for c in ("py", "c")),
    *(f"test_wire_fuzz.py::test_malformed_frames_reject_parity[{n}]" for n in _MALFORMED),
    *(f"test_failpoints.py::test_chaos_matrix[{n}]" for n in (
        "tasks-crash-before-args", "tasks-crash-after-exec", "tasks-crash-before-store",
        "tasks-sched-cmd-submit", "tasks-sched-send-error", "tasks-conn-close",
        "reconstruct-lose-segment", "put-lose-segment", "args-lose-segment",
        "actor-crash-restart", "serve-replica-death", "rendezvous-kv-error")),
    *(f"test_failpoints.py::test_exception_taxonomy[{n}]" for n in (
        "worker-crash", "object-lost", "actor-died", "injected-handler")),
    *(f"test_failpoints.py::test_transfer_chaos_matrix[transfer-{n}]" for n in (
        "chunk-drop", "chunk-dup", "chunk-close", "peer-dial-error",
        "lose-segment-reconstruct")),
    *(f"test_failpoints.py::{n}" for n in (
        "test_deep_pipeline_crash_schedule_exactly_once_completions",
        "test_seeded_probability_replays_exactly", "test_trigger_semantics_and_env_parse",
        "test_heartbeat_detects_hung_daemon_sigstop",
        "test_heartbeat_dropped_beats_fail_over_tasks",
        "test_node_killer_timeline_events_and_dead_guard",
        "test_sender_daemon_death_mid_stream_fails_over_to_replica")),
    *(f"test_elastic.py::{n}" for n in (
        "test_match_partition_rules", "test_shard_bounds_match_array_split",
        "test_shard_gather_roundtrip_even_and_uneven", "test_reshard_across_world_sizes",
        "test_atomic_persist_survives_midwrite_crash", "test_seeded_schedule_is_deterministic",
        "test_elastic_shrink_bit_exact", "test_elastic_grow_when_capacity_returns",
        "test_preemption_notice_grace_flushes_then_resizes",
        "test_rank0_death_recovers_from_peer_mirror", "test_chaos_runs_are_deterministic",
        "test_below_min_workers_falls_back_to_failure_budget",
        "test_scaling_config_validates_elastic_fields",
        "test_suspect_worker_triggers_proactive_checkpoint")),
    *(f"test_train_obs.py::{n}" for n in (
        "test_phase_telemetry_and_goodput_ledger", "test_straggler_named_with_dominant_phase",
        "test_worker_crash_lands_in_recover_bucket", "test_collective_timed_records_failed_ops",
        "test_rendezvous_wait_telemetry", "test_metrics_off_disables_train_observability")),
    *(f"test_train_torch.py::{n}" for n in (
        "test_torch_trainer_ddp_two_workers", "test_torch_trainer_single_worker_no_pg")),
    *(f"test_collective.py::{n}" for n in (
        "test_tcp_collective_group_across_actors", "test_tcp_reduce_to_root",
        "test_xla_multidevice_collectives", "test_xla_group_world1_semantics",
        "test_mesh_spec_and_rules", "test_mesh_spec_wrong_device_count",
        "test_tcp_p2p_send_recv", "test_xla_product_reduce",
        "test_tcp_ring_allreduce_large_payloads",
        "test_xla_two_process_group_device_resident")),
]

_JAX = ("imports jax: it runs the XLA collective group on JAX devices or the JAX mesh, "
        "which the port replaces with its NCCL device group (tests/test_torch_collective.py) "
        "and its torch mesh (tests/test_torch_parallel.py)")
_XLA_GROUP = ("drives the XLA group with numpy arrays; the port's counterpart of backend 'xla' "
              "is its NCCL device group, which takes torch tensors on the GPU and raises "
              "without one (on the CPU only with device='cpu', over gloo); "
              "tests/test_torch_collective.py::test_world_one_groups holds the same world-1 "
              "semantics and the product reduce with device='cpu'")
EXCLUDED = {
    "test_collective.py::test_xla_multidevice_collectives": _JAX,
    "test_collective.py::test_mesh_spec_and_rules": _JAX,
    "test_collective.py::test_xla_two_process_group_device_resident": _JAX,
    "test_collective.py::test_xla_group_world1_semantics": _XLA_GROUP,
    "test_collective.py::test_xla_product_reduce": _XLA_GROUP,
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
    for name in LINKED:
        os.symlink(os.path.join(ROOT, name), os.path.join(dst, name))
    with open(os.path.join(dst, "serve_port_plugin.py"), "w") as f:
        f.write(PORT_PLUGIN)


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
    dst = str(tmp_path_factory.mktemp("jax_suites_tools"))
    _copy_renamed(dst)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = os.pathsep.join([ROOT, dst])
    results, logs = {}, ""
    for i, files in enumerate(SHARDS):
        ids = [t for t in RUN if t.split("::")[0] in files]
        xml_path = os.path.join(dst, f"junit{i}.xml")
        # -P: the working directory (the copy, with its link to the package)
        # is not put first on sys.path, so the port imports from the repo.
        cmd = [sys.executable, "-P", "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist",
               "-p", "no:randomly", "-p", "serve_port_plugin", f"--junitxml={xml_path}",
               *(f"tests/{t}" for t in ids)]
        proc = subprocess.Popen(cmd, cwd=dst, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            out, _ = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            why = f"shard {i} ran past its {TIMEOUT_S} s against the port:\n{out[-2000:]}"
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


def test_renames_leave_no_jax_package_name():
    # After the renames no copy names the JAX package, its keys or a TPU
    # argument; only excluded cases import jax.
    for name in FILES:
        with open(os.path.join(TESTS, name)) as f:
            text = _rename(f.read())
        assert not re.search(r"num[_-]tpus|\bray_tpu\b|RAY_TPU_(?!TORCH_)|train\.jax\b", text), name


@pytest.mark.parametrize("test_id", RUN)
def test_jax_suite_passes_against_the_port(outcomes, test_id):
    results, log = outcomes
    outcome, message = results.get(test_id, ("not run", log[-2000:]))
    assert outcome == "passed", f"{test_id}: {outcome}\n{message}"
