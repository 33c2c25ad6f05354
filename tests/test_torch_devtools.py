"""The port's devtools (``ray_tpu_torch/devtools``: rt-lint and rt-verify)
against the JAX package's.

1. The same findings on the same synthetic packages: every fixture test of
   the JAX package's ``tests/test_static_analysis.py`` runs twice, once as
   it is (the JAX tools) and once renamed to the port (``ray_tpu`` ->
   ``ray_tpu_torch``, ``RAY_TPU_`` -> ``RAY_TPU_TORCH_``), and each pass's
   findings, call by call, must be the same keys and lines once the port's
   names are mapped back.
2. The port's live tree is clean under the port's own allowlists, which hold
   no stale entry, no lifecycle finding of the never-written kind and no
   ``batch`` "no sender site" entry.
3. The JAX lint over the port reports the port's covered modules as unseen
   (28 lifecycle findings) and the coalesced ``batch`` frame as never sent;
   the port's lint, pointed at the port, reports neither.
"""

import os
import re
import subprocess
import sys
import types

import pytest

import ray_tpu.devtools as jdevtools
import ray_tpu.devtools.verify as jverify
import ray_tpu_torch.devtools as tdevtools
import ray_tpu_torch.devtools.verify as tverify
from ray_tpu_torch.devtools import lint as tlint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "ray_tpu_torch")
JAX_TESTS = os.path.join(ROOT, "tests", "test_static_analysis.py")

LINT_PASSES = ("pass_protocol", "pass_blocking", "pass_affinity", "pass_config",
               "pass_metrics", "pass_failpoints", "pass_ownership", "pass_lifecycle")
VERIFY_PASSES = ("pass_session", "pass_lockorder", "pass_native", "stale")

# The fixture tests of tests/test_static_analysis.py: each builds its own
# small package (or C source, allowlist or directory) and reads nothing of a
# live tree.
FIXTURE_TESTS = (
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
    "test_metrics_unregistered_emit_kind_flagged", "test_failpoints_documented_names_are_clean",
    "test_failpoints_undocumented_and_bad_names_flagged",
    "test_ownership_head_table_access_flagged", "test_ownership_scheduler_module_itself_exempt",
    "test_allowlist_requires_justification_and_rejects_stale",
    "test_session_good_fixture_is_clean", "test_session_role_violation_flagged",
    "test_session_unmapped_module_flagged", "test_session_spec_coherence_checks",
    "test_session_stream_coverage", "test_lockorder_cycle_and_self_cycle_detected",
    "test_lockorder_clean_fixture_and_nested_def_excluded",
    "test_lockorder_guard_decorator_counts_as_held",
    "test_native_pass_bad_fixture_flags_all_kinds", "test_native_pass_good_fixture_is_clean",
    "test_stale_binary_guard",
)


def _rename(text):
    return re.sub(r"\bray_tpu\b", "ray_tpu_torch", text).replace("RAY_TPU_", "RAY_TPU_TORCH_")


def _unrename(text):
    return text.replace("ray_tpu_torch", "ray_tpu").replace("RAY_TPU_TORCH_", "RAY_TPU_")


def _load_tests(port):
    with open(JAX_TESTS) as f:
        src = f.read()
    mod = types.ModuleType("static_analysis_port" if port else "static_analysis_jax")
    mod.__file__ = JAX_TESTS
    exec(compile(_rename(src) if port else src, JAX_TESTS, "exec"), mod.__dict__)
    return mod


@pytest.fixture(scope="module")
def suites():
    return {"jax": _load_tests(port=False), "port": _load_tests(port=True)}


def _record(monkeypatch, suite, devtools, verify, calls):
    """Wrap every pass's run, and the suite's allowlist helpers, so each
    call's findings land in `calls`."""
    import importlib

    def load_allowlist(path, _load=suite.load_allowlist):
        entries, errors = _load(path)
        calls.append(("load_allowlist", sorted(e.key for e in entries),
                      [e.replace(str(path), "<allowlist>") for e in errors]))
        return entries, errors

    def apply_allowlist(violations, entries, _apply=suite.apply_allowlist):
        remaining, unused = _apply(violations, entries)
        calls.append(("apply_allowlist", sorted(v.key for v in remaining),
                      sorted(e.key for e in unused)))
        return remaining, unused

    monkeypatch.setattr(suite, "load_allowlist", load_allowlist)
    monkeypatch.setattr(suite, "apply_allowlist", apply_allowlist)

    mods = [importlib.import_module(f"{devtools.__name__}.{m}") for m in LINT_PASSES]
    mods += [importlib.import_module(f"{verify.__name__}.{m}") for m in VERIFY_PASSES]
    for mod in mods:
        def run(*args, _run=mod.run, _name=mod.__name__.rsplit(".", 1)[1], **kwargs):
            found = _run(*args, **kwargs)
            calls.append((_name, sorted((v.key, v.line) for v in found), []))
            return found

        monkeypatch.setattr(mod, "run", run)


@pytest.mark.parametrize("name", FIXTURE_TESTS)
def test_same_findings_as_jax_on_the_synthetic_packages(suites, name, tmp_path, monkeypatch):
    found = {}
    for side, (devtools, verify) in (("jax", (jdevtools, jverify)),
                                     ("port", (tdevtools, tverify))):
        calls = []
        with monkeypatch.context() as m:
            _record(m, suites[side], devtools, verify, calls)
            fn = getattr(suites[side], name)
            work = tmp_path / side
            work.mkdir()
            fn(work) if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount] else fn()
        found[side] = [_unrename(repr(call).replace(str(work), "<tmp>")) for call in calls]
    assert found["jax"], f"{name} ran no pass"
    assert found["port"] == found["jax"]


def test_live_tree_is_clean_under_the_ports_allowlists():
    violations, errors = tlint.run_all(PORT_DIR, allowlist_path=tlint.DEFAULT_ALLOWLIST)
    assert not violations and not errors, [v.render() for v in violations] + errors
    violations, errors = tverify.run_all(PORT_DIR, allowlist_path=tverify.DEFAULT_ALLOWLIST)
    assert not violations and not errors, [v.render() for v in violations] + errors
    # The allowlists live in the port; no entry hides an unseen module or the
    # coalesced batch frame.
    assert os.path.dirname(tlint.DEFAULT_ALLOWLIST) == os.path.join(PORT_DIR, "devtools")
    assert os.path.dirname(tverify.DEFAULT_ALLOWLIST) == os.path.join(
        PORT_DIR, "devtools", "verify")
    for path in (tlint.DEFAULT_ALLOWLIST, tverify.DEFAULT_ALLOWLIST):
        with open(path) as f:
            keys = [line.split(" -- ")[0] for line in f if line.strip() and not line.startswith("#")]
        assert not [k for k in keys if k.endswith(":unreachable") or "never-sent" in k], keys


@pytest.mark.parametrize("tool", ["lint", "verify"])
def test_cli_exits_zero_on_the_live_tree(tool):
    proc = subprocess.run([sys.executable, "-m", f"ray_tpu_torch.devtools.{tool}", "ray_tpu_torch",
                           "-q"], cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"rt-{tool} OK: 0 violation(s)" in proc.stdout


def test_jax_lint_over_the_port_sees_nothing_the_ports_lint_sees():
    from ray_tpu.devtools import lint as jlint

    jax_keys = [v.key for v in jlint.run_all(PORT_DIR, passes=["lifecycle", "protocol"])[0]]
    unseen = [k for k in jax_keys if k.startswith("lifecycle:") and k.endswith(":unreachable")]
    assert len(unseen) == 28, jax_keys
    assert "protocol:protocol.py:tag=batch:never-sent" in jax_keys
    ours = [v.key for v in tlint.run_all(PORT_DIR, passes=["lifecycle", "protocol"])[0]]
    assert ours == ["lifecycle:scheduler.py:DriverHandle.__init__:attr=state:unattributed-write"]


def test_corpora_are_read_from_tools_and_written_to_the_ports_own(tmp_path, monkeypatch):
    from ray_tpu_torch.devtools.verify import explore, fuzz_wire

    tools = os.path.join(ROOT, "tools")
    assert fuzz_wire.DEFAULT_CORPUS == os.path.join(tools, "fuzz_corpus")
    assert explore.CORPUS_DIR == os.path.join(tools, "explore_corpus")
    assert not fuzz_wire.OWN_CORPUS.startswith(tools)
    assert not explore.OWN_CORPUS_DIR.startswith(tools)
    # A write on the shared default goes to the port's own directory; a path
    # the caller passes is written as given.
    own = tmp_path / "own"
    monkeypatch.setattr(fuzz_wire, "OWN_CORPUS", str(own))
    path = fuzz_wire._persist(fuzz_wire.DEFAULT_CORPUS, "crashers", b"\x00frame")
    assert path.startswith(str(own)) and os.path.exists(path)
    assert fuzz_wire._corpus_files(fuzz_wire.DEFAULT_CORPUS)[-1] == path
    given = tmp_path / "given"
    assert fuzz_wire._persist(str(given), "seeds", b"x").startswith(str(given))
    monkeypatch.setattr(explore, "OWN_CORPUS_DIR", str(tmp_path / "explore_own"))
    assert explore._corpus_path("drain_vs_kill").startswith(str(tmp_path / "explore_own"))
    # The JAX package's stored schedules replay against the port's scheduler.
    doc = explore._load_corpus("drain_vs_kill")
    assert doc and doc["schedules"]
    assert all(explore.replay("drain_vs_kill", s)[0] for s in doc["schedules"])
