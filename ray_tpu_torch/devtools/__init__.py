"""rt-lint: AST-based invariant analysis for the ray_tpu_torch control plane.

Pure stdlib (ast + os): the linter parses the tree, it never imports the
runtime, so it runs in a bare venv and can't be broken by a bug it is trying
to find. Entry point::

    python -m ray_tpu_torch.devtools.lint [paths] [--allowlist FILE]

Passes (each in its own module, all driven by lint.py):

  protocol   -- every sender site and reader dispatch loop cross-checked
                against protocol.MESSAGE_GRAMMAR (tags, arities, coverage)
  blocking   -- call graph rooted at scheduler loop-thread entry points;
                reachable blocking primitives (sleep/recv/file I/O/...) flagged
  affinity   -- @loop_thread_only/@any_thread annotations (concurrency.py)
                verified: no any->loop calls, no unlocked cross-affinity state
  config     -- every cfg.<name> access and RAY_TPU_TORCH_* env read must map to a
                declared Config field or the ENV_VARS registry; dead knobs flagged
  metrics    -- metric names must match ray_tpu_* and be documented in
                COMPONENTS.md; hot-path modules must not touch Metric objects
  failpoints -- failpoint names must appear in COMPONENTS.md's table
  ownership  -- owner-path modules must not touch head tables directly

System-level verification lives in the `verify` subpackage (rt-verify:
protocol session machine, lock-order cycles, native C checks, stale-binary
guard, wire-codec fuzzing) — `python -m ray_tpu_torch.devtools.verify`. Both
tools share the parsed-AST cache in astutil (one parse per file per
process).

Violations carry stable symbol keys (no line numbers); the checked-in
allowlist (lint_allowlist.txt) suppresses a violation only with a per-line
justification, and unused entries fail the run.
"""
