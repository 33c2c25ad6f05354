#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, in this process.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``ray_tpu_torch``: starts the port's
runtime with the cell's GPUs (``ray_tpu_torch.init``), trains through
``TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=N,
use_gpu=True[, mesh=...]))`` with ``port_bench/loop.py``'s loop, and prints
as the last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number the check compared beside its
limit (also the last lines of standard error). Exits non-zero, and prints no
result, without the cell's CUDA devices, without ``ray_tpu_torch`` in the
checkout, when a worker fails, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 2**30


def process_start_time():
    """This process's start, in seconds since the epoch: its start in clock
    ticks after boot (/proc) against the time since boot now."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    return time.time() - age


class Fail(Exception):
    """A run that must print no result."""


def cache_dirs(root):
    """Every build and kernel cache in a fixed directory of the checkout
    (the port's own kernel library builds into ``ray_tpu_torch/_build/``),
    and one thread for the CPU's math libraries: the host's work here is
    dispatch, and idle pools only contend with it. CUDA's launch queues are
    four times their default, so the host dispatches about a step and a half
    of the step's ~2,800 kernels ahead and a short stall of the host leaves
    the card fed (by default the queue fills within one step)."""
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[key] = "1"
    os.environ["CUDA_SCALE_LAUNCH_QUEUES"] = "4x"
    base = os.path.join(root, "port_bench", ".cache")
    for key, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[key] = os.path.join(base, sub)


def p95(xs):
    return statistics.quantiles(xs, n=100, method="inclusive")[94]


class Run:
    """What the per-layer readers read: every rank's payload (``ranks``),
    the cell (``cell``: ``model``, ``traffic``, ``chips``) and the driver's
    clock at ``fit()`` (``fit_start``)."""

    def __init__(self, cell, ranks, fit_start):
        self.cell, self.ranks, self.fit_start = cell, ranks, fit_start
        self.model, self.traffic, self.gpus = cell["model"], cell["traffic"], len(ranks)

    @property
    def window_s(self):
        return max(r["window"]["seconds"] for r in self.ranks)

    @property
    def window_tokens(self):
        return self.ranks[0]["window"]["tokens"]


def end_to_end(run, process_start):
    ranks = run.ranks
    # A step ends on a mesh when its last rank's step ends.
    steps = min(len(r["window"]["boundaries_ms"]) for r in ranks)
    ends = [max(r["window"]["boundaries_ms"][i] for r in ranks) for i in range(steps)]
    intervals = [b - a for a, b in zip([0.0] + ends, ends)]
    peaks = [r["window"]["peak_bytes"] for r in ranks]
    return {
        "train_tokens_per_s": run.window_tokens / run.window_s / run.gpus,
        "step_ms_p95": p95(intervals) if len(intervals) >= 2 else None,
        "peak_mem_gib": max(peaks) / GIB if None not in peaks else None,
        "setup_s": max(r["stamps"]["window_open"] for r in ranks) - process_start,
        "intervals_ms": intervals,
    }, (max(peaks) if None not in peaks else None)


def per_layer(run):
    from port_bench.cells import reader

    out = {}
    for m in run.cell["per_layer"]:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(run):
    from port_bench.trace import traces

    ts = traces(run.ranks)
    if not ts:
        return None
    ops, gaps = {}, {}
    for t in ts:
        for name, s in t.by_name_s().items():
            ops[name] = ops.get(name, 0.0) + s / len(ts)
    for r in run.ranks:
        for name, us in (r.get("trace") or {}).get("idle_us_by_host_op", []):
            gaps[name] = gaps.get(name, 0.0) + us / 1e6 / len(ts)

    def top(d):
        return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def _clean(x):
    """Non-finite floats as null, so the line is strict JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _clean(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_clean(v) for v in x]
    return x


def train(cell, seed, seconds, trace, device, fault=None):
    """Every rank's payload from one ``TorchTrainer.fit()`` of the cell on a
    fresh runtime, the driver's clock at ``fit()``, and its set-up stamps."""
    import ray_tpu_torch
    import ray_tpu_torch.train.torch as rt_torch
    from ray_tpu_torch.air import FailureConfig, RunConfig, ScalingConfig

    from port_bench.loop import train_loop

    workers = cell["traffic"].get("workers", 1)
    on_card = device == "cuda"
    stamps = {"imported": time.time()}
    ray_tpu_torch.init(num_cpus=max(4, workers + 2), num_gpus=workers if on_card else 0,
                       log_to_driver=False)
    try:
        session_dir = ray_tpu_torch._private.worker.global_worker.session_dir
        mesh = cell["traffic"].get("mesh") if workers > 1 else None
        trainer = rt_torch.TorchTrainer(
            train_loop,
            train_loop_config={"cell": cell, "seed": seed, "seconds": seconds, "trace": trace,
                               "device": device, "fault": fault},
            scaling_config=ScalingConfig(num_workers=workers, use_gpu=on_card, mesh=mesh),
            backend_config=rt_torch.TorchConfig(backend="nccl" if on_card else "gloo",
                                                device=None if on_card else "cpu"),
            run_config=RunConfig(name="port_bench",
                                 storage_path=os.path.join(session_dir, "results"),
                                 failure_config=FailureConfig(max_failures=0)))
        stamps["runtime_ready"] = fit_start = time.time()
        result = trainer.fit()
        if result.error is not None:
            logs = os.path.join(session_dir, "logs")
            for name in sorted(os.listdir(logs)) if os.path.isdir(logs) else []:
                if name.startswith("worker-"):
                    with open(os.path.join(logs, name), errors="replace") as f:
                        tail = "".join(f.readlines()[-30:])
                    print(f"--- {name} (tail)\n{tail}", file=sys.stderr)
            raise Fail(f"the run failed: {result.error!r}")
        ranks = result.metrics["ranks"]
    finally:
        ray_tpu_torch.shutdown()
    return ranks, fit_start, stamps


def run_cell(cell, seed, seconds, trace, device="cuda", process_start=None, fault=None):
    """One run of ``cell`` (from ``cells.resolve``): the result's line as a
    dict. ``device="cpu"`` drives the same path on the CPU (the tests, at a
    small size)."""
    from port_bench import archs, check
    from port_bench.loop import forbidden_modules

    process_start = process_start if process_start is not None else time.time()
    ranks, fit_start, driver = train(cell, seed, seconds, trace, device, fault)
    found = sorted({m for r in ranks for m in r["forbidden_modules"]} | set(forbidden_modules()))
    if found:
        raise Fail(f"JAX or the JAX package was loaded: {found}")
    run = Run(cell, ranks, fit_start)
    e2e, peak_bytes = end_to_end(run, process_start)
    on_card = device == "cuda"
    launches = archs.attention_launches(cell["model"], cell["traffic"])
    correct, checks, detail = check.decide(ranks, cell["limits"], launches, on_card)
    window = ranks[0]["window"]
    every = cell["traffic"]["report_every"]
    failed = every * sum(not math.isfinite(x) for x in window["losses"])
    units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
    if trace:
        metrics = per_layer(run)
    else:
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items()
                   if k in units and v is not None}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": ranks[0]["device_name"],
           "count": len(ranks), "memory_peak_bytes": peak_bytes}
    line = {"correct": correct, "attempted": window["steps"],
            "failed": min(failed, window["steps"]), "metrics": metrics, "device": dev}
    if trace:
        from port_bench.trace import mean, traces

        ts = traces(ranks)
        if ts:
            dev["busy_s"] = mean(t.busy_s for t in ts)
            dev["window_s"] = mean(t.window_s for t in ts)
        line["breakdown"] = breakdown(run)
    line["run"] = {"seed": seed, "window_s": run.window_s, "steps": window["steps"],
                   "intervals_ms": [round(x, 3) for x in e2e.pop("intervals_ms")],
                   "reference_s": ranks[0].get("reference_s"), "detail": detail,
                   "gc_ms": [[g, round(ms, 3)] for g, ms in window["gc_ms"] if g == 2 or ms > 5],
                   "stamps": [r["stamps"] for r in ranks], "driver": driver,
                   "process_start": process_start}
    line["checks"] = checks
    return _clean(line)


def require_cards(n):
    import torch

    if not torch.cuda.is_available():
        raise Fail("no CUDA device is available")
    if torch.cuda.device_count() < n:
        raise Fail(f"the cell needs {n} CUDA devices; {torch.cuda.device_count()} are visible")


def require_port(root):
    import importlib.util

    spec = importlib.util.find_spec("ray_tpu_torch")
    if spec is None or not os.path.abspath(spec.origin).startswith(root + os.sep):
        raise Fail(f"ray_tpu_torch is not in the checkout at {root}")


def main(argv=None):
    process_start = process_start_time()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    # Count the cards through NVML: the driver process never touches CUDA.
    os.environ["PYTORCH_NVML_BASED_CUDA_CHECK"] = "1"
    try:
        from port_bench import cells

        require_port(ROOT)
        cell = cells.resolve(args.workload)
        require_cards(cell["chips"])
        cache_dirs(ROOT)
        line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", process_start)
    except (Fail, KeyError, OSError, ImportError, ValueError) as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
