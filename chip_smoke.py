#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

Phases, each printing one JSON line, none guarded by a ``try``: any failure
exits non-zero and prints no result.

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA.
2. build: ``nvcc`` builds every kernel from ``ray_tpu_torch/ops/csrc``; each
   kernel's registers, shared memory and spill bytes from ``-Xptxas -v``.
3. kernel checks: each CUDA kernel against its plain PyTorch version on the
   card, at the main-path shape and at small, ragged and d=128 shapes; the
   bf16 backward run twice on the same inputs (dq's spread between the runs,
   dk and dv identical); then each kernel's time (CUDA events around
   back-to-back calls) at the main-path shape beside its bound, its plain version's time and one
   ``F.scaled_dot_product_attention`` call's (a yardstick only: the port
   never calls it).
4. main path: GPT-2 small at full width (B 16, S 1024, bf16 compute, save_attn
   remat, AdamW) through ``create_train_state`` -> ``make_train_step``, 3 warmup
   and 10 timed steps on one fixed batch. The loss must be finite and fall,
   each kernel must launch exactly n_layer times per step, and the first step's
   loss, grad norm and each layer's qkv_w gradient must match the same
   weights and batch through plain attention.
5. profile: two more steps under ``torch.profiler``; device time per step by
   kernel, grouped into the attention kernels, GEMMs and the rest.
6. trainer: the main path's workload (the same functions, ``build_workload``
   and ``run_steps``) through the port's runtime and Train stack:
   ``ray_tpu_torch.init(num_cpus=4)``, then ``TorchTrainer(loop,
   scaling_config=ScalingConfig(num_workers=1, use_gpu=True)).fit()``, which
   runs it in a worker process on the one GPU the scheduler made visible to
   it, reporting through ``session.report``; then ``shutdown()``. The worker
   loads the kernel library phase 2 built. Checks: a ``GPU: 1`` node, one
   visible device id, 12 launches of each kernel per step in the worker,
   losses finite and falling, the first loss within 1e-4 of the main path's,
   and no session directory or worker process left after ``shutdown()``.
   ``overhead_pct`` sets the trainer's tokens/s beside the main path's, as
   ``bench.py`` does.
7. a ``kernels`` line, then the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Run from the root of a checkout: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

B, S = 16, 1024
WARMUP, TIMED, PROFILED = 3, 10, 2
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
KERNEL_SOURCE = "ray_tpu_torch/ops/csrc/flash_attention.cu"
# The source's __global__s, as substrings of the profiler's kernel names.
ATTENTION_KERNELS = ("fwd_kernel", "flash_fwd_wgmma", "flash_bwd_wgmma", "flash_bwd_dq_convert",
                     "bwd_dkdv", "bwd_dq")

# Tolerances. f32: those of tests/test_ops.py. bf16 forward: O 3e-2 (the
# tests' bf16 tolerance; p is rounded to bf16 against a running max in the
# kernel and against the final max in the plain version), lse 1e-4 (f32 from
# the same staged inputs, summed in another order). bf16 backward: each of dq,
# dk, dv on its own, relative Frobenius error ||a - b|| / ||b|| (both sides
# round the same f32 sums to bf16, in another order: 1.3e-4 at most on an H100
# at the main-path shape; a kernel that skipped one 64-key tile of the last 64
# rows is off by about 3e-2, which the kernel check shows on the card each run
# where S >= 128). A gradient that is zero in exact arithmetic (dq and dk at
# S = 1: the softmax over one key is constant) is held against 1e-3 of dv's
# norm instead of its own, which is rounding noise on both sides.
F32_FWD_TOL, F32_BWD_TOL = 2e-5, 5e-4
BF16_O_TOL, BF16_LSE_TOL, BF16_BWD_REL = 3e-2, 1e-4, 1e-3
# The main path's first step against plain attention (attention="xla") on the
# same weights and batch, bf16: the two round p and o to bf16 at different
# points. Loss absolute; global grad norm relative; each layer's qkv_w
# gradient as ||a - b|| / ||b|| and as the relative gap of its norm. At random
# init in bf16 that gradient is noisy whatever the attention's rounding (about
# 1e-2 apart against the kernels' own plain versions too, on an H100), so its
# limits catch gross errors; the kernel check above catches fine ones.
LOSS_TOL, GRAD_NORM_RTOL = 1e-3, 1e-3
QKV_GRAD_REL, QKV_NORM_RTOL = 3e-2, 5e-3
# The trainer phase's first loss against the main path's: same weights (seed
# 0), batch, kernels and flags, in another process.
TRAINER_FIRST_LOSS_TOL = 1e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, calls=20, reps=7):
    """Device time of one call of fn: CUDA events around `calls` back-to-back
    calls, so the host enqueues ahead of the card and its own time hides;
    the median over reps of the mean per call, after warmup."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(calls):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    return statistics.median(times)


def cuda_ms_one_call(fn, iters=30):
    """Median over iters of CUDA events around a single call on an idle
    stream: the card's time plus the host's time to enqueue the call (the
    method of the earlier figures in PERF.md, kept to compare with them)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def rel_err(a, b, floor=0.0):
    """||a - b|| / max(||b||, floor) in f32."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(floor)).item()


def kernel_name(mangled):
    """The readable name of a mangled kernel: the last component of its
    nested name, with its template argument (``flash_fwd_wgmma_kernel<64>``)."""
    import re

    i = mangled.find("_ZN")
    if i < 0:
        return mangled
    i, name = i + 3, mangled
    while i < len(mangled) and mangled[i].isdigit():  # <length><identifier> components
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    arg = re.match(r"ILi(\d+)E", mangled[i:])
    return f"{name}<{arg.group(1)}>" if arg else name


def ptxas_report(log):
    """Registers, shared memory and spill bytes per kernel from ``-Xptxas -v``."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            out.setdefault(name, {})
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_store_load_bytes"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(m.group(1)) if m else 0
    return out


def build_workload():
    """The main path's model, optimizer, state and batch: GPT-2 small at full
    width and depth (bf16 compute, save_attn remat), AdamW, weights from seed
    0 and one batch from numpy seed 0, on ``default_device()``."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import (
        GPTConfig,
        create_train_state,
        default_optimizer,
        shard_batch,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # every f32 comparison in full f32
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig.gpt2_small()  # 12 layers, d 768, 12 heads, vocab 50304, bf16, save_attn
    opt = default_optimizer(learning_rate=3e-4)
    state = create_train_state(cfg, 0, opt)
    rng = np.random.default_rng(0)
    batch = shard_batch(
        {"tokens": rng.integers(0, cfg.vocab_size - 1, (B, S + 1)).astype(np.int32)}
    )
    return cfg, opt, state, batch


def run_steps(cfg, opt, state, batch):
    """WARMUP + TIMED train steps, each timed between two
    ``torch.cuda.synchronize()``s, with the launch counts set to 0 first.
    Returns the state, the step function and a dict of losses, grad norms,
    step ms, each step's launches and the peak memory."""
    import torch

    from ray_tpu_torch.models import make_train_step
    from ray_tpu_torch.ops import launch_counts, reset_launch_counts

    step = make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, gnorms, step_ms, per_step = [], [], [], []
    for _ in range(WARMUP + TIMED):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
        after = launch_counts()
        per_step.append({name: after[name] - before[name] for name in after})
    timed = step_ms[WARMUP:]
    med_ms = statistics.median(timed)
    return state, step, {
        "losses": losses, "grad_norms": gnorms, "step_ms_timed": timed,
        "step_ms_median": med_ms, "tokens_per_s": B * S / (med_ms / 1e3),
        "step_ms_warmup": step_ms[:WARMUP],
        "launches_per_step": per_step, "launches": launch_counts(),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}


def profile_steps(step, state, batch, med_ms):
    """PROFILED more steps under ``torch.profiler``: device time per step by
    kernel, summed into attention kernels, GEMMs and the rest, and the idle
    share against the untraced median step ``med_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED
    events = prof.key_averages()
    per_step = {e.key: e.self_device_time_total / 1e3 / PROFILED
                for e in events if e.device_type == DeviceType.CUDA}
    # The same device time charged to the PyTorch op that launched it.
    by_op = {e.key: e.self_device_time_total / 1e3 / PROFILED
             for e in events if e.device_type == DeviceType.CPU and e.self_device_time_total > 0}
    groups = {"attention_kernels": 0.0, "gemm": 0.0, "other": 0.0}
    for name, ms in per_step.items():
        if any(s in name for s in ATTENTION_KERNELS):
            groups["attention_kernels"] += ms
        elif any(s in name.lower() for s in ("gemm", "nvjet", "cutlass", "xmma")):
            groups["gemm"] += ms
        else:
            groups["other"] += ms
    busy_ms = sum(groups.values())
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:8]
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    # Tracing slows the host, so idle is taken against the untraced median step.
    return {"steps": PROFILED, "traced_wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms, "device_idle_share": 1 - busy_ms / med_ms,
            "ms_per_step": groups, "top_kernels_ms_per_step": [[n[:90], t] for n, t in top],
            "top_ops_ms_per_step": [[n, t] for n, t in top_ops]}


def trainer_loop(config):
    """The per-worker loop of the trainer phase: the main path's workload in
    the worker process, reported through ``session.report`` with what the
    driver checks (the device the worker ran on, the kernel library it
    loaded, each step's launches)."""
    stamps = {"process_start": process_start_time(), "loop_start": time.time()}
    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.ops import _build

    stamps["torch_imported"] = time.time()
    lib = _build.library_path(_build.SOURCE)
    lib_before = os.stat(lib).st_mtime_ns if os.path.exists(lib) else None
    cfg, opt, state, batch = build_workload()
    stamps["workload_built"] = time.time()
    state, step, out = run_steps(cfg, opt, state, batch)
    stamps["steps_done"] = time.time()
    out["profile"] = profile_steps(step, state, batch, out["step_ms_median"])
    stamps["profile_done"] = time.time()
    out["stamps"] = stamps
    # A CUDA tensor in the report: the port's serializer lowers it to a CPU
    # tensor on its way to the driver.
    out["last_loss_tensor"] = torch.tensor(out["losses"][-1], device=state.params["wte"].device)
    # What shares the interpreter with the loop thread in the worker.
    out.update(threads=sorted(t.name for t in threading.enumerate()),
               loop_thread=threading.current_thread().name,
               profile_or_trace_hook=sys.getprofile() is not None or sys.gettrace() is not None)
    out.update(pid=os.getpid(), cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
               device=str(state.params["wte"].device), device_index=torch.cuda.current_device(),
               device_name=torch.cuda.get_device_name(), library=lib,
               library_mtime_ns_before=lib_before, library_mtime_ns_after=os.stat(lib).st_mtime_ns)
    session.report(out)


def process_start_time():
    """This process's start, in seconds since the epoch: its start in clock
    ticks after boot (/proc) against the time since boot now."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    return time.time() - age


def pid_alive(pid):
    """Whether process `pid` is alive (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def runtime_worker_pids():
    """Pids of the worker processes the running port runtime knows of."""
    import ray_tpu_torch

    return {w["pid"] for n in ray_tpu_torch.nodes() for w in n["workers"] if w["pid"]}


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ray_tpu_torch
    from ray_tpu_torch.models import GPTConfig, loss_fn, train_flops_per_token
    from ray_tpu_torch.models.training import tree_leaves
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.flash_attention import (
        _bwd_cuda,
        _bwd_plain,
        _delta,
        _fwd_cuda,
        _fwd_plain,
    )

    # ------------------------------------------------------------------ 1. device
    torch.backends.cuda.matmul.allow_tf32 = False  # every f32 comparison in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    card = ray_tpu_torch.device_kind()
    dev = ray_tpu_torch.default_device()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": card, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda, "allow_tf32": False})

    # ------------------------------------------------------------------ 2. build
    seconds = _build.build()
    with open(_build.library_path(_build.SOURCE) + ".log") as f:
        ptxas = ptxas_report(f.read())
    emit({"phase": "build", "seconds": seconds, "source": KERNEL_SOURCE, "ptxas": ptxas})

    # ------------------------------------------------------------------ 3. kernels against plain
    def inputs(shape, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(4)]

    def check(case, shape, dtype, causal, seed):
        q, k, v, do = inputs(shape, dtype, seed)
        scale = shape[-1] ** -0.5
        o, lse = _fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = _fwd_plain(q, k, v, causal, scale)
        grads = _bwd_cuda(q, k, v, do, lse, _delta(o, do), causal, scale)
        torch.cuda.synchronize()
        grads_ref = _bwd_plain(q, k, v, o, lse, do, causal, scale)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        err_g = [(a.float() - b.float()).abs().max().item() for a, b in zip(grads, grads_ref)]
        floor = 1e-3 * grads_ref[2].float().norm()  # dv's: see the tolerances above
        rel_g = [rel_err(a, b, floor) for a, b in zip(grads, grads_ref)]
        line = {"phase": "kernel_check", "case": case, "shape": list(shape), "dtype": str(dtype),
                "causal": causal, "err_o": err_o, "err_lse": err_lse, "err_dq_dk_dv": err_g,
                "rel_err_dq_dk_dv": rel_g, "ref_max_abs_dq_dk_dv":
                [b.float().abs().max().item() for b in grads_ref]}
        if dtype == torch.float32:
            line["tol_o_lse_grads"] = [F32_FWD_TOL, F32_FWD_TOL, F32_BWD_TOL]
            ok = err_o <= F32_FWD_TOL and err_lse <= F32_FWD_TOL and max(err_g) <= F32_BWD_TOL
        else:
            if shape[1] >= 128:
                # The limit must catch a kernel that skips one 64-key tile (keys
                # 0-63) of the last 64 query rows: the plain backward of that
                # block alone, taken off the reference, is what such a kernel gives.
                r, t = slice(shape[1] - 64, None), slice(0, 64)
                part = _bwd_plain(q[:, r], k[:, t], v[:, t], o[:, r], lse[:, r], do[:, r], False,
                                  scale)
                dropped = [g.clone() for g in grads_ref]
                for g, rows, p in zip(dropped, (r, t, t), part):
                    g[:, rows] = (g[:, rows].float() - p.float()).to(dtype)
                rel_dropped = [rel_err(a, b) for a, b in zip(dropped, grads_ref)]
                line["rel_err_tile_dropped"] = rel_dropped
                require(max(rel_dropped) > BF16_BWD_REL,
                        f"{case}: the bf16 backward limit would pass a skipped tile {rel_dropped}")
            line["tol_o_lse_grads_rel"] = [BF16_O_TOL, BF16_LSE_TOL, BF16_BWD_REL]
            ok = err_o <= BF16_O_TOL and err_lse <= BF16_LSE_TOL and max(rel_g) <= BF16_BWD_REL
        line["ok"] = ok
        emit(line)
        require(ok, f"kernel disagrees with its plain version: {case}")
        return err_o, max(err_g)

    bh = B * GPTConfig.gpt2_small().n_head
    hd = GPTConfig.gpt2_small().head_dim
    main_err = check("main path bf16 causal", (bh, S, hd), torch.bfloat16, True, seed=0)
    check("f32 causal", (4, 256, 64), torch.float32, True, seed=1)
    check("f32 non-causal", (4, 256, 64), torch.float32, False, seed=2)
    check("f32 ragged S=1000 causal", (4, 1000, 64), torch.float32, True, seed=3)
    check("bf16 ragged S=1000 causal", (24, 1000, 64), torch.bfloat16, True, seed=4)
    check("f32 ragged S=1000 d=128 non-causal", (2, 1000, 128), torch.float32, False, seed=5)
    check("bf16 ragged S=1000 d=128 non-causal", (8, 1000, 128), torch.bfloat16, False, seed=8)
    check("bf16 ragged S=1000 d=128 causal", (8, 1000, 128), torch.bfloat16, True, seed=9)
    check("bf16 S=1 causal", (4, 1, 64), torch.bfloat16, True, seed=10)
    check("bf16 S=100 causal", (8, 100, 64), torch.bfloat16, True, seed=11)

    q, k, v, do = inputs((bh, S, hd), torch.bfloat16, seed=7)
    scale = hd ** -0.5
    o, lse = _fwd_cuda(q, k, v, True, scale)
    delta = _delta(o, do)
    # The backward twice on the same inputs: dq's f32 sum is added across K
    # tiles in no fixed order, dk and dv are summed in a fixed one.
    runs = [_bwd_cuda(q, k, v, do, lse, delta, True, scale) for _ in range(2)]
    torch.cuda.synchronize()
    rerun = {"phase": "bwd_rerun", "shape": [bh, S, hd],
             "dq_max_abs_diff": (runs[0][0].float() - runs[1][0].float()).abs().max().item(),
             "dq_elements_differing": int((runs[0][0] != runs[1][0]).sum().item()),
             "dq_max_abs": runs[0][0].float().abs().max().item(),
             "dk_identical": bool(torch.equal(runs[0][1], runs[1][1])),
             "dv_identical": bool(torch.equal(runs[0][2], runs[1][2]))}
    emit(rerun)
    require(rerun["dk_identical"] and rerun["dv_identical"], "dk or dv differ between two runs")
    del runs
    fwd = lambda: _fwd_cuda(q, k, v, True, scale)  # noqa: E731
    bwd = lambda: _bwd_cuda(q, k, v, do, lse, delta, True, scale)  # noqa: E731
    fwd_ms, bwd_ms = cuda_ms(fwd), cuda_ms(bwd)
    fwd_plain_ms = cuda_ms(lambda: _fwd_plain(q, k, v, True, scale), calls=3)
    bwd_plain_ms = cuda_ms(lambda: _bwd_plain(q, k, v, o, lse, do, True, scale), calls=3)
    q4, k4, v4 = (t.view(B, -1, S, hd).detach().requires_grad_() for t in (q, k, v))
    do4 = do.view(B, -1, S, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    o4 = sdpa(q4, k4, v4, is_causal=True)

    def lib_fwd():
        with torch.no_grad():
            sdpa(q4, k4, v4, is_causal=True)

    lib_bwd = lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)  # noqa: E731
    lib_fwd_ms, lib_bwd_ms = cuda_ms(lib_fwd), cuda_ms(lib_bwd)
    one_call = {"flash_fwd_ms": cuda_ms_one_call(fwd), "sdpa_fwd_ms": cuda_ms_one_call(lib_fwd),
                "flash_bwd_ms": cuda_ms_one_call(bwd), "sdpa_bwd_ms": cuda_ms_one_call(lib_bwd)}
    del o4, q4, k4, v4, do4

    pairs = bh * S * (S + 1) / 2  # causal (query, key) pairs this run computes
    elt = 2  # bf16 bytes
    fwd_bound = bound(2 * 2 * hd * pairs, 4 * bh * S * hd * elt + bh * S * 4)
    bwd_bound = bound(5 * 2 * hd * pairs, 7 * bh * S * hd * elt + 2 * bh * S * 4)
    emit({"phase": "kernel_times", "shape": [bh, S, hd], "dtype": "bfloat16", "causal": True,
          "card": smi, "flash_fwd_ms": fwd_ms, "flash_fwd_plain_ms": fwd_plain_ms,
          "flash_fwd_bound_ms": fwd_bound[0], "sdpa_fwd_ms": lib_fwd_ms,
          "flash_fwd_over_sdpa": fwd_ms / lib_fwd_ms,
          "flash_bwd_ms": bwd_ms, "flash_bwd_plain_ms": bwd_plain_ms,
          "flash_bwd_bound_ms": bwd_bound[0], "sdpa_bwd_ms": lib_bwd_ms,
          "flash_bwd_over_sdpa": bwd_ms / lib_bwd_ms,
          "timing": "device time per call: events around 20 back-to-back calls, median of 7",
          "one_call": one_call,
          "one_call_timing": "events around one call on an idle stream, median of 30: "
                             "device time plus the host's enqueue"})
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 4. main path
    cfg, opt, state, batch = build_workload()

    # The first step's loss and gradients on the initial weights, through the
    # kernels and through plain attention, before the train step updates them.
    leaves = tree_leaves(state.params)
    qkv_i = next(i for i, t in enumerate(leaves) if t is state.params["blocks"]["qkv_w"])

    def loss_and_grads(config):
        loss = loss_fn(state.params, batch, config)
        grads = torch.autograd.grad(loss, leaves)
        gnorm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
        return loss.item(), gnorm.item(), grads[qkv_i]

    qkv_grad = loss_and_grads(cfg)[2]
    ref_loss, ref_gnorm, ref_qkv_grad = loss_and_grads(dataclasses.replace(cfg, attention="xla"))
    qkv_rel = [rel_err(a, b) for a, b in zip(qkv_grad, ref_qkv_grad)]  # per layer
    qkv_norm_rel = [abs(a.norm().item() / b.norm().item() - 1)
                    for a, b in zip(qkv_grad, ref_qkv_grad)]
    del qkv_grad, ref_qkv_grad
    torch.cuda.empty_cache()

    state, step, run = run_steps(cfg, opt, state, batch)
    losses, gnorms, launches = run["losses"], run["grad_norms"], run["launches"]
    for i, per_step in enumerate(run["launches_per_step"]):
        require(all(n == cfg.n_layer for n in per_step.values()),
                f"step {i}: kernel launches {per_step}, expected {cfg.n_layer} each")
    require(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    loss_err = abs(losses[0] - ref_loss)
    gnorm_rel = abs(gnorms[0] - ref_gnorm) / ref_gnorm
    med_ms, tokens_per_s = run["step_ms_median"], run["tokens_per_s"]
    flops_per_token = train_flops_per_token(cfg, S)
    emit({"phase": "main_path", "model": "gpt2_small", "batch": B, "seq": S,
          "dtype": "bfloat16", "remat_policy": cfg.remat_policy, "steps": len(losses),
          "losses": losses, "grad_norms": gnorms,
          "plain_attention_first_loss": ref_loss, "plain_attention_first_grad_norm": ref_gnorm,
          "first_loss_abs_err": loss_err, "first_grad_norm_rel_err": gnorm_rel,
          "first_qkv_w_grad_rel_err_per_layer": qkv_rel,
          "first_qkv_w_grad_norm_rel_err_per_layer": qkv_norm_rel,
          "step_ms_warmup": run["step_ms_warmup"],
          "step_ms_timed": run["step_ms_timed"], "step_ms_median": med_ms,
          "tokens_per_s": tokens_per_s, "train_flops_per_token": flops_per_token,
          "mfu": flops_per_token * tokens_per_s / PEAK_BF16_FLOPS,
          "mfu_peak": "989 TFLOP/s, H100 SXM dense bf16", "card": smi,
          "peak_memory_gib": run["peak_memory_gib"], "launches": launches})
    require(loss_err <= LOSS_TOL, f"first loss {losses[0]} vs plain attention {ref_loss}")
    require(gnorm_rel <= GRAD_NORM_RTOL,
            f"first grad norm {gnorms[0]} vs plain attention {ref_gnorm}")
    require(max(qkv_rel) <= QKV_GRAD_REL and max(qkv_norm_rel) <= QKV_NORM_RTOL,
            f"qkv_w gradient vs plain attention, per layer: {qkv_rel}, norms {qkv_norm_rel}")

    steps = WARMUP + TIMED
    require(launches == {"flash_fwd": cfg.n_layer * steps, "flash_bwd": cfg.n_layer * steps},
            f"launches {launches}")

    # ------------------------------------------------------------------ 5. where the time goes
    # Two more steps under torch.profiler, after the counts were read.
    emit({"phase": "profile", **profile_steps(step, state, batch, med_ms)})

    # ------------------------------------------------------------------ 6. trainer
    # The driver's GPU memory goes first: the worker shares the one card.
    del state, step, batch, leaves
    torch.cuda.empty_cache()
    driver_reserved = torch.cuda.memory_reserved()
    lib = _build.library_path(_build.SOURCE)
    lib_mtime = os.stat(lib).st_mtime_ns

    import ray_tpu_torch.train.torch as rt_torch
    from ray_tpu_torch.air import RunConfig, ScalingConfig

    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4)
    init_s = time.perf_counter() - t0
    session_dir = ray_tpu_torch._private.worker.global_worker.session_dir
    node_resources = ray_tpu_torch.cluster_resources()
    run_pids = runtime_worker_pids()  # this run's workers, checked after shutdown
    trainer = rt_torch.TorchTrainer(
        trainer_loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="chip_smoke_trainer",
                             storage_path=os.path.join(session_dir, "results")),
    )
    t0, fit_wall0 = time.perf_counter(), time.time()
    try:
        result = trainer.fit()
        error = result.error
    except Exception as e:  # printed with the workers' logs, then raised
        error = e
    if error is not None:
        for log in sorted(glob.glob(os.path.join(session_dir, "logs", "worker-*.log"))):
            with open(log, errors="replace") as f:
                print(f"--- {log} (tail)\n" + "".join(f.readlines()[-40:]), file=sys.stderr)
        raise error
    fit_s, fit_wall1 = time.perf_counter() - t0, time.time()
    run_pids |= runtime_worker_pids() | {result.metrics["pid"]}
    t0 = time.perf_counter()
    ray_tpu_torch.shutdown()
    shutdown_s = time.perf_counter() - t0
    w = result.metrics
    st = w["stamps"]
    fit_split_s = {"to_worker_process_start": st["process_start"] - fit_wall0,
                   "worker_process_to_loop": st["loop_start"] - st["process_start"],
                   "import_torch": st["torch_imported"] - st["loop_start"],
                   "build_workload": st["workload_built"] - st["torch_imported"],
                   "steps": st["steps_done"] - st["workload_built"],
                   "profiled_steps": st["profile_done"] - st["steps_done"],
                   "report_and_teardown": fit_wall1 - st["profile_done"]}
    loss_tensor = w["last_loss_tensor"]
    leftover_dirs = [session_dir] if os.path.exists(session_dir) else []
    leftover_pids = sorted(pid for pid in run_pids if pid_alive(pid))
    t_losses, t_launches = w["losses"], w["launches"]
    t_tokens_per_s = w["tokens_per_s"]
    t_loss_err = abs(t_losses[0] - losses[0])
    emit({"phase": "trainer", "entry": "TorchTrainer.fit", "num_workers": 1, "use_gpu": True,
          "node_resources": node_resources, "driver_memory_reserved_bytes": driver_reserved,
          "worker_pid": w["pid"], "worker_cuda_visible_devices": w["cuda_visible_devices"],
          "worker_device": w["device"], "worker_device_index": w["device_index"],
          "worker_device_name": w["device_name"], "worker_library": w["library"],
          "worker_loaded_the_built_library": w["library_mtime_ns_before"] == lib_mtime,
          "steps": len(t_losses), "losses": t_losses, "grad_norms": w["grad_norms"],
          "first_loss_abs_err_vs_main_path": t_loss_err,
          "step_ms_warmup": w["step_ms_warmup"],
          "step_ms_timed": w["step_ms_timed"], "step_ms_median": w["step_ms_median"],
          "worker_threads": w["threads"], "worker_loop_thread": w["loop_thread"],
          "worker_profile_or_trace_hook": w["profile_or_trace_hook"],
          "tokens_per_s": t_tokens_per_s,
          "mfu": flops_per_token * t_tokens_per_s / PEAK_BF16_FLOPS,
          "mfu_peak": "989 TFLOP/s, H100 SXM dense bf16",
          "launches_per_step": w["launches_per_step"], "launches": t_launches,
          "peak_memory_gib": w["peak_memory_gib"], "profile": w["profile"],
          "init_s": init_s, "fit_s": fit_s, "fit_split_s": fit_split_s,
          "shutdown_s": shutdown_s,
          "reported_cuda_tensor_arrived_on": str(loss_tensor.device),
          "main_path_tokens_per_s": tokens_per_s,
          "overhead_pct": (tokens_per_s - t_tokens_per_s) / tokens_per_s * 100,
          "run_worker_pids": sorted(run_pids), "leftover_session_dirs": leftover_dirs,
          "leftover_worker_pids": leftover_pids,
          "card": smi})
    require(node_resources.get("GPU") == 1, f"node resources {node_resources}: expected GPU: 1")
    visible = w["cuda_visible_devices"]
    require(visible is not None and len(visible.split(",")) == 1 and visible.strip(),
            f"worker CUDA_VISIBLE_DEVICES {visible!r}: expected one id")
    require(w["device"].startswith("cuda"), f"worker trained on {w['device']}")
    require(loss_tensor.device.type == "cpu" and loss_tensor.item() == t_losses[-1],
            f"a reported CUDA tensor arrived as {loss_tensor!r}")
    require(w["library_mtime_ns_before"] == lib_mtime == w["library_mtime_ns_after"],
            "the worker did not load the kernel library the build phase built")
    for i, per_step in enumerate(w["launches_per_step"]):
        require(all(n == cfg.n_layer for n in per_step.values()) and len(per_step) == 2,
                f"trainer step {i}: kernel launches {per_step}, expected {cfg.n_layer} each")
    require(all(math.isfinite(x) for x in t_losses), f"trainer: non-finite loss: {t_losses}")
    require(t_losses[-1] < t_losses[0], f"trainer: loss did not fall: {t_losses}")
    require(t_loss_err <= TRAINER_FIRST_LOSS_TOL,
            f"trainer first loss {t_losses[0]} vs main path {losses[0]}")
    require(not leftover_dirs, f"session directories left after shutdown: {leftover_dirs}")
    require(not leftover_pids, f"worker processes alive after shutdown: {leftover_pids}")

    # ------------------------------------------------------------------ 7. result
    launches_per_path = {name: {"main_path": launches[name], "trainer": t_launches[name]}
                         for name in launches}
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "ray_tpu/ops/flash_attention.py:59", "launches": launches["flash_fwd"],
         "launches_per_path": launches_per_path["flash_fwd"],
         "max_abs_err": main_err[0], "ms": fwd_ms, "plain_ms": fwd_plain_ms,
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": lib_fwd_ms,
         "ms_over_library_ms": fwd_ms / lib_fwd_ms, "ms_one_call": one_call["flash_fwd_ms"],
         "library_ms_one_call": one_call["sdpa_fwd_ms"]},
        {"name": "flash_bwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "ray_tpu/ops/flash_attention.py:160", "launches": launches["flash_bwd"],
         "launches_per_path": launches_per_path["flash_bwd"],
         "max_abs_err": main_err[1], "ms": bwd_ms, "plain_ms": bwd_plain_ms,
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "library_ms": lib_bwd_ms,
         "ms_over_library_ms": bwd_ms / lib_bwd_ms, "ms_one_call": one_call["flash_bwd_ms"],
         "library_ms_one_call": one_call["sdpa_bwd_ms"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
