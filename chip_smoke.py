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
6. a ``kernels`` line, then the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Run from the root of a checkout: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
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


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.models import (
        GPTConfig,
        create_train_state,
        default_optimizer,
        loss_fn,
        make_train_step,
        shard_batch,
        train_flops_per_token,
    )
    from ray_tpu_torch.models.training import tree_leaves
    from ray_tpu_torch.ops import _build, launch_counts, reset_launch_counts
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
    cfg = GPTConfig.gpt2_small()  # 12 layers, d 768, 12 heads, vocab 50304, bf16, save_attn
    opt = default_optimizer(learning_rate=3e-4)
    state = create_train_state(cfg, 0, opt)
    rng = np.random.default_rng(0)
    batch = shard_batch(
        {"tokens": rng.integers(0, cfg.vocab_size - 1, (B, S + 1)).astype(np.int32)}
    )

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

    step = make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, gnorms, step_ms = [], [], []
    for i in range(WARMUP + TIMED):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
        after = launch_counts()
        per_step = {name: after[name] - before[name] for name in after}
        require(all(n == cfg.n_layer for n in per_step.values()),
                f"step {i}: kernel launches {per_step}, expected {cfg.n_layer} each")
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    require(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    loss_err = abs(losses[0] - ref_loss)
    gnorm_rel = abs(gnorms[0] - ref_gnorm) / ref_gnorm
    timed = step_ms[WARMUP:]
    med_ms = statistics.median(timed)
    tokens_per_s = B * S / (med_ms / 1e3)
    flops_per_token = train_flops_per_token(cfg, S)
    emit({"phase": "main_path", "model": "gpt2_small", "batch": B, "seq": S,
          "dtype": "bfloat16", "remat_policy": cfg.remat_policy, "steps": len(losses),
          "losses": losses, "grad_norms": gnorms,
          "plain_attention_first_loss": ref_loss, "plain_attention_first_grad_norm": ref_gnorm,
          "first_loss_abs_err": loss_err, "first_grad_norm_rel_err": gnorm_rel,
          "first_qkv_w_grad_rel_err_per_layer": qkv_rel,
          "first_qkv_w_grad_norm_rel_err_per_layer": qkv_norm_rel,
          "step_ms_timed": timed, "step_ms_median": med_ms, "tokens_per_s": tokens_per_s,
          "train_flops_per_token": flops_per_token,
          "mfu": flops_per_token * tokens_per_s / PEAK_BF16_FLOPS,
          "mfu_peak": "989 TFLOP/s, H100 SXM dense bf16", "card": smi,
          "peak_memory_gib": peak_gib, "launches": launches})
    require(loss_err <= LOSS_TOL, f"first loss {losses[0]} vs plain attention {ref_loss}")
    require(gnorm_rel <= GRAD_NORM_RTOL,
            f"first grad norm {gnorms[0]} vs plain attention {ref_gnorm}")
    require(max(qkv_rel) <= QKV_GRAD_REL and max(qkv_norm_rel) <= QKV_NORM_RTOL,
            f"qkv_w gradient vs plain attention, per layer: {qkv_rel}, norms {qkv_norm_rel}")

    steps = WARMUP + TIMED
    require(launches == {"flash_fwd": cfg.n_layer * steps, "flash_bwd": cfg.n_layer * steps},
            f"launches {launches}")

    # ------------------------------------------------------------------ 5. where the time goes
    # Two more steps under torch.profiler, after the counts were read: device
    # time per step by kernel, summed into attention kernels, GEMMs and the rest.
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
    emit({"phase": "profile", "steps": PROFILED, "traced_wall_ms_per_step": wall_ms,
          "device_busy_ms_per_step": busy_ms, "device_idle_share": 1 - busy_ms / med_ms,
          "ms_per_step": groups, "top_kernels_ms_per_step": [[n[:90], t] for n, t in top],
          "top_ops_ms_per_step": [[n, t] for n, t in top_ops]})

    # ------------------------------------------------------------------ 6. result
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "ray_tpu/ops/flash_attention.py:59", "launches": launches["flash_fwd"],
         "max_abs_err": main_err[0], "ms": fwd_ms, "plain_ms": fwd_plain_ms,
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": lib_fwd_ms,
         "ms_over_library_ms": fwd_ms / lib_fwd_ms, "ms_one_call": one_call["flash_fwd_ms"],
         "library_ms_one_call": one_call["sdpa_fwd_ms"]},
        {"name": "flash_bwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "ray_tpu/ops/flash_attention.py:160", "launches": launches["flash_bwd"],
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
