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
6b. collectives and the mesh: ``collective_nccl``, every op of
   ``ray_tpu_torch.util.collective`` on a world-1 NCCL group over CUDA
   tensors, f32 and bf16, each result checked and on ``cuda:0``; then
   ``mesh_gang``, GPT-2 small at full width and depth through
   ``TorchTrainer`` with ``ScalingConfig(num_workers=2, use_gpu=True,
   gpus_per_worker=0.5, mesh={"data": 2})`` over gloo (NCCL refuses two ranks
   on one GPU), global B 16 x S 1024 (8 rows per rank), the main path's
   weights and batch: ``get_mesh()`` is a ``DeviceMesh`` with the six axis
   names, the first loss within 1e-3 and grad norm within 1e-3 relative of
   the main path's, 12 launches of each kernel per step on each rank, the
   node's ``GPU`` 1.0 with 0.0 free during the fit, nothing left after
   ``shutdown()``; step ms per rank, collective ms and peak memory printed.
6c. pipeline and context: ``ring_check``, the ring's block loop and merge
   (``parallel/ring_attention.py``: ``ring_forward``/``ring_backward`` over a
   ``VirtualRing``, the distributed ring's code minus the sends) over C
   slices of one sequence at Llama 3 8B's attention (bh 32, S 8192, d 128, C
   4), GPT-2 small's (bh 192, S 1024, d 64, C 2) in bf16 and one f32 case:
   output and the three gradients against the plain ring (f32 einsums,
   autograd) and one full-sequence kernel call, and the block kernels'
   summed device time beside the full call's; then ``pipe_ctx_gang``, the
   main path's workload through ``TorchTrainer`` with two 0.5-GPU ranks
   over gloo on ``{"pipeline": 2}`` (GPipe, M 4) and on ``{"context": 2}``
   (the ring, s_local 512): first loss and grad norm against the main
   path's within mesh_gang's limits, each rank's launches per step (24 + 24
   a stage; 12 + 12 and 24 + 24 on context ranks 0 and 1), peak memory, and
   nothing left after ``shutdown()``.
7. the Llama shape: both bf16 kernels at Llama 3 8B's attention (bh 32,
   S 8192, d 128, causal) against their plain versions
   (``kernel_check_llama``), and their times beside the bounds, the plain
   versions' and SDPA's (``kernel_times_llama``).
8. the model zoo, each through ``create_train_state`` -> ``make_train_step``
   for 8 steps with AdamW, weights from seed 0 and one batch from numpy seed
   0, each step's launches counted from 0, then two profiled steps:
   ``llama``: ``LlamaConfig.llama3_8b()`` cut to 4 layers, full width, B 1 x S 8192,
   4 launches of each kernel per step, the first loss within 1e-3 of plain
   attention's and near its value at init; ``moe``: GPT-2 small with 8 Switch
   experts per block, B 16 x S 1024, 12 launches of each kernel per step, the
   first loss against plain attention's, the aux loss and the share of tokens
   over capacity; ``resnet50``: B 128 random 224 x 224 images, the first loss
   against the same forward in f32.
   ``remat_dots``: the main path's workload under ``remat_policy="dots"``,
   4 steps, the forward kernel launched twice per layer per step (once in
   the backward's recompute), the first loss and grad norm against the main
   path's.
8b. the rest of the mesh: ``expert_tp_gang``, the moe phase's MoE GPT-2
   through ``TorchTrainer`` on ``{"expert": 2}`` (two 0.5-GPU ranks over
   gloo, 4 experts a rank, the batch replicated), its first loss and grad
   norm against the moe phase's within mesh_gang's limits and 12 + 12
   launches a rank a step, then ResNet-50 on ``{"tensor": 2}`` at B 8
   against one rank's first step; ``elastic_reshard``, GPT-2 small (f32)
   under ``ScalingConfig(num_workers=2, elastic=True)``, each rank stashing
   its ``shard_for_rank`` of the params and Adam moments every step
   (``stash_checkpoint(rules=)``), rank 1 killed after round 3 by a
   ``PreemptionSimulator``: the gang re-forms at world 1 from the in-memory
   mirrors, the gathered state goes back on the card (``device_put_tree``)
   equal bit for bit to what both ranks held, and the final loss equals an
   uninterrupted one-rank run's within 1e-5.
9. RLlib (``ray_tpu_torch.rllib``), on a numpy ``CartPole-v1`` (no
   gymnasium on this path): ``rl_learner_check``, a ``TorchLearner`` on the
   card against one on the CPU from the same weights and minibatches, 10
   updates each of PPO's, DQN's (double Q) and C51's loss, and each one's
   host ms, device busy time, kernels and copies per update;
   ``rl_mesh_learner``, two ``TorchLearner(mesh=)`` ranks on ``{"data":
   2}`` (each half of every minibatch's rows) against one on the whole
   minibatches, PPO's and DQN's 10 updates, DQN's also with importance
   weights; then on one
   runtime (``init(num_cpus=4)``) ``ppo`` (12 ``train()`` iterations of the
   JAX test's configuration, learner on the card, two runners on CPU actors;
   best return > first + 30), ``dqn`` (until best return >= 60, at most 25
   iterations) and ``ppo_two_learners`` (two remote learners holding 0.5 GPU
   each, weights equal after each round), and ``rl_shutdown`` (nothing left
   after ``shutdown()``, no attention kernel launched by these phases).
10. a ``kernels`` line (launches per path: ``KERNEL_PATHS``, rank 0's on a
   gang; times at the Llama shape and of the ring's blocks with one SDPA
   call on the whole sequence beside them), checked for the keys the
   contract names,
   then the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Run from the root of a checkout: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import glob
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

from typing import Any, Dict, Optional

import numpy as np

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

# The model zoo's phases. Llama 3 8B at full width with its depth cut to 4 of
# 32 layers (one card's memory: 1.92 B params at 16 bytes each with AdamW),
# B 1 x S 8192; GPT-2 small with 8 Switch experts and ResNet-50 at their
# full sizes. Each trains ZOO_WARMUP + ZOO_TIMED steps.
LLAMA_LAYERS, LLAMA_B, LLAMA_S = 4, 1, 8192
MOE_EXPERTS, RESNET_B = 8, 128
ZOO_WARMUP, ZOO_TIMED = 2, 6
# Llama's first loss against init_loss_expected: the mean over 8192 tokens of
# a target logit whose std is 0.02 * sqrt(4096) = 1.28 varies by about 0.014.
INIT_LOSS_TOL = 0.1
# ResNet-50's first loss (bf16) against the same forward in f32 (the tests'
# bf16 loss tolerance), and against ln 1000: the head's normal(0.01) init
# over pooled features whose squared norm is a few thousand puts the expected
# loss about 0.2 above ln 1000, and the batch's target logits add about 0.06.
RESNET_F32_LOSS_TOL, RESNET_INIT_LOSS_TOL = 2e-2, 0.5
# The remat_dots phase: the main path's workload under remat_policy="dots",
# 1 warmup and DOTS_TIMED timed steps; its first loss and grad norm are held
# to the main path's with the trainer's and the main path's limits.
DOTS_TIMED = 3
# The mesh_gang phase: 1 warmup and MESH_GANG_TIMED timed steps on each rank.
MESH_GANG_TIMED = 3
# The ring_check phase: the ring's block loop and merge over C virtual slices
# of one sequence (ring_attention.VirtualRing), causal, at (name, bh, S, d, C,
# dtype): Llama 3 8B's attention, GPT-2 small's (its past block is the bf16
# non-causal kernel at d 64), and one f32 case. Each is held against the
# plain ring (f32 einsums, autograd) and one full-sequence kernel call.
# bf16: o, dq, dk, dv as ||a - b|| / ||b|| within RING_BF16_REL. The ring
# rounds each block's o (and each block's dq, dk, dv) to bf16 before the f32
# merge (sum), then rounds the result once more: up to C + 1 roundings of
# relative size 2^-9 where the full call rounds once, about 2.5e-3 at C 4;
# against the plain ring the kernels' bf16 p and ds add about as much. A
# dropped or misplaced block moves these by 1e-1 or more. lse (f32, against
# the full call) within RING_LSE_TOL: the same logsumexp summed in another
# order. f32: the kernel check's limits (F32_FWD_TOL, F32_BWD_TOL), abs.
RING_CASES = (("llama3_8b", 32, 8192, 128, 4, "bfloat16"),
              ("gpt2_small", 192, 1024, 64, 2, "bfloat16"),
              ("f32", 8, 2048, 64, 4, "float32"))
RING_BF16_REL, RING_LSE_TOL = 1e-2, 1e-4
# The pipe_ctx_gang phase: the main path's workload through TorchTrainer on
# {pipeline 2} (M 4: 4-row microbatches, 6 layers a stage) and {context 2}
# (s_local 512), two 0.5-GPU ranks over gloo, 1 warmup and PIPE_CTX_TIMED
# timed steps. Its first loss and grad norm are held to the main path's
# with mesh_gang's limits (LOSS_TOL, GRAD_NORM_RTOL): a pipeline changes no
# arithmetic inside a microbatch (the loss becomes a mean of 4 means and the
# gradients a sum of 4 parts, in f32); the ring rounds each block's o to bf16
# before the merge, one more rounding of relative size 2^-9 than the main
# path's, of the size by which the main path and plain attention differ
# (held to the same limits in main_path).
PIPE_CTX_TIMED = 2
# The expert_tp_gang phase: the moe phase's model and batch (GPT-2 small, 8
# Switch experts, B 16 x S 1024, bf16) through TorchTrainer on {expert 2}, two
# 0.5-GPU ranks over gloo, each holding 4 experts a layer and the whole batch
# (the batch is replicated over expert), 1 warmup and EXPERT_GANG_TIMED timed
# steps. Its first loss and grad norm are held to the moe phase's with
# mesh_gang's limits (LOSS_TOL, GRAD_NORM_RTOL): top-1 routing gives each
# token's combine one nonzero term, so the f32 sum across the expert group
# adds zeros, and every product runs on the same rows. {expert 2, tensor 2}
# needs four ranks, each holding the whole batch's activations, which do not
# fit one card four times: tools/port_multichip.py runs it. Then ResNet-50 on
# {tensor 2} at B RESNET_TP_B (gloo carries every activation gather through
# the host), held to one rank's first step on the same weights and images
# with the same limits (each rank computes its output channels' products
# whole; the classes' logsumexp is summed across the two).
EXPERT_GANG_TIMED, RESNET_TP_B = 2, 8
# The elastic_reshard phase: GPT-2 small in f32 compute, ELASTIC_B rows of S
# 1024 a step, under ScalingConfig(num_workers=2, elastic=True) (two 0.5-GPU
# ranks over gloo, {data 2}); each step every rank stashes its shard of the
# params and Adam moments under ELASTIC_RULES (the large matrices split on
# dim 0, the rest replicated), and a PreemptionSimulator kills rank 1 after
# round ELASTIC_KILL_ROUND of ELASTIC_STEPS. f32 compute: its kernels and
# products are deterministic (the bf16 backward's dq is not, PERF.md), so the
# resumed state can be held bit for bit to what both ranks held, and the final
# loss to an uninterrupted one-rank run's within ELASTIC_LOSS_RTOL (the
# data-parallel steps sum the gradients' f32 parts in another order).
ELASTIC_STEPS, ELASTIC_KILL_ROUND, ELASTIC_B = 6, 3, 8
ELASTIC_RULES = [(r"(wte|wpe|qkv_w|out_w|fc_w|proj_w)$", ("data",)), (".*", ())]
ELASTIC_LOSS_RTOL = 1e-5
# A resized gang fetches every survivor's stash and mirrors (GPT-2 small's
# f32 params and moments are 1.5 GB, half a rank's shard, up to 5 steps of
# each): the phase's runtime holds them in a larger object store and waits
# longer for each fetch than the defaults (2 GiB, 5 s) allow. The killed
# rank's GPU share is free again at once (the process died, not the card),
# so the gang would grow back after the default 30 s: these phases measure
# a shrink, and wait an hour before a grow.
ELASTIC_SYSTEM_CONFIG = {"object_store_memory": 16 << 30, "elastic_probe_timeout_s": 120.0,
                         "elastic_grow_after_s": 3600.0}
# The rl_mesh_learner phase: two TorchLearners on {data 2} (0.5-GPU ranks over
# gloo), each taking half of every rl_learner_check minibatch's rows, held to
# one TorchLearner on the whole minibatch with rl_learner_check's limits
# (RL_TOL, RL_PARAM_TOL): the gradients are the mean of the halves' (one f32
# all-reduce), equal for PPO's per-row means; DQN's weighted mean takes the
# whole batch's weight sums (learner.batch_sum), held with the all-ones
# weights of true final observations and with importance weights that
# differ between the halves (dqn_weighted).
RL_MESH_KINDS = ("ppo", "dqn", "dqn_weighted")


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


def device_sync(device):
    """Wait for the work queued on ``device``: a card's (the CPU runs each
    op to its end)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak_memory(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_memory_gib(device):
    """``max_memory_allocated`` in GiB on a card; 0 on the CPU (not measured)."""
    import torch

    return torch.cuda.max_memory_allocated() / 2**30 if torch.device(device).type == "cuda" else 0.0


def run_steps(cfg, opt, state, batch, warmup=WARMUP, timed=TIMED, items=B * S, mesh=None):
    """``warmup`` + ``timed`` train steps, each timed between two
    ``device_sync``s, with the launch counts set to 0 first.
    Returns the state, the step function and a dict of losses, grad norms,
    step ms, ``items`` (tokens or images per step) per second, each step's
    launches and the peak memory. With a ``mesh``, this rank's part of a
    sharded step (``items`` this rank's share)."""
    from ray_tpu_torch.models import make_train_step
    from ray_tpu_torch.models.training import tree_leaves
    from ray_tpu_torch.ops import launch_counts, reset_launch_counts

    device = tree_leaves(state.params)[0].device
    step = make_train_step(cfg, opt, mesh=mesh)
    reset_peak_memory(device)
    reset_launch_counts()
    losses, gnorms, step_ms, per_step = [], [], [], []
    for _ in range(warmup + timed):
        before = launch_counts()
        device_sync(device)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        device_sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
        after = launch_counts()
        per_step.append({name: after[name] - before[name] for name in after})
    med_ms = statistics.median(step_ms[warmup:])
    return state, step, {
        "losses": losses, "grad_norms": gnorms, "step_ms_timed": step_ms[warmup:],
        "step_ms_median": med_ms, "items_per_s": items / (med_ms / 1e3),
        "step_ms_warmup": step_ms[:warmup],
        "launches_per_step": per_step, "launches": launch_counts(),
        "peak_memory_gib": peak_memory_gib(device)}


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


def attention_bounds(bh, seq, hd, elt=2):
    """The least time, in ms, and what bounds it, of the causal forward and
    backward kernels on (bh, seq, hd): the products over the (query, key)
    pairs the causal mask keeps (forward 2, backward 5, each 2 * hd
    operations a pair) at the bf16 peak, against each input read once and
    each output written once (forward q, k, v -> o and an f32 lse; backward
    q, k, v, do and f32 lse, delta -> dq, dk, dv) at the memory rate."""
    pairs = bh * seq * (seq + 1) / 2
    fwd = bound(2 * 2 * hd * pairs, 4 * bh * seq * hd * elt + bh * seq * 4)
    bwd = bound(5 * 2 * hd * pairs, 7 * bh * seq * hd * elt + 2 * bh * seq * 4)
    return fwd, bwd


# What the chip contract asks of every kernel in the ``kernels`` line.
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms")
# Every path the kernels line counts launches on: each must launch both kernels.
KERNEL_PATHS = ("main_path", "trainer", "mesh_gang", "pipeline_gang", "context_gang", "llama",
                "moe", "remat_dots", "expert_gang", "elastic_reshard")


def check_kernels_line(line, paths):
    """The problems of a ``kernels`` line, [] if none: each kernel has every
    key of ``KERNEL_KEYS``, a positive time and bound, a route and a bound_by
    of the contract's words, and was launched on each of ``paths``."""
    problems = []
    for k in line["kernels"]:
        name = k.get("name", "?")
        problems += [f"{name}: no {key}" for key in KERNEL_KEYS if key not in k]
        if k.get("route") not in ("cuda", "triton"):
            problems.append(f"{name}: route {k.get('route')!r}")
        if k.get("bound_by") not in ("bytes", "operations"):
            problems.append(f"{name}: bound_by {k.get('bound_by')!r}")
        for key in ("ms", "plain_ms", "bound_ms"):
            if not (isinstance(k.get(key), (int, float)) and k[key] > 0):
                problems.append(f"{name}: {key} {k.get(key)!r}")
        per_path = k.get("launches_per_path", {})
        problems += [f"{name}: no launch on {p}" for p in paths if not per_path.get(p)]
    return problems


def init_loss_expected(vocab, d_model, std=0.02):
    """The mean cross entropy at init of an LM whose final RMSNorm feeds an
    untied head drawn from normal(std): each logit is normal with variance
    std^2 * d_model (the normed rows have unit mean square), so the loss is
    ln(vocab) + std^2 * d_model / 2."""
    return math.log(vocab) + std * std * d_model / 2


def first_step_reference(cfg, batch, model, extra=None):
    """The loss of the first step's weights (seed 0) without the optimizer
    state, through plain attention (``attention="xla"``) under no_grad, and
    ``extra(params)`` under no_grad when given. Frees the weights before it
    returns."""
    import torch

    params = model.init_params(cfg, 0)
    with torch.no_grad():
        ref = model.loss_fn(params, batch, dataclasses.replace(cfg, attention="xla")).item()
        extra = extra(params) if extra else None
    del params
    torch.cuda.empty_cache()
    return ref, extra


def phase_llama(smi):
    """Llama 3 8B at full width, depth cut to 4 layers, B 1 x S 8192."""
    import torch

    from ray_tpu_torch.models import LlamaConfig, create_train_state, default_optimizer, shard_batch
    from ray_tpu_torch.models import llama

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layer=LLAMA_LAYERS)
    opt = default_optimizer(learning_rate=3e-4)
    rng = np.random.default_rng(0)
    batch = shard_batch({"tokens": rng.integers(0, cfg.vocab_size, (LLAMA_B, LLAMA_S + 1))
                         .astype(np.int32)})
    ref_loss, _ = first_step_reference(cfg, batch, llama)
    state = create_train_state(cfg, 0, opt)
    state, step, run = run_steps(cfg, opt, state, batch, warmup=ZOO_WARMUP, timed=ZOO_TIMED,
                                 items=LLAMA_B * LLAMA_S)
    losses = run["losses"]
    expected = init_loss_expected(cfg.vocab_size, cfg.d_model)
    flops = llama.train_flops_per_token(cfg, LLAMA_S)
    line = {"phase": "llama", "model": "llama3_8b", "n_layer": cfg.n_layer,
            "d_model": cfg.d_model, "n_head": cfg.n_head, "n_kv_head": cfg.n_kv_head,
            "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
            "rope_theta": cfg.rope_theta, "batch": LLAMA_B, "seq": LLAMA_S,
            "params": llama.num_params(cfg), "dtype": "bfloat16", "remat_policy": cfg.remat_policy,
            "losses": losses, "grad_norms": run["grad_norms"],
            "plain_attention_first_loss": ref_loss,
            "first_loss_abs_err": abs(losses[0] - ref_loss),
            "ln_vocab": math.log(cfg.vocab_size), "init_loss_expected": expected,
            "step_ms_warmup": run["step_ms_warmup"], "step_ms_timed": run["step_ms_timed"],
            "step_ms_median": run["step_ms_median"], "tokens_per_s": run["items_per_s"],
            "train_flops_per_token": flops, "mfu": flops * run["items_per_s"] / PEAK_BF16_FLOPS,
            "peak_memory_gib": run["peak_memory_gib"], "launches": run["launches"],
            "launches_per_step": run["launches_per_step"], "card": smi}
    line["profile"] = profile_steps(step, state, batch, run["step_ms_median"])
    emit(line)
    check_launches("llama", run, cfg.n_layer)
    require(all(math.isfinite(x) for x in losses), f"llama: non-finite loss {losses}")
    require(line["first_loss_abs_err"] <= LOSS_TOL,
            f"llama: first loss {losses[0]} vs plain attention {ref_loss}")
    require(abs(losses[0] - expected) <= INIT_LOSS_TOL,
            f"llama: first loss {losses[0]}, expected {expected} at init")
    del state, step, batch
    torch.cuda.empty_cache()
    return run["launches"]


def phase_moe(smi):
    """GPT-2 small with 8 Switch experts in every block, B 16 x S 1024."""
    import torch

    from ray_tpu_torch.models import GPTConfig, create_train_state, default_optimizer, shard_batch
    from ray_tpu_torch.models import gpt, moe

    cfg = GPTConfig.gpt2_small(moe_experts=MOE_EXPERTS)
    opt = default_optimizer(learning_rate=3e-4)
    rng = np.random.default_rng(0)
    batch = shard_batch({"tokens": rng.integers(0, cfg.vocab_size - 1, (B, S + 1)).astype(np.int32)})
    dropped = []

    def aux_and_dropped(params):
        # Each layer's share of tokens over capacity, read from the routing
        # its MoE layer computes, through the default (kernel) attention.
        plain = moe.moe_mlp

        def counting(x, router_w, *args, capacity_factor, **kw):
            dropped.append(1 - moe.route(x, router_w, capacity_factor).keep.float().mean().item())
            return plain(x, router_w, *args, capacity_factor=capacity_factor, **kw)

        moe.moe_mlp = counting
        try:
            _, aux = gpt.forward(params, batch["tokens"][:, :-1], cfg, return_aux=True)
        finally:
            moe.moe_mlp = plain
        return aux.item()

    ref_loss, aux = first_step_reference(cfg, batch, gpt, aux_and_dropped)
    state = create_train_state(cfg, 0, opt)
    state, step, run = run_steps(cfg, opt, state, batch, warmup=ZOO_WARMUP, timed=ZOO_TIMED)
    losses = run["losses"]
    flops = gpt.train_flops_per_token(cfg, S)
    line = {"phase": "moe", "model": "gpt2_small", "moe_experts": cfg.moe_experts,
            "capacity_factor": cfg.moe_capacity_factor,
            "capacity": moe.moe_capacity(S, cfg.moe_experts, cfg.moe_capacity_factor),
            "batch": B, "seq": S, "params": gpt.num_params(cfg), "dtype": "bfloat16",
            "remat_policy": cfg.remat_policy, "losses": losses, "grad_norms": run["grad_norms"],
            "plain_attention_first_loss": ref_loss, "first_loss_abs_err": abs(losses[0] - ref_loss),
            "first_aux_loss": aux, "dropped_share_per_layer": dropped,
            "dropped_share": statistics.mean(dropped),
            "step_ms_warmup": run["step_ms_warmup"], "step_ms_timed": run["step_ms_timed"],
            "step_ms_median": run["step_ms_median"], "tokens_per_s": run["items_per_s"],
            "train_flops_per_token": flops, "mfu": flops * run["items_per_s"] / PEAK_BF16_FLOPS,
            "peak_memory_gib": run["peak_memory_gib"], "launches": run["launches"],
            "launches_per_step": run["launches_per_step"], "card": smi}
    line["profile"] = profile_steps(step, state, batch, run["step_ms_median"])
    emit(line)
    check_launches("moe", run, cfg.n_layer)
    require(all(math.isfinite(x) for x in losses), f"moe: non-finite loss {losses}")
    require(line["first_loss_abs_err"] <= LOSS_TOL,
            f"moe: first loss {losses[0]} vs plain attention {ref_loss}")
    require(math.isfinite(aux) and aux > 0, f"moe: aux loss {aux}")
    require(len(dropped) == cfg.n_layer, f"moe: routed {len(dropped)} layers")
    del state, step, batch
    torch.cuda.empty_cache()
    return run["launches"], losses[0], run["grad_norms"][0]


def phase_resnet50(smi):
    """ResNet-50 on B 128 random 224 x 224 images; no attention, no kernel of
    the port on its path."""
    import torch

    from ray_tpu_torch.models import ResNetConfig, create_train_state, default_optimizer, shard_batch
    from ray_tpu_torch.models import resnet

    cfg = ResNetConfig.resnet50()
    opt = default_optimizer(learning_rate=3e-4)
    rng = np.random.default_rng(0)
    batch = shard_batch({
        "images": rng.standard_normal((RESNET_B, 224, 224, 3)).astype(np.float32),
        "labels": rng.integers(0, cfg.num_classes, (RESNET_B,)).astype(np.int32)})
    # The same weights and images in f32 (no TF32): the plain reference.
    params = resnet.init_params(cfg, 0)
    with torch.no_grad():
        ref_loss = resnet.loss_fn(params, batch, dataclasses.replace(cfg, dtype=torch.float32)).item()
    del params
    torch.cuda.empty_cache()
    state = create_train_state(cfg, 0, opt)
    state, step, run = run_steps(cfg, opt, state, batch, warmup=ZOO_WARMUP, timed=ZOO_TIMED,
                                 items=RESNET_B)
    losses = run["losses"]
    line = {"phase": "resnet50", "batch": RESNET_B, "image": [224, 224, 3],
            "params": resnet.num_params(cfg), "dtype": "bfloat16", "losses": losses,
            "grad_norms": run["grad_norms"], "f32_first_loss": ref_loss,
            "first_loss_abs_err_vs_f32": abs(losses[0] - ref_loss),
            "ln_classes": math.log(cfg.num_classes),
            "first_loss_minus_ln_classes": losses[0] - math.log(cfg.num_classes),
            "step_ms_warmup": run["step_ms_warmup"], "step_ms_timed": run["step_ms_timed"],
            "step_ms_median": run["step_ms_median"], "images_per_s": run["items_per_s"],
            "peak_memory_gib": run["peak_memory_gib"], "launches": run["launches"], "card": smi}
    line["profile"] = profile_steps(step, state, batch, run["step_ms_median"])
    emit(line)
    require(all(math.isfinite(x) for x in losses), f"resnet50: non-finite loss {losses}")
    require(line["first_loss_abs_err_vs_f32"] <= RESNET_F32_LOSS_TOL,
            f"resnet50: first loss {losses[0]} vs f32 {ref_loss}")
    require(abs(line["first_loss_minus_ln_classes"]) <= RESNET_INIT_LOSS_TOL,
            f"resnet50: first loss {losses[0]} vs ln {cfg.num_classes}")
    del state, step, batch
    torch.cuda.empty_cache()


def phase_remat_dots(smi, main_loss, main_gnorm, main_peak_gib):
    """The main path's workload under ``remat_policy="dots"``: each block is
    checkpointed with its weight products' outputs saved, so the backward
    recomputes the rest, the forward kernel included."""
    import torch

    cfg, opt, state, batch = build_workload()
    cfg = dataclasses.replace(cfg, remat_policy="dots")
    state, _, run = run_steps(cfg, opt, state, batch, warmup=1, timed=DOTS_TIMED)
    losses, gnorms = run["losses"], run["grad_norms"]
    line = {"phase": "remat_dots", "model": "gpt2_small", "batch": B, "seq": S,
            "remat_policy": cfg.remat_policy, "losses": losses, "grad_norms": gnorms,
            "first_loss_abs_err_vs_main_path": abs(losses[0] - main_loss),
            "first_grad_norm_rel_err_vs_main_path": abs(gnorms[0] - main_gnorm) / main_gnorm,
            "step_ms_timed": run["step_ms_timed"], "step_ms_median": run["step_ms_median"],
            "tokens_per_s": run["items_per_s"], "peak_memory_gib": run["peak_memory_gib"],
            "main_path_peak_memory_gib": main_peak_gib, "launches": run["launches"],
            "launches_per_step": run["launches_per_step"], "card": smi}
    emit(line)
    # The forward kernel runs twice per layer per step: once, and again in
    # the backward's recompute.
    n = cfg.n_layer
    for i, per_step in enumerate(run["launches_per_step"]):
        require(per_step == {"flash_fwd": 2 * n, "flash_bwd": n},
                f"remat_dots step {i}: kernel launches {per_step}, expected {2 * n} and {n}")
    require(line["first_loss_abs_err_vs_main_path"] <= TRAINER_FIRST_LOSS_TOL,
            f"remat_dots: first loss {losses[0]} vs the main path's {main_loss}")
    require(line["first_grad_norm_rel_err_vs_main_path"] <= GRAD_NORM_RTOL,
            f"remat_dots: first grad norm {gnorms[0]} vs the main path's {main_gnorm}")
    del state, batch
    torch.cuda.empty_cache()
    return run["launches"]


# ---------------------------------------------------------------------------- collectives and the mesh
COLLECTIVE_DTYPES = ("float32", "bfloat16")


def phase_collective_nccl(smi):
    """Every op of ``ray_tpu_torch.util.collective`` on a world-1 NCCL group
    over CUDA tensors, f32 and bf16: allreduce under each ReduceOp, reduce,
    broadcast, allgather, reducescatter, sendrecv to itself and the empty
    permutation, the three ``*_multidevice`` ops over the one device, and a
    barrier. In a world of one each result equals its input (the empty
    permutation: zeros), on ``cuda:0``."""
    import torch

    from ray_tpu_torch.util import collective as col
    from ray_tpu_torch.util.collective import ReduceOp

    g = "chip_smoke_nccl"
    t0 = time.perf_counter()
    col.init_collective_group(1, 0, backend="nccl", group_name=g)
    init_s = time.perf_counter() - t0
    results, devices, bad = {}, set(), []
    for name in COLLECTIVE_DTYPES:
        dtype = getattr(torch, name)
        x = (torch.arange(1024, device="cuda") % 97 + 1).to(dtype)
        got = {f"allreduce_{op.value}": col.allreduce(x.clone(), g, op) for op in ReduceOp}
        got["reduce"] = col.reduce(x.clone(), 0, g)
        got["broadcast"] = col.broadcast(x.clone(), 0, g)
        got["allgather"] = col.allgather(x, g)[0]
        got["reducescatter"] = col.reducescatter(x, g)
        got["sendrecv_self"] = col.sendrecv(x, [(0, 0)], g)
        got["allreduce_multidevice"] = col.allreduce_multidevice([x.clone()], g)[0]
        got["allgather_multidevice"] = col.allgather_multidevice([x], g)[0]
        got["reducescatter_multidevice"] = col.reducescatter_multidevice([x], g)[0]
        empty = col.sendrecv(x, [], g)
        col.barrier(g)
        torch.cuda.synchronize()
        for op, out in got.items():
            devices.add(str(out.device))
            if not torch.equal(out, x):
                bad.append(f"{name} {op}")
        if not torch.equal(empty, torch.zeros_like(x)) or empty.device != x.device:
            bad.append(f"{name} sendrecv []")
        results[name] = sorted(got) + ["sendrecv_empty", "barrier"]
    from ray_tpu_torch.util.collective import collective

    stats = dict(collective._STATS)
    col.destroy_collective_group(g)
    line = {"phase": "collective_nccl", "world": 1, "backend": "nccl", "init_s": init_s,
            "ops_checked": results, "result_devices": sorted(devices), "mismatches": bad,
            "timed_ops": stats["ops"], "timed_s": stats["time_s"], "card": smi}
    emit(line)
    require(not bad, f"collective_nccl: results differ from their inputs: {bad}")
    require(devices == {"cuda:0"}, f"collective_nccl: results on {devices}")
    return line


def collective_ms_per_step(prof, steps):
    """Time in collectives per step from a ``torch.profiler`` trace: the
    host's time inside c10d's gloo and NCCL calls (gloo reduces CUDA tensors
    on the host), and the NCCL kernels' device time."""
    from torch.autograd import DeviceType

    host = dev = 0.0
    for e in prof.key_averages():
        key = e.key.lower()
        if e.device_type == DeviceType.CUDA and "nccl" in key:
            dev += e.self_device_time_total / 1e3
        elif e.device_type == DeviceType.CPU and key.startswith(("gloo:", "nccl:")):
            host += e.cpu_time_total / 1e3
    return {"host_ms": host / steps, "nccl_kernel_ms": dev / steps}


def span_overlap_ms(spans_a, spans_b):
    """(ms in which a span of each list runs, ms of a's union, ms of b's
    union), from (start, end) spans in microseconds."""

    def union(spans):
        out = []
        for a, b in sorted(spans):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    ua, ub = union(spans_a), union(spans_b)
    both = sum(max(0, min(b, d) - max(a, c)) for a, b in ua for c, d in ub)
    return both / 1e3, sum(b - a for a, b in ua) / 1e3, sum(b - a for a, b in ub) / 1e3


def p2p_overlap_ms(prof):
    """Device ms of one profiled step in which an NCCL kernel and an
    attention kernel run at once (the ring's rotation beside its blocks),
    and the NCCL kernels' and attention kernels' own ms."""
    from torch.autograd import DeviceType

    nccl, attn = [], []
    for e in prof.events():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if "nccl" in e.name.lower():
            nccl.append(span)
        elif any(k in e.name for k in ATTENTION_KERNELS):
            attn.append(span)
    both, nccl_ms, attn_ms = span_overlap_ms(nccl, attn)
    return {"overlap_ms": both, "nccl_ms": nccl_ms, "attention_ms": attn_ms}


def mesh_train_loop(config):
    """The per-worker loop of a mesh gang: ``session.get_mesh()``, the GPT-2
    or Llama workload sharded over it (weights from seed 0, the batch from
    numpy seed 0, each rank keeping its shard of the global batch), the
    timed steps with launches counted per step, one profiled step for the
    collectives' time, and, from rank 0, the node's GPU resources while the
    gang holds them. Returns what it measured. A mesh on the CPU
    (``config["device"] == "cpu"``) is a rehearsal (``tools/port_multichip.py
    --rehearse``), with no memory measured."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import ray_tpu_torch
    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import (GPTConfig, LlamaConfig, ResNetConfig, create_train_state,
                                      default_optimizer, shard_batch)
    from ray_tpu_torch.models.training import mesh_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = session.get_mesh()
    device = mesh_device(mesh)
    preset = {"llama3_8b": LlamaConfig.llama3_8b, "resnet50": ResNetConfig.resnet50}.get(
        config["model"], GPTConfig.gpt2_small)
    cfg = dataclasses.replace(preset(), **config.get("cut", {}))
    opt = default_optimizer(learning_rate=3e-4)
    gb, seq = config["global_batch"], config["seq"]
    batch = shard_batch(mesh_batch(cfg, gb, seq, config.get("image", 224)), mesh)
    reset_peak_memory(device)
    t0 = time.perf_counter()
    state = create_train_state(cfg, 0, opt, mesh=mesh)
    device_sync(device)
    init_s = time.perf_counter() - t0
    state_gib = peak_memory_gib(device)
    # Tokens (images: seq 1) per GPU: a tensor-parallel or expert group
    # shares its rows.
    per_gpu = gb * seq // dist.get_world_size()
    state, step, run = run_steps(cfg, opt, state, batch, warmup=config["warmup"],
                                 timed=config["timed"], items=per_gpu, mesh=mesh)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        device_sync(device)
    run["collective_ms_per_step"] = collective_ms_per_step(prof, 1)
    run["p2p_overlap_per_step"] = p2p_overlap_ms(prof)
    if dist.get_rank() == 0:
        run["node_gpu"] = ray_tpu_torch.cluster_resources().get("GPU")
        run["node_gpu_available"] = ray_tpu_torch.available_resources().get("GPU")
    run.update(rank=dist.get_rank(), world=dist.get_world_size(), backend=dist.get_backend(),
               mesh_is_device_mesh=isinstance(mesh, DeviceMesh),
               mesh_dim_names=list(mesh.mesh_dim_names), mesh_shape=list(mesh.mesh.shape),
               device=str(device), cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"), pid=os.getpid(),
               init_s=init_s, state_peak_gib=state_gib, n_layer=getattr(cfg, "n_layer", None),
               tokens_per_gpu_per_step=per_gpu, local_shapes=local_shapes(state.params))
    return run


def mesh_batch(cfg, global_batch, seq, image=224):
    """The host batch of a mesh phase, from numpy seed 0: tokens (B, S + 1)
    for an LM, as ``build_workload`` draws them; images (B, image, image, 3)
    and labels for ResNet, as ``phase_resnet50`` draws them."""
    rng = np.random.default_rng(0)
    if hasattr(cfg, "stage_sizes"):
        return {"images": rng.standard_normal((global_batch, image, image, 3)).astype(np.float32),
                "labels": rng.integers(0, cfg.num_classes, (global_batch,)).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size - 1, (global_batch, seq + 1))
            .astype(np.int32)}


def local_shapes(params):
    """This rank's shard shapes of the leaves a mesh splits in the phases'
    models: the MoE experts' first products, the dense first products, the
    stem's convolution and the classifier head."""
    blocks = params.get("blocks", {})
    leaves = {"moe.fc_w": blocks.get("moe", {}).get("fc_w"), "fc_w": blocks.get("fc_w"),
              "stem.conv": params.get("stem", {}).get("conv"),
              "head.w": params.get("head", {}).get("w")}
    return {k: list(v.to_local().shape) for k, v in leaves.items() if v is not None}


@dataclasses.dataclass
class ElasticRun:
    """What an elastic gang's ``run_mesh_gang`` adds: the preemption
    simulator its fit runs under, the runtime's system config, and the
    process group's timeout (None: ``TorchConfig``'s)."""
    simulator: Any
    system_config: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: dict(ELASTIC_SYSTEM_CONFIG))
    group_timeout_s: Optional[float] = None


def run_mesh_gang(scaling, backend, config, name, loop=None, elastic=None):
    """``loop`` (``mesh_train_loop`` by default) on every rank through
    ``TorchTrainer`` on a fresh runtime; every rank's report (the runtime
    forwards rank 0's, so each rank also puts its own under a KV key; an
    elastic gang's are its last world's), the KV store's other entries under
    ``name``, the runtime's worker pids, and what is left after
    ``shutdown()``. ``elastic``: an ``ElasticRun``; an elastic gang may lose
    no failure budget."""
    import ray_tpu_torch
    import ray_tpu_torch.train.torch as rt_torch
    from ray_tpu_torch.air import FailureConfig, RunConfig

    ray_tpu_torch.init(num_cpus=max(4, scaling.num_workers + 2),
                       _system_config=elastic and elastic.system_config)
    session_dir = ray_tpu_torch._private.worker.global_worker.session_dir
    node = ray_tpu_torch.cluster_resources()
    timeout = {"init_timeout_s": elastic.group_timeout_s} \
        if elastic and elastic.group_timeout_s else {}
    trainer = rt_torch.TorchTrainer(
        functools.partial(_per_rank_reports, loop or mesh_train_loop),
        train_loop_config={**config, "kv_key": name}, scaling_config=scaling,
        backend_config=rt_torch.TorchConfig(backend=backend, device=config.get("device"),
                                            **timeout),
        run_config=RunConfig(name=name, storage_path=os.path.join(session_dir, "results"),
                             failure_config=FailureConfig(max_failures=0)))
    t0 = time.perf_counter()
    try:
        with elastic.simulator if elastic else contextlib.nullcontext():
            result = trainer.fit()
        error = result.error
    except Exception as e:  # printed with the workers' logs, then raised
        error = e
    fit_s = time.perf_counter() - t0
    if error is not None:
        for log in sorted(glob.glob(os.path.join(session_dir, "logs", "worker-*.log"))):
            with open(log, errors="replace") as f:
                print(f"--- {log} (tail)\n" + "".join(f.readlines()[-40:]), file=sys.stderr)
        raise error
    from ray_tpu_torch._private.worker import global_worker

    kv = {k.decode(): json.loads(global_worker.context.kv("get", k))
          for k in global_worker.context.kv("keys", f"{name}/".encode())}
    reports = {int(k[len(name) + 1:]): v for k, v in kv.items() if k[len(name) + 1:].isdigit()}
    ranks = [reports[r] for r in sorted(reports)]
    events = global_worker.context.cluster_events({"kind": "train_gang_resize"})
    pids = runtime_worker_pids() | {r["pid"] for r in ranks}
    ray_tpu_torch.shutdown()
    leftover_dirs = [session_dir] if os.path.exists(session_dir) else []
    leftover_pids = sorted(p for p in pids if pid_alive(p))
    return {"ranks": ranks, "kv": kv, "resize_events": [e["data"] for e in events],
            "node_resources": node, "fit_s": fit_s, "result_metrics": result.metrics,
            "leftover_session_dirs": leftover_dirs, "leftover_worker_pids": leftover_pids}


def _per_rank_reports(loop, config):
    """``loop`` on each rank, its result put in the KV store under
    ``<kv_key>/<rank>`` for the calling process (a run's Result holds rank
    0's report alone), then reported."""
    import torch.distributed as dist

    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.air import session

    run = loop(config)
    blob = json.dumps(run, default=float).encode()
    global_worker.context.kv("put", f"{config['kv_key']}/{dist.get_rank()}".encode(), blob)
    session.report(run)


def run_mesh_phases(smi):
    """``collective_nccl`` and ``mesh_gang`` alone, against the main path's
    first step taken here (``tools/port_chip_phases.py mesh``)."""
    import torch

    from ray_tpu_torch.ops import _build

    _build.build()
    cfg, opt, state, batch = build_workload()
    state, _, run = run_steps(cfg, opt, state, batch, warmup=0, timed=1)
    del state, batch
    torch.cuda.empty_cache()
    phase_collective_nccl(smi)
    return phase_mesh_gang(smi, run["losses"][0], run["grad_norms"][0])


def phase_mesh_gang(smi, main_loss, main_gnorm):
    """GPT-2 small at full width and depth through ``TorchTrainer`` on a
    ``{"data": 2}`` mesh: two workers holding 0.5 GPU each on the one card,
    over gloo (NCCL refuses two ranks on one GPU), global B 16 x S 1024 (8
    rows per rank), the main path's weights and batch, 1 warmup and 3 timed
    steps."""
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.parallel import AXIS_ORDER

    scaling = ScalingConfig(num_workers=2, use_gpu=True, gpus_per_worker=0.5, mesh={"data": 2})
    config = {"model": "gpt2_small", "global_batch": B, "seq": S, "warmup": 1,
              "timed": MESH_GANG_TIMED}
    out = run_mesh_gang(scaling, "gloo", config, "chip_smoke_mesh_gang")
    ranks = out["ranks"]
    r0 = ranks[0]
    n = 12
    line = {"phase": "mesh_gang", "entry": "TorchTrainer.fit", "mesh": {"data": 2},
            "backend": "gloo", "num_workers": 2, "gpus_per_worker": 0.5,
            "global_batch": B, "seq": S, "node_resources": out["node_resources"],
            "node_gpu_available_during_fit": r0.get("node_gpu_available"),
            "mesh_dim_names": r0["mesh_dim_names"], "mesh_shape": r0["mesh_shape"],
            "losses": r0["losses"], "grad_norms": r0["grad_norms"],
            "main_path_first_loss": main_loss, "main_path_first_grad_norm": main_gnorm,
            "first_loss_abs_err_vs_main_path": abs(r0["losses"][0] - main_loss),
            "first_grad_norm_rel_err_vs_main_path": abs(r0["grad_norms"][0] - main_gnorm)
            / main_gnorm,
            "per_rank": [{k: r[k] for k in (
                "rank", "pid", "device", "cuda_visible_devices", "step_ms_timed",
                "step_ms_median", "items_per_s", "launches_per_step", "launches",
                "collective_ms_per_step", "peak_memory_gib", "state_peak_gib", "init_s")}
                for r in ranks],
            "fit_s": out["fit_s"], "leftover_session_dirs": out["leftover_session_dirs"],
            "leftover_worker_pids": out["leftover_worker_pids"], "card": smi}
    emit(line)
    require(all(r["mesh_is_device_mesh"] and r["mesh_dim_names"] == list(AXIS_ORDER)
                for r in ranks), f"mesh_gang: get_mesh() gave {r0['mesh_dim_names']}")
    require(line["first_loss_abs_err_vs_main_path"] <= LOSS_TOL,
            f"mesh_gang: first loss {r0['losses'][0]} vs the main path's {main_loss}")
    require(line["first_grad_norm_rel_err_vs_main_path"] <= GRAD_NORM_RTOL,
            f"mesh_gang: first grad norm {r0['grad_norms'][0]} vs the main path's {main_gnorm}")
    for r in ranks:
        check_launches(f"mesh_gang rank {r['rank']}", r, n)
        require(all(math.isfinite(x) for x in r["losses"]), f"mesh_gang: losses {r['losses']}")
    require(out["node_resources"].get("GPU") == 1 and r0.get("node_gpu_available") == 0,
            f"mesh_gang: node GPU {out['node_resources'].get('GPU')}, "
            f"{r0.get('node_gpu_available')} free during the fit: expected 1.0 and 0.0")
    require(not out["leftover_session_dirs"] and not out["leftover_worker_pids"],
            f"mesh_gang: left after shutdown: {out['leftover_session_dirs']}, "
            f"{out['leftover_worker_pids']}")
    return r0["launches"]


def phase_expert_tp_gang(smi, moe_loss, moe_gnorm):
    """The moe phase's MoE GPT-2 through ``TorchTrainer`` on ``{"expert":
    2}`` (two 0.5-GPU ranks over gloo, each holding 4 of every layer's 8
    experts), against the moe phase's first loss and grad norm; then
    ResNet-50 on ``{"tensor": 2}`` at B ``RESNET_TP_B``, against one rank's
    first step on the same weights and images. Returns rank 0's launches on
    the MoE gang."""
    import torch

    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.models import ResNetConfig, create_train_state, default_optimizer
    from ray_tpu_torch.models import shard_batch

    cases = {}
    # One rank's ResNet-50 first step at the gang's batch, on this card.
    cfg = ResNetConfig.resnet50()
    opt = default_optimizer(learning_rate=3e-4)
    state = create_train_state(cfg, 0, opt)
    _, _, one = run_steps(cfg, opt, state, shard_batch(mesh_batch(cfg, RESNET_TP_B, 1)),
                          warmup=0, timed=1, items=RESNET_TP_B)
    del state
    torch.cuda.empty_cache()
    for name, mesh, config, ref, per_step in (
            ("moe_expert2", {"expert": 2},
             {"model": "gpt2_small", "cut": {"moe_experts": MOE_EXPERTS}, "global_batch": B,
              "seq": S, "warmup": 1, "timed": EXPERT_GANG_TIMED}, (moe_loss, moe_gnorm), 12),
            ("resnet50_tensor2", {"tensor": 2},
             {"model": "resnet50", "global_batch": RESNET_TP_B, "seq": 1, "warmup": 1,
              "timed": EXPERT_GANG_TIMED}, (one["losses"][0], one["grad_norms"][0]), 0)):
        scaling = ScalingConfig(num_workers=2, use_gpu=True, gpus_per_worker=0.5, mesh=mesh)
        out = run_mesh_gang(scaling, "gloo", config, f"chip_smoke_{name}")
        ranks = out["ranks"]
        r0 = ranks[0]
        line = {"phase": "expert_tp_gang", "name": name, "entry": "TorchTrainer.fit",
                "mesh": mesh, "backend": "gloo", "num_workers": 2, "gpus_per_worker": 0.5,
                "model": config["model"], "global_batch": config["global_batch"],
                "seq": config["seq"], "mesh_shape": r0["mesh_shape"],
                "local_shapes_per_rank": [r["local_shapes"] for r in ranks],
                "losses": r0["losses"], "grad_norms": r0["grad_norms"],
                "reference_first_loss": ref[0], "reference_first_grad_norm": ref[1],
                "reference": "moe phase (one card)" if per_step else "one rank on this card",
                "first_loss_abs_err": abs(r0["losses"][0] - ref[0]),
                "first_grad_norm_rel_err": abs(r0["grad_norms"][0] - ref[1]) / ref[1],
                "tol": {"loss_abs": LOSS_TOL, "grad_norm_rel": GRAD_NORM_RTOL},
                "expected_launches_per_rank_per_step": per_step,
                "per_rank": [{k: r[k] for k in (
                    "rank", "pid", "device", "step_ms_timed", "step_ms_median", "items_per_s",
                    "launches_per_step", "collective_ms_per_step", "peak_memory_gib",
                    "state_peak_gib", "init_s")} for r in ranks],
                "fit_s": out["fit_s"], "leftover_session_dirs": out["leftover_session_dirs"],
                "leftover_worker_pids": out["leftover_worker_pids"], "card": smi}
        emit(line)
        require(all(r["losses"] == r0["losses"] for r in ranks), f"{name}: ranks disagree")
        require(line["first_loss_abs_err"] <= LOSS_TOL,
                f"{name}: first loss {r0['losses'][0]} vs {ref[0]}")
        require(line["first_grad_norm_rel_err"] <= GRAD_NORM_RTOL,
                f"{name}: first grad norm {r0['grad_norms'][0]} vs {ref[1]}")
        for r in ranks:
            check_launches(f"{name} rank {r['rank']}", r, per_step)
            require(all(math.isfinite(x) for x in r["losses"]), f"{name}: losses {r['losses']}")
        require(not out["leftover_session_dirs"] and not out["leftover_worker_pids"],
                f"{name}: left after shutdown: {out['leftover_session_dirs']}, "
                f"{out['leftover_worker_pids']}")
        cases[name] = r0["launches"]
    return cases["moe_expert2"]


def state_digest(tree):
    """sha256 of a state tree's leaves (tensors whole, on the host; numbers),
    in ``resharding.tree_paths`` order: equal digests are equal bits."""
    import hashlib

    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.train.torch.resharding import tree_paths

    h = hashlib.sha256()
    for path, leaf in tree_paths(tree).items():
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        h.update(path.encode())
        h.update(str(arr.dtype).encode() + str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def elastic_train_loop(config):
    """The per-worker loop of the elastic phases: GPT-2 small
    (``config["dtype"]`` compute, f32 by default) data-parallel over
    ``session.get_mesh()``, the global batch's rows split over the world of
    the moment. Each step it stashes this rank's ``shard_for_rank`` of the
    params and Adam moments with the rules, puts the step's loss, time and
    the whole state's digest and the time it finished in the KV store (under
    ``world/step/rank``), and reports. A session started from a checkpoint
    (a resized gang) takes the gathered state (``resume_state``), puts it on the card with
    ``device_put_tree``, and records its digest. Returns the session's
    losses, launches, peak memory and its last step's collective time (that
    step runs under the profiler)."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import (GPTConfig, TrainState, create_train_state,
                                      default_optimizer, make_train_step, shard_batch)
    from ray_tpu_torch.models.training import (mesh_device, param_shardings, tree_leaves,
                                               tree_map)
    from ray_tpu_torch.ops import launch_counts, reset_launch_counts
    from ray_tpu_torch.train.torch import resharding

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = session.get_mesh()
    device = mesh_device(mesh)
    rank, world = session.get_world_rank(), session.get_world_size()
    dtype = getattr(torch, config.get("dtype", "float32"))
    cfg = dataclasses.replace(GPTConfig.gpt2_small(dtype=dtype), **config.get("cut", {}))
    opt = default_optimizer(learning_rate=3e-4)
    batch = shard_batch(mesh_batch(cfg, config["global_batch"], config["seq"]), mesh)
    rules = [tuple(r) for r in config["rules"]]
    kv = lambda key, value: global_worker.context.kv(  # noqa: E731
        "put", f"{config['kv_key']}/{key}".encode(), json.dumps(value).encode())
    reset_peak_memory(device)
    ck = session.get_checkpoint()
    resumed = None
    if ck is None:
        state = create_train_state(cfg, 0, opt, mesh=mesh)
    else:
        step, tree, _ = resharding.resume_state(ck.to_dict())
        t0 = time.perf_counter()
        # Replicated over the new mesh, as the model's data-parallel state is
        # (the stash's rules cut it for the old world, unevenly at 4 -> 3).
        placed = resharding.device_put_tree(tree, [(".*", ())], mesh)
        device_sync(device)
        resumed = {"step": step, "digest": state_digest(placed), "world": world,
                   "device_put_s": time.perf_counter() - t0,
                   "leaf_device": str(placed["params"]["wte"].to_local().device)}
        kv(f"resumed/{rank}", resumed)
        # The model's placements, in its own leaf order.
        placements = param_shardings(cfg, mesh)

        def model_tree(t, pl=placements):
            if isinstance(t, dict):
                return {k: model_tree(t[k], pl[k]) for k in pl}
            return t.redistribute(mesh, pl)

        params = model_tree(placed["params"])
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        state = TrainState(params=params, step=step, opt_state={
            "count": int(tree["count"]), "mu": model_tree(placed["mu"]),
            "nu": model_tree(placed["nu"])})
        del placed, tree
    steps, first = config["steps"], state.step
    step_fn = make_train_step(cfg, opt, mesh=mesh)
    losses, per_step, stash_s, collective = [], [], [], None
    reset_launch_counts()
    for s_ in range(first, steps):
        before = launch_counts()
        profiled = s_ + 1 == steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled \
                else contextlib.nullcontext() as prof:
            device_sync(device)
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(m["loss"].item())
            device_sync(device)
            step_ms = (time.perf_counter() - t0) * 1e3
        if profiled:
            collective = collective_ms_per_step(prof, 1)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        t0 = time.perf_counter()
        whole = {"params": tree_map(lambda t: t.to_local().detach(), state.params),
                 "mu": tree_map(lambda t: t.to_local(), state.opt_state["mu"]),
                 "nu": tree_map(lambda t: t.to_local(), state.opt_state["nu"]),
                 "count": state.opt_state["count"]}
        session.stash_checkpoint(resharding.shard_for_rank(whole, rules, world, rank),
                                 rules=rules, step=s_ + 1)
        t1 = time.perf_counter()
        kv(f"digest/{world}/{s_ + 1}/{rank}", state_digest(whole))
        # t_done on the host's monotonic clock, which every rank on one host
        # shares: the gang's wall time a step, stash and digest included.
        kv(f"step/{world}/{s_ + 1}/{rank}", {"loss": losses[-1], "step_ms": step_ms,
                                             "stash_s": t1 - t0,
                                             "digest_s": time.perf_counter() - t1,
                                             "t_done": time.monotonic()})
        stash_s.append(time.perf_counter() - t0)
        if s_ + 1 < steps:
            session.report({"step": s_ + 1, "loss": losses[-1], "world": world})
    return {"rank": rank, "world": world, "pid": os.getpid(), "device": str(device),
            "first_step": first, "losses": losses, "launches_per_step": per_step,
            "launches": launch_counts(), "stash_and_digest_s": stash_s, "resumed": resumed,
            "backend": dist.get_backend(), "mesh_shape": list(mesh.mesh.shape),
            "peak_memory_gib": peak_memory_gib(device),
            "collective_ms_last_step": collective}


def elastic_records(kv, name, kind):
    """The KV records ``kind`` ("digest" or "step") of an elastic run:
    {(world, step): {rank: value}}."""
    out = {}
    for key, value in kv.items():
        parts = key[len(name) + 1:].split("/")
        if parts[0] == kind:
            world, step, rank = map(int, parts[1:])
            out.setdefault((world, step), {})[rank] = value
    return out


def check_resume(kv, name, resumed_rank=0):
    """The problems of an elastic run's resume, [] if none: at every step
    that all ranks of a world recorded, their states' digests agree (a step
    the lost rank never finished is not a state the gang held), and the
    resumed state's digest equals what the ranks held at the resume step."""
    problems = []
    digests = elastic_records(kv, name, "digest")
    complete = {ws: by_rank for ws, by_rank in digests.items()
                if set(by_rank) == set(range(ws[0]))}
    for (world, step), by_rank in sorted(complete.items()):
        if len(set(by_rank.values())) != 1:
            problems.append(f"world {world} step {step}: the ranks' states differ {by_rank}")
    resumed = kv.get(f"{name}/resumed/{resumed_rank}")
    if resumed is None:
        return problems + ["no resume was recorded"]
    held = {d for (world, step), by_rank in complete.items() if step == resumed["step"]
            for d in by_rank.values()}
    if not held:
        problems.append(f"no digest at the resume step {resumed['step']}")
    elif held != {resumed["digest"]}:
        problems.append(f"the resumed state at step {resumed['step']} differs from what the "
                        f"ranks held: {resumed['digest']} vs {held}")
    return problems


def phase_elastic_reshard(smi, device=None):
    """GPT-2 small (f32) under ``ScalingConfig(num_workers=2, elastic=True)``
    (two 0.5-GPU ranks over gloo), stashing sharded state each step, with
    rank 1 killed after round ``ELASTIC_KILL_ROUND``: the gang re-forms at
    world 1 from the in-memory mirrors and finishes. The resumed state
    against what both ranks held (digests), the final loss against an
    uninterrupted one-rank run here. Returns the resumed rank's launches.
    ``device="cpu"``: a rehearsal (nano GPT, S 32)."""
    import torch

    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.models import GPTConfig, create_train_state, default_optimizer
    from ray_tpu_torch.models import shard_batch
    from ray_tpu_torch.util.preemption import (PreemptionEvent, PreemptionSchedule,
                                               PreemptionSimulator)

    on_cpu = device == "cpu"
    cut = dict(n_layer=2, n_head=2, d_model=64, vocab_size=256, max_seq_len=128) if on_cpu else {}
    seq = 32 if on_cpu else S
    name = "chip_smoke_elastic_reshard"
    config = {"cut": cut, "global_batch": ELASTIC_B, "seq": seq, "steps": ELASTIC_STEPS,
              "rules": ELASTIC_RULES, "device": device}
    sim = PreemptionSimulator(PreemptionSchedule(
        [PreemptionEvent(at_round=ELASTIC_KILL_ROUND, rank=1, mode="kill")]))
    scaling = ScalingConfig(num_workers=2, use_gpu=not on_cpu, elastic=True,
                            **({} if on_cpu else {"gpus_per_worker": 0.5}))
    out = run_mesh_gang(scaling, "gloo", config, name, loop=elastic_train_loop,
                        elastic=ElasticRun(sim))
    r0 = out["ranks"][0]
    # The uninterrupted run: the same model, weights and rows on one device.
    cfg = dataclasses.replace(GPTConfig.gpt2_small(dtype=torch.float32), **cut)
    opt = default_optimizer(learning_rate=3e-4)
    state = create_train_state(cfg, 0, opt, device=device)
    batch = shard_batch(mesh_batch(cfg, ELASTIC_B, seq), device=device)
    _, _, one = run_steps(cfg, opt, state, batch, warmup=0, timed=ELASTIC_STEPS,
                          items=ELASTIC_B * seq)
    del state, batch
    if not on_cpu:
        torch.cuda.empty_cache()
    problems = check_resume(out["kv"], name)
    final, ref = r0["losses"][-1], one["losses"][-1]
    line = {"phase": "elastic_reshard", "entry": "TorchTrainer.fit",
            "scaling": {"num_workers": 2, "elastic": True, "gpus_per_worker": 0.5},
            "backend": "gloo", "model": "gpt2_small", "dtype": "float32",
            "global_batch": ELASTIC_B, "seq": seq, "steps": ELASTIC_STEPS,
            "rules": ELASTIC_RULES, "fired": sim.fired, "resize_events": out["resize_events"],
            "resumed": r0["resumed"], "resumed_rank_losses": r0["losses"],
            "resumed_world": r0["world"], "one_rank_losses": one["losses"],
            "final_loss": final, "one_rank_final_loss": ref,
            "final_loss_rel_err": abs(final - ref) / abs(ref), "tol_rel": ELASTIC_LOSS_RTOL,
            "resume_problems": problems, "launches_per_step": r0["launches_per_step"],
            "stash_and_digest_s": r0["stash_and_digest_s"], "fit_s": out["fit_s"],
            "leftover_session_dirs": out["leftover_session_dirs"],
            "leftover_worker_pids": out["leftover_worker_pids"], "card": smi}
    emit(line)
    require([f["mode"] for f in sim.fired] == ["kill"], f"elastic_reshard: fired {sim.fired}")
    events = out["resize_events"]
    require(len(events) == 1 and (events[0]["old_world"], events[0]["new_world"]) == (2, 1)
            and events[0]["ckpt_source"] == "memory",
            f"elastic_reshard: resize events {events}")
    require(r0["world"] == 1 and r0["resumed"] is not None,
            f"elastic_reshard: ended at world {r0['world']}, resumed {r0['resumed']}")
    require(not problems, f"elastic_reshard: {problems}")
    require(line["final_loss_rel_err"] <= ELASTIC_LOSS_RTOL,
            f"elastic_reshard: final loss {final} vs the one-rank run's {ref}")
    if not on_cpu:
        require(r0["resumed"]["leaf_device"].startswith("cuda"),
                f"elastic_reshard: the resumed state is on {r0['resumed']['leaf_device']}")
        check_launches("elastic_reshard (resumed rank)", r0, cfg.n_layer)
    require(not out["leftover_session_dirs"] and not out["leftover_worker_pids"],
            f"elastic_reshard: left after shutdown: {out['leftover_session_dirs']}, "
            f"{out['leftover_worker_pids']}")
    return r0["launches"]


def rl_mesh_learner_loop(config):
    """The per-worker loop of the rl_mesh_learner phase: a TorchLearner on
    ``session.get_mesh()`` (``{"data": 2}``) from ``rl_learner_inputs``'
    weights, through its minibatches, of each of ``RL_MESH_KINDS``; each
    update's aux and the final weights' leaves, as lists."""
    from ray_tpu_torch.air import session
    from ray_tpu_torch.models.training import tree_leaves
    from ray_tpu_torch.rllib import TorchLearner

    mesh, out = session.get_mesh(), {}
    for kind in RL_MESH_KINDS:
        module, loss, opt, weights, extra, batches = rl_learner_inputs(kind)
        learner = TorchLearner(module, loss, optimizer=opt, mesh=mesh)
        learner.set_weights(weights)
        learner.set_extra(extra)
        aux = [learner.update(b) for b in batches]
        out[kind] = {"aux": [{k: np.asarray(v).tolist() for k, v in a.items()} for a in aux],
                     "weights": [np.asarray(w).tolist() for w in tree_leaves(learner.get_weights())],
                     "placement": learner.placement()}
    return {"rank": session.get_world_rank(), "pid": os.getpid(), **out}


def phase_rl_mesh_learner(smi, device="cuda"):
    """Two TorchLearners on ``{"data": 2}`` (two 0.5-GPU ranks over gloo,
    each taking half of every minibatch's rows) through rl_learner_check's
    PPO and DQN minibatches (and DQN's with importance weights), against one
    TorchLearner on ``device`` on the whole minibatches."""
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.models.training import tree_leaves
    from ray_tpu_torch.rllib import TorchLearner

    on_cpu = device == "cpu"
    scaling = ScalingConfig(num_workers=2, use_gpu=not on_cpu, mesh={"data": 2},
                            **({} if on_cpu else {"gpus_per_worker": 0.5}))
    out = run_mesh_gang(scaling, "gloo", {"device": device}, "chip_smoke_rl_mesh_learner",
                        loop=rl_mesh_learner_loop)
    ranks = out["ranks"]
    lines = []
    for kind in RL_MESH_KINDS:
        module, loss, opt, weights, extra, batches = rl_learner_inputs(kind)
        one = TorchLearner(module, loss, optimizer=opt, device=device)
        one.set_weights(weights)
        one.set_extra(extra)
        ref = [one.update(b) for b in batches]
        got = ranks[0][kind]["aux"]
        errs = [{k: rl_rel_err(g[k], r[k]) for k in r} for g, r in zip(got, ref)]
        worst = {k: max(e[k] for e in errs) for k in errs[0]}
        param_err = max(float(np.max(np.abs(np.asarray(a) - b))) for a, b in
                        zip(ranks[0][kind]["weights"], tree_leaves(one.get_weights())))
        same = all(r[kind]["weights"] == ranks[0][kind]["weights"] for r in ranks)
        line = {"phase": "rl_mesh_learner", "loss": kind, "mesh": {"data": 2}, "backend": "gloo",
                "placements": [r[kind]["placement"] for r in ranks], "updates": len(batches),
                "rows": len(batches[0]["obs"]), "rows_per_rank": len(batches[0]["obs"]) // 2,
                "max_rel_err_per_key": worst, "param_max_abs_err": param_err,
                "ranks_hold_equal_weights": same, "tol_rel": RL_TOL,
                "tol_param_abs": RL_PARAM_TOL, "fit_s": out["fit_s"],
                "leftover_session_dirs": out["leftover_session_dirs"],
                "leftover_worker_pids": out["leftover_worker_pids"], "card": smi}
        emit(line)
        lines.append(line)
        require(len(errs) == RL_UPDATES and max(worst.values()) <= RL_TOL,
                f"rl_mesh_learner {kind}: {worst}")
        require(param_err <= RL_PARAM_TOL and same, f"rl_mesh_learner {kind}: params {param_err}, "
                f"equal on the ranks: {same}")
        require(all(p["device"].startswith(device) for p in line["placements"]),
                f"rl_mesh_learner {kind}: placements {line['placements']}")
    require(not out["leftover_session_dirs"] and not out["leftover_worker_pids"],
            f"rl_mesh_learner: left after shutdown: {out['leftover_session_dirs']}, "
            f"{out['leftover_worker_pids']}")
    return lines


def ring_slices(x, n):
    """n contiguous slices (bh, S/n, d) of x (bh, S, d) along the sequence."""
    return [c.contiguous() for c in x.split(x.shape[1] // n, dim=1)]


def phase_ring_check(smi, device=None):
    """The ring's block loop and merge (``ring_forward``/``ring_backward``
    over a ``VirtualRing``: the distributed ring's code, minus the sends) on
    one card at each of ``RING_CASES``, against the plain ring and one
    full-sequence kernel call on the same inputs; then the block kernels'
    summed device time beside the one call's, and the whole ring's.
    ``device="cpu"`` is a rehearsal at the cases' shapes cut by 16 in bh
    and S: the kernels' plain versions, no times."""
    import torch

    from ray_tpu_torch.ops.flash_attention import _bwd, _delta, _fwd
    from ray_tpu_torch.parallel.ring_attention import (VirtualRing, plain_ring, ring_backward,
                                                       ring_forward)

    on_cpu = device == "cpu"
    dev = torch.device("cpu") if on_cpu else torch.device("cuda", torch.cuda.current_device())
    lines = []
    for i, (name, bh, seq, hd, n, dtype_name) in enumerate(RING_CASES):
        if on_cpu:
            bh, seq = max(bh // 16, 1), seq // 16
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device=dev).manual_seed(20 + i)
        q, k, v, do = (torch.randn((bh, seq, hd), generator=g, device=dev).to(dtype)
                       for _ in range(4))
        scale, ranks = hd ** -0.5, list(range(n))
        qs, ks, vs, dos = (ring_slices(x, n) for x in (q, k, v, do))
        os_, lses = ring_forward(qs, ks, vs, ranks, n, True, scale, VirtualRing())
        grads = ring_backward(qs, ks, vs, os_, lses, dos, ranks, n, True, scale, VirtualRing())
        ring = [torch.cat(x, 1) for x in (os_, *grads)]
        ring_lse = torch.cat(lses, 1)
        o_full, lse_full = _fwd(q, k, v, True, scale)
        full = [o_full, *_bwd(q, k, v, o_full, lse_full, do, True, scale)]
        # The plain ring, one virtual rank at a time (its f32 graph at Llama's
        # shape is ~8 GB a rank), the gradients summed over the ranks.
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        plain_o, plain_g = [], [torch.zeros(x.shape, dtype=torch.float32, device=dev)
                                for x in leaves]
        for my in ranks:
            qp, kp, vp = (list(x.split(seq // n, 1)) for x in leaves)
            o = plain_ring(qp[my], kp[my], vp[my], my, n, True, scale,
                           lambda step, _k, _v, my=my, kp=kp, vp=vp:
                           (kp[(my - step - 1) % n], vp[(my - step - 1) % n]))
            for acc, gr in zip(plain_g, torch.autograd.grad(o, leaves, dos[my])):
                acc += gr.float()
            plain_o.append(o.detach())
        plain = [torch.cat(plain_o, 1), *plain_g]
        names = ("o", "dq", "dk", "dv")
        line = {"phase": "ring_check", "case": name, "shape": [bh, seq, hd], "ring": n,
                "dtype": dtype_name, "causal": True, "blocks": n * (n + 1) // 2,
                "lse_max_abs_err_vs_full": (ring_lse - lse_full).abs().max().item()}
        for ref_name, ref in (("plain_ring", plain), ("full_call", full)):
            line[f"max_abs_err_vs_{ref_name}"] = dict(zip(names, [
                (a.float() - b.float()).abs().max().item() for a, b in zip(ring, ref)]))
            line[f"rel_err_vs_{ref_name}"] = dict(zip(names, [
                rel_err(a, b) for a, b in zip(ring, ref)]))
        if dtype == torch.float32:
            tol = dict(zip(names, [F32_FWD_TOL] + [F32_BWD_TOL] * 3))
            ok = all(line[f"max_abs_err_vs_{r}"][x] <= tol[x]
                     for r in ("plain_ring", "full_call") for x in names)
            line["tol_abs"] = tol
            ok = ok and line["lse_max_abs_err_vs_full"] <= F32_FWD_TOL
        else:
            ok = all(line[f"rel_err_vs_{r}"][x] <= RING_BF16_REL
                     for r in ("plain_ring", "full_call") for x in names)
            line["tol_rel"], line["tol_lse"] = RING_BF16_REL, RING_LSE_TOL
            ok = ok and line["lse_max_abs_err_vs_full"] <= RING_LSE_TOL
        del plain, plain_o, plain_g, leaves
        if not on_cpu:
            from ray_tpu_torch.ops.flash_attention import _bwd_cuda, _bwd_plain, _fwd_plain

            deltas = [_delta(o, d_) for o, d_ in zip(os_, dos)]
            pairs = [(my, (my - step) % n) for step in range(n) for my in ranks
                     if (my - step) % n <= my]

            def blocks_fwd():
                for my, src in pairs:
                    _fwd(qs[my], ks[src], vs[src], src == my, scale)

            def blocks_bwd():
                for my, src in pairs:
                    _bwd_cuda(qs[my], ks[src], vs[src], dos[my], lses[my], deltas[my],
                              src == my, scale)

            def blocks_fwd_plain():
                for my, src in pairs:
                    _fwd_plain(qs[my], ks[src], vs[src], src == my, scale)

            def blocks_bwd_plain():
                for my, src in pairs:
                    _bwd_plain(qs[my], ks[src], vs[src], os_[my], lses[my], dos[my], src == my,
                               scale)

            delta_full = _delta(o_full, do)
            # One SDPA call on the whole sequence: the library's time for the
            # work the ring's blocks share out.
            q4, k4, v4 = (x[None].detach().requires_grad_() for x in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            o4 = sdpa(q4, k4, v4, is_causal=True)

            def sdpa_fwd():
                with torch.no_grad():
                    sdpa(q4, k4, v4, is_causal=True)

            line["ms"] = {
                "sdpa_full_fwd": cuda_ms(sdpa_fwd, calls=5, reps=5),
                "sdpa_full_bwd": cuda_ms(lambda: torch.autograd.grad(
                    o4, (q4, k4, v4), do[None], retain_graph=True), calls=5, reps=5),
                "blocks_fwd": cuda_ms(blocks_fwd, calls=5, reps=5),
                "full_call_fwd": cuda_ms(lambda: _fwd(q, k, v, True, scale), calls=5, reps=5),
                "ring_fwd": cuda_ms(lambda: ring_forward(qs, ks, vs, ranks, n, True, scale,
                                                         VirtualRing()), calls=5, reps=5),
                "blocks_bwd": cuda_ms(blocks_bwd, calls=5, reps=5),
                "blocks_fwd_plain": cuda_ms(blocks_fwd_plain, calls=1, reps=3),
                "blocks_bwd_plain": cuda_ms(blocks_bwd_plain, calls=1, reps=3),
                "full_call_bwd": cuda_ms(lambda: _bwd_cuda(q, k, v, do, lse_full, delta_full,
                                                           True, scale), calls=5, reps=5),
                "ring_bwd": cuda_ms(lambda: ring_backward(qs, ks, vs, os_, lses, dos, ranks, n,
                                                          True, scale, VirtualRing()),
                                    calls=5, reps=5)}
            line["timing"] = ("device ms per call: events around 5 back-to-back calls, median "
                              "of 5; blocks_* the block kernels alone (all ranks' blocks), "
                              "ring_* with the merge and the f32 sums, blocks_*_plain the "
                              "blocks' plain versions (1 call, median of 3), sdpa_full_* one "
                              "scaled_dot_product_attention call on the whole sequence")
            del q4, k4, v4, o4
            line["card"] = smi
        line["ok"] = ok
        emit(line)
        lines.append(line)
        require(ok, f"ring_check {name}: the ring disagrees with the plain ring or the full call")
        del q, k, v, do, qs, ks, vs, dos, os_, lses, grads, ring, full
        if not on_cpu:
            torch.cuda.empty_cache()
    return lines


def bubble_share(stages, microbatches):
    """GPipe's idle share of a stage: (P - 1) / (M + P - 1) of the ticks."""
    return (stages - 1) / (microbatches + stages - 1)


def pipe_ctx_expected_launches(mesh, n_layer, global_batch):
    """Each rank's launches of each kernel per step, by world rank: its
    stage's layers (all of them off a pipeline), once per microbatch of its
    batch shard (M / batch shards on a pipeline, else 1), times the blocks
    its context rank r attends (r + 1: the past slices and the diagonal)."""
    from ray_tpu_torch.parallel import AXIS_ORDER
    from ray_tpu_torch.parallel.pipeline import default_microbatches

    shape = [mesh.get(a, 1) for a in AXIS_ORDER]
    pp, shards = mesh.get("pipeline", 1), mesh.get("data", 1) * mesh.get("fsdp", 1)
    per_shard = default_microbatches(global_batch, pp) // shards if pp > 1 else 1
    context = [int(c) for c in np.unravel_index(np.arange(int(np.prod(shape))), shape)[
        AXIS_ORDER.index("context")]]
    return [n_layer // pp * per_shard * (c + 1) for c in context]


def phase_pipe_ctx_gang(smi, main_loss, main_gnorm):
    """GPT-2 small at full width and depth through ``TorchTrainer`` on
    ``{"pipeline": 2}`` and on ``{"context": 2}``: two workers holding 0.5
    GPU each on the one card, over gloo, global B 16 x S 1024, the main
    path's weights and batch, 1 warmup and ``PIPE_CTX_TIMED`` timed steps.
    Returns rank 0's launches on each."""
    from ray_tpu_torch.air import ScalingConfig

    out_launches = {}
    for name, mesh in (("pipeline_gang", {"pipeline": 2}), ("context_gang", {"context": 2})):
        scaling = ScalingConfig(num_workers=2, use_gpu=True, gpus_per_worker=0.5, mesh=mesh)
        config = {"model": "gpt2_small", "global_batch": B, "seq": S, "warmup": 1,
                  "timed": PIPE_CTX_TIMED}
        out = run_mesh_gang(scaling, "gloo", config, f"chip_smoke_{name}")
        ranks = out["ranks"]
        r0 = ranks[0]
        expected = pipe_ctx_expected_launches(mesh, 12, B)
        line = {"phase": "pipe_ctx_gang", "name": name, "entry": "TorchTrainer.fit",
                "mesh": mesh, "backend": "gloo", "num_workers": 2, "gpus_per_worker": 0.5,
                "global_batch": B, "seq": S, "mesh_shape": r0["mesh_shape"],
                "losses": r0["losses"], "grad_norms": r0["grad_norms"],
                "main_path_first_loss": main_loss, "main_path_first_grad_norm": main_gnorm,
                "first_loss_abs_err_vs_main_path": abs(r0["losses"][0] - main_loss),
                "first_grad_norm_rel_err_vs_main_path": abs(r0["grad_norms"][0] - main_gnorm)
                / main_gnorm,
                "tol": {"loss_abs": LOSS_TOL, "grad_norm_rel": GRAD_NORM_RTOL},
                "expected_launches_per_rank_per_step": expected,
                "per_rank": [{k: r[k] for k in (
                    "rank", "pid", "device", "step_ms_timed", "step_ms_median", "items_per_s",
                    "launches_per_step", "collective_ms_per_step", "p2p_overlap_per_step",
                    "peak_memory_gib", "state_peak_gib", "init_s")} for r in ranks],
                "fit_s": out["fit_s"], "leftover_session_dirs": out["leftover_session_dirs"],
                "leftover_worker_pids": out["leftover_worker_pids"], "card": smi}
        if "pipeline" in mesh:
            m = line["microbatches"] = expected[0] // (12 // mesh["pipeline"])
            line["bubble_share"] = bubble_share(mesh["pipeline"], m)
        emit(line)
        require(all(r["losses"] == r0["losses"] for r in ranks), f"{name}: ranks disagree")
        require(line["first_loss_abs_err_vs_main_path"] <= LOSS_TOL,
                f"{name}: first loss {r0['losses'][0]} vs the main path's {main_loss}")
        require(line["first_grad_norm_rel_err_vs_main_path"] <= GRAD_NORM_RTOL,
                f"{name}: first grad norm {r0['grad_norms'][0]} vs the main path's {main_gnorm}")
        for r, n in zip(ranks, expected):
            check_launches(f"{name} rank {r['rank']}", r, n)
            require(all(math.isfinite(x) for x in r["losses"]), f"{name}: losses {r['losses']}")
        require(not out["leftover_session_dirs"] and not out["leftover_worker_pids"],
                f"{name}: left after shutdown: {out['leftover_session_dirs']}, "
                f"{out['leftover_worker_pids']}")
        out_launches[name] = r0["launches"]
    return out_launches


def run_pipe_ctx_phases(smi):
    """``ring_check`` and ``pipe_ctx_gang`` alone, against the main path's
    first step taken here (``tools/port_chip_phases.py pipe_ctx``)."""
    import torch

    from ray_tpu_torch.ops import _build

    _build.build()
    cfg, opt, state, batch = build_workload()
    state, _, run = run_steps(cfg, opt, state, batch, warmup=0, timed=1)
    del state, batch
    torch.cuda.empty_cache()
    phase_ring_check(smi)
    return phase_pipe_ctx_gang(smi, run["losses"][0], run["grad_norms"][0])


def run_mesh_rest_phases(smi):
    """``moe`` (for its first loss and grad norm), ``expert_tp_gang``,
    ``elastic_reshard`` and ``rl_mesh_learner`` alone
    (``tools/port_chip_phases.py mesh_rest``)."""
    from ray_tpu_torch.ops import _build

    _build.build()
    _, moe_loss, moe_gnorm = phase_moe(smi)
    phase_expert_tp_gang(smi, moe_loss, moe_gnorm)
    phase_elastic_reshard(smi)
    phase_rl_mesh_learner(smi)


def check_launches(path, run, per_step):
    """Each step of ``run`` launched each kernel ``per_step`` times."""
    for i, counts in enumerate(run["launches_per_step"]):
        require(len(counts) == 2 and all(n == per_step for n in counts.values()),
                f"{path} step {i}: kernel launches {counts}, expected {per_step} each")


# ---------------------------------------------------------------------------- RLlib
# The RL phases' CartPole: gymnasium's CartPole-v1 (envs/classic_control/
# cartpole.py: dynamics, thresholds, reset draw) under its 500-step TimeLimit,
# in numpy, so the path needs no gymnasium.
CARTPOLE_MAX_STEPS = 500
# PPO and DQN as the JAX package's tests train CartPole
# (tests/test_rllib.py:23-42 and :267-289) and their bars there.
PPO_ITERS, PPO_GAIN = 12, 30.0
DQN_MAX_ITERS, DQN_BAR = 25, 60.0
TWO_LEARNER_ITERS = 2
# rl_learner_check: a learner on the card against one on the CPU, from the
# same weights and minibatches, full f32 (no TF32). Losses, aux and grad norm
# per update: |a - b| <= RL_TOL * max(|b|, 1) (relative, with a floor of 1
# for values near 0, whose f32 sums of O(1) terms carry absolute rounding
# error); params after the updates: absolute.
RL_UPDATES, RL_TOL, RL_PARAM_TOL = 10, 1e-5, 1e-5
RL_PROFILED = 10


class DiscreteSpace:
    """The attributes of a gymnasium ``Discrete`` space the port reads."""

    def __init__(self, n):
        self.n, self.shape, self.dtype = n, (), np.int64


class BoxSpace:
    """The attributes of a gymnasium ``Box`` space the port reads."""

    def __init__(self, low, high):
        self.low, self.high = low, high
        self.shape, self.dtype = low.shape, low.dtype


class CartPole:
    """gymnasium's ``CartPole-v1`` (``gym.make("CartPole-v1")``) in numpy:
    Euler steps of the cart-pole equations, termination past 2.4 m or 12
    degrees, reward 1 per step, truncation at 500 steps, and the reset state
    drawn uniform in [-0.05, 0.05) from ``np.random.default_rng(seed)``, the
    generator ``gymnasium.utils.seeding.np_random`` builds."""

    gravity, masscart, masspole, length, force_mag, tau = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02
    theta_threshold_radians, x_threshold = 12 * 2 * math.pi / 360, 2.4

    def __init__(self, max_episode_steps=CARTPOLE_MAX_STEPS):
        self.max_episode_steps = max_episode_steps
        self.total_mass = self.masspole + self.masscart
        self.polemass_length = self.masspole * self.length
        high = np.array([self.x_threshold * 2, np.inf, self.theta_threshold_radians * 2, np.inf],
                        dtype=np.float32)
        self.observation_space = BoxSpace(-high, high)
        self.action_space = DiscreteSpace(2)
        self.np_random, self.state, self.elapsed = None, None, 0

    def reset(self, *, seed=None, options=None):
        if seed is not None or self.np_random is None:
            self.np_random = np.random.default_rng(seed)
        self.state = self.np_random.uniform(low=-0.05, high=0.05, size=(4,))
        self.elapsed = 0
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot) * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta) / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(x < -self.x_threshold or x > self.x_threshold
                          or theta < -self.theta_threshold_radians
                          or theta > self.theta_threshold_radians)
        self.elapsed += 1
        truncated = self.elapsed >= self.max_episode_steps
        return np.array(self.state, dtype=np.float32), 1.0, terminated, truncated, {}

    def close(self):
        pass


def ppo_config():
    """PPO as tests/test_rllib.py:23-42 trains it, on the numpy CartPole."""
    from ray_tpu_torch.rllib import PPOConfig

    return (PPOConfig().environment(CartPole)
            .env_runners(num_env_runners=2, num_envs_per_runner=4, rollout_fragment_length=64)
            .training(lr=3e-4, gamma=0.99, lambda_=0.95, minibatch_size=128, num_epochs=4,
                      entropy_coeff=0.01))


def dqn_config():
    """DQN as tests/test_rllib.py:267-289 trains it, on the numpy CartPole."""
    from ray_tpu_torch.rllib import DQNConfig

    return (DQNConfig().environment(CartPole)
            .env_runners(num_env_runners=2, num_envs_per_runner=4, rollout_fragment_length=64)
            .training(lr=1e-3, gamma=0.99, learning_starts=500, train_batch_size=64,
                      updates_per_iteration=48, target_network_update_freq=100,
                      epsilon_decay_steps=6000))


def rl_learner_inputs(kind, seed=0):
    """One loss's module, loss function, optimizer, weights, extra state and
    RL_UPDATES minibatches, from numpy seed ``seed``, at the shapes PPO and DQN
    train CartPole with (obs 4, 2 actions; PPO's minibatch 128 rows, DQN's
    train batch 64). ``kind``: "ppo", "dqn" (double Q), "dqn_weighted" (its
    loss weights as prioritized replay's importance weights, in [0.2, 1],
    and 0 on every eighth row, a truncation) or "c51" (51 atoms)."""
    from ray_tpu_torch.models import params_to_numpy
    from ray_tpu_torch.rllib.algorithms.dqn import make_c51_loss, make_dqn_loss
    from ray_tpu_torch.rllib.algorithms.ppo import make_ppo_loss
    from ray_tpu_torch.rllib.core.distributional import DistributionalQModule
    from ray_tpu_torch.rllib.core.learner import adam
    from ray_tpu_torch.rllib.core.rl_module import MLPModule, QMLPModule

    rng = np.random.default_rng(seed)
    obs_dim, n_act = 4, 2
    if kind == "ppo":
        cfg = ppo_config()
        module, loss, rows = MLPModule(obs_dim, n_act), make_ppo_loss(cfg), cfg.minibatch_size
    else:
        cfg = dqn_config()
        if kind == "c51":
            cfg.training(num_atoms=51)
            module, loss = DistributionalQModule(obs_dim, n_act, num_atoms=51, dueling=False), \
                make_c51_loss(cfg)
        else:
            module, loss = QMLPModule(obs_dim, n_act), make_dqn_loss(cfg)
        rows = cfg.train_batch_size
    weights = params_to_numpy(module.init(seed, device="cpu"))
    extra = None if kind == "ppo" else {"target_params": weights}

    def batch():
        b = {"obs": rng.standard_normal((rows, obs_dim)).astype(np.float32),
             "actions": rng.integers(0, n_act, rows)}
        if kind == "ppo":
            b.update(logp=np.log(rng.uniform(0.3, 0.7, rows)).astype(np.float32),
                     behavior_logits=(0.1 * rng.standard_normal((rows, n_act))).astype(np.float32),
                     advantages=rng.standard_normal(rows).astype(np.float32),
                     value_targets=rng.standard_normal(rows).astype(np.float32),
                     kl_coeff=np.full(rows, cfg.kl_coeff, np.float32))
        else:
            b.update(rewards=np.ones(rows, np.float32),
                     next_obs=rng.standard_normal((rows, obs_dim)).astype(np.float32),
                     terminateds=(rng.random(rows) < 0.05).astype(np.float32),
                     loss_weight=np.ones(rows, np.float32))
            if kind == "dqn_weighted":
                b["loss_weight"] = rng.uniform(0.2, 1.0, rows).astype(np.float32)
                b["loss_weight"][::8] = 0.0
        return b

    return module, loss, adam(cfg.lr, cfg.grad_clip), weights, extra, [batch() for _ in range(RL_UPDATES)]


def rl_rel_err(a, b):
    """max |a - b| / max(max |b|, 1), for floats and arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1.0))


def profile_updates(learner, batches):
    """``learner.update`` on each batch under ``torch.profiler``: per update,
    the device's busy time, the kernels launched, and the host-to-device and
    device-to-host copies, beside the untraced wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            learner.update(b)
        torch.cuda.synchronize()
    n = len(batches)
    busy_us, kernels, h2d, d2h = 0.0, 0, 0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        busy_us += e.self_device_time_total
        if e.key.startswith("Memcpy HtoD"):
            h2d += e.count
        elif e.key.startswith("Memcpy DtoH"):
            d2h += e.count
        elif not e.key.startswith(("Memcpy", "Memset")):
            kernels += e.count
    return {"device_busy_us_per_update": busy_us / n, "kernels_per_update": kernels / n,
            "h2d_copies_per_update": h2d / n, "d2h_copies_per_update": d2h / n,
            "h2d_bytes_per_update": sum(v.nbytes for b in batches for v in b.values()) / n}


def phase_rl_learner_check(smi, device="cuda"):
    """A TorchLearner on ``device`` against one on the CPU, from the same
    numpy weights and minibatches: RL_UPDATES updates of PPO's loss, DQN's
    (double Q) and C51's (51 atoms), each update's losses, aux and grad norm
    compared, the params after the last; then RL_PROFILED more updates on the
    card under the profiler."""
    from ray_tpu_torch.models.training import tree_leaves
    from ray_tpu_torch.rllib import TorchLearner

    lines = []
    for kind in ("ppo", "dqn", "c51"):
        module, loss, opt, weights, extra, batches = rl_learner_inputs(kind)
        learner, ref_learner = (TorchLearner(module, loss, optimizer=opt, device=dev)
                                for dev in (device, "cpu"))
        for lr in (learner, ref_learner):
            lr.set_weights(weights)
            lr.set_extra(extra)
        host_ms, errs = [], []
        for b in batches:
            t0 = time.perf_counter()
            got = learner.update(b)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            ref = ref_learner.update(b)
            errs.append({k: rl_rel_err(got[k], ref[k]) for k in ref})
        param_err = max(float(np.max(np.abs(a - b))) for a, b in
                        zip(tree_leaves(learner.get_weights()), tree_leaves(ref_learner.get_weights())))
        worst = {k: max(e[k] for e in errs) for k in errs[0]}
        line = {"phase": "rl_learner_check", "loss": kind, "device": device,
                "placement": learner.placement(), "updates": len(batches),
                "rows": len(batches[0]["obs"]), "max_rel_err_per_key": worst,
                "param_max_abs_err": param_err, "tol_rel": RL_TOL, "tol_param_abs": RL_PARAM_TOL,
                "host_ms_per_update": host_ms, "host_ms_per_update_median": statistics.median(host_ms),
                "card": smi}
        if device == "cuda":
            more = batches[:RL_PROFILED]
            t0 = time.perf_counter()
            for b in more:
                learner.update(b)
            wall_us = (time.perf_counter() - t0) * 1e6 / len(more)
            line["profile"] = profile_updates(learner, more)
            line["profile"]["host_wall_us_per_update"] = wall_us
            line["profile"]["device_idle_share"] = (
                1 - line["profile"]["device_busy_us_per_update"] / wall_us)
        lines.append(line)
        emit(line)
        require(line["placement"]["device"].startswith(device),
                f"rl_learner_check {kind}: params on {line['placement']['device']}")
        require(max(worst.values()) <= RL_TOL, f"rl_learner_check {kind}: {worst}")
        require(param_err <= RL_PARAM_TOL, f"rl_learner_check {kind}: params {param_err}")
    return lines


def rl_placement(algo, device):
    """The learners' and runners' placement, checked: every learner's params
    on ``device``, every runner a CPU process that sees no GPU."""
    import ray_tpu_torch

    learners = algo.learner_group.placement()
    runners = ray_tpu_torch.get([r.placement.remote() for r in algo.env_runners])
    require(all(p["device"].startswith(device) for p in learners), f"learners on {learners}")
    require(all(r["cuda_visible_devices"] == "" and r["device"] == "cpu" for r in runners),
            f"runners {runners}: expected CUDA_VISIBLE_DEVICES '' and the CPU")
    return {"learners": learners, "runners": runners}


def rl_iteration(result, steps):
    """One train() result as the RL phases print it."""
    learn_s, updates = result.get("learn_time_s"), result.get("num_learner_updates", 0)
    return {"iteration": result["training_iteration"], "return": result.get("episode_return_mean"),
            "total_loss": result.get("total_loss"), "sample_s": result["sample_time_s"],
            "learn_s": learn_s, "iteration_s": result["time_this_iter_s"],
            "env_steps_per_s": steps / result["sample_time_s"],
            "updates": updates, "updates_per_s": updates / learn_s if learn_s else None}


def phase_ppo(smi, device="cuda"):
    """PPO on the numpy CartPole through ``PPOConfig().build().train()``:
    the learner on ``device``, two runners on CPU actors, PPO_ITERS
    iterations; the JAX test's bar, best return > first + PPO_GAIN."""
    import ray_tpu_torch

    cfg = ppo_config()
    steps = cfg.num_env_runners * cfg.num_envs_per_runner * cfg.rollout_fragment_length
    t0 = time.perf_counter()
    algo = cfg.build()
    build_s = time.perf_counter() - t0
    placement = rl_placement(algo, device)
    rows = [rl_iteration(algo.train(), steps) for _ in range(PPO_ITERS)]
    pids = runtime_worker_pids()
    algo.stop()
    returns = [r["return"] for r in rows if r["return"] is not None]
    line = {"phase": "ppo", "env": "CartPole-v1 (numpy)", "iterations": PPO_ITERS,
            "env_steps_per_iteration": steps, "minibatch_size": cfg.minibatch_size,
            "num_epochs": cfg.num_epochs, "build_s": build_s, "placement": placement,
            "per_iteration": rows, "first_return": returns[0] if returns else None,
            "best_return": max(returns) if returns else None,
            "gymnasium_installed": importlib.util.find_spec("gymnasium") is not None,
            "node_resources": ray_tpu_torch.cluster_resources(), "worker_pids": sorted(pids),
            "card": smi}
    emit(line)
    require(returns, "ppo: no episode finished")
    require(all(math.isfinite(r["total_loss"]) for r in rows), f"ppo: losses {rows}")
    require(line["best_return"] > line["first_return"] + PPO_GAIN,
            f"ppo: no learning, first {line['first_return']} best {line['best_return']}")
    return line


def phase_dqn(smi, device="cuda"):
    """DQN on the numpy CartPole through ``DQNConfig().build().train()``
    until the best return reaches DQN_BAR or DQN_MAX_ITERS iterations."""
    cfg = dqn_config()
    steps = cfg.num_env_runners * cfg.num_envs_per_runner * cfg.rollout_fragment_length
    t0 = time.perf_counter()
    algo = cfg.build()
    build_s = time.perf_counter() - t0
    placement = rl_placement(algo, device)
    rows, best = [], 0.0
    for _ in range(DQN_MAX_ITERS):
        result = algo.train()
        rows.append(dict(rl_iteration(result, steps), epsilon=result["epsilon"],
                         buffer_size=result["buffer_size"]))
        best = max(best, result.get("episode_return_mean", 0.0))
        if best >= DQN_BAR:
            break
    pids = runtime_worker_pids()
    algo.stop()
    line = {"phase": "dqn", "env": "CartPole-v1 (numpy)", "iterations": len(rows),
            "env_steps_per_iteration": steps, "train_batch_size": cfg.train_batch_size,
            "updates_per_iteration": cfg.updates_per_iteration, "build_s": build_s,
            "placement": placement, "per_iteration": rows, "best_return": best,
            "worker_pids": sorted(pids), "card": smi}
    emit(line)
    trained = [r["total_loss"] for r in rows if r["total_loss"] is not None]
    require(trained and all(math.isfinite(x) for x in trained), f"dqn: losses {trained}")
    require(best >= DQN_BAR, f"dqn: best return {best} < {DQN_BAR}")
    return line


def phase_ppo_two_learners(smi):
    """PPO with two remote learners holding half the GPU each, for
    TWO_LEARNER_ITERS iterations; both learners' weights equal after each."""
    import ray_tpu_torch
    from ray_tpu_torch.models.training import tree_leaves

    algo = ppo_config().learners(num_learners=2, num_gpus_per_learner=0.5).build()
    placement = rl_placement(algo, "cuda")
    gpu_total = ray_tpu_torch.cluster_resources().get("GPU")
    gpu_free = ray_tpu_torch.available_resources().get("GPU")
    rows, equal = [], []
    for _ in range(TWO_LEARNER_ITERS):
        result = algo.train()
        rows.append({"iteration": result["training_iteration"], "total_loss": result["total_loss"],
                     "learn_s": result["learn_time_s"], "updates": result["num_learner_updates"]})
        weights = ray_tpu_torch.get([lr.get_weights.remote() for lr in algo.learner_group._remote])
        equal.append(all(np.array_equal(a, b) for a, b in
                         zip(tree_leaves(weights[0]), tree_leaves(weights[1]))))
    pids = runtime_worker_pids()
    algo.stop()
    line = {"phase": "ppo_two_learners", "num_learners": 2, "num_gpus_per_learner": 0.5,
            "node_gpu": gpu_total, "node_gpu_available_with_learners": gpu_free,
            "placement": placement, "per_iteration": rows, "weights_equal": equal,
            "worker_pids": sorted(pids), "card": smi}
    emit(line)
    require(gpu_total == 1 and gpu_free == 0, f"GPU {gpu_total} total, {gpu_free} free: "
            "expected two learners holding 0.5 each")
    require(all(p["cuda_visible_devices"] == "0" for p in placement["learners"]),
            f"learners see {placement['learners']}")
    require(all(math.isfinite(r["total_loss"]) for r in rows), f"ppo_two_learners: {rows}")
    require(all(equal), f"ppo_two_learners: weights equal per round {equal}")
    return line


def run_rl_phases(smi):
    """The RL phases: the learner check, then PPO, DQN and two learners on
    one runtime, whose shutdown is checked to leave no session directory and
    no worker process behind. None launches an attention kernel."""
    import ray_tpu_torch
    from ray_tpu_torch.ops import launch_counts

    before, start = launch_counts(), time.perf_counter()
    phase_rl_learner_check(smi)
    phase_rl_mesh_learner(smi)
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4)
    init_s = time.perf_counter() - t0
    session_dir = ray_tpu_torch._private.worker.global_worker.session_dir
    require(ray_tpu_torch.cluster_resources().get("GPU") == 1,
            f"node resources {ray_tpu_torch.cluster_resources()}: expected GPU: 1")
    pids = set()
    for phase in (phase_ppo, phase_dqn, phase_ppo_two_learners):
        pids |= set(phase(smi)["worker_pids"])
    t0 = time.perf_counter()
    ray_tpu_torch.shutdown()
    shutdown_s = time.perf_counter() - t0
    leftover_dirs = [session_dir] if os.path.exists(session_dir) else []
    leftover_pids = sorted(pid for pid in pids if pid_alive(pid))
    line = {"phase": "rl_shutdown", "rl_phases_s": time.perf_counter() - start,
            "init_s": init_s, "shutdown_s": shutdown_s,
            "run_worker_pids": sorted(pids), "leftover_session_dirs": leftover_dirs,
            "leftover_worker_pids": leftover_pids, "attention_kernel_launches":
            {k: n - before[k] for k, n in launch_counts().items()}}
    emit(line)
    require(not leftover_dirs, f"session directories left after shutdown: {leftover_dirs}")
    require(not leftover_pids, f"worker processes alive after shutdown: {leftover_pids}")
    require(not any(line["attention_kernel_launches"].values()),
            f"the RL phases launched attention kernels: {line['attention_kernel_launches']}")


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

    def check(case, shape, dtype, causal, seed, phase="kernel_check"):
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
        line = {"phase": phase, "case": case, "shape": list(shape), "dtype": str(dtype),
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

    def time_kernels(q, k, v, do, batch, plain_calls, plain_reps, one_call):
        """Device time per call of both bf16 kernels on (bh, S, hd) inputs,
        of their plain versions, and of one SDPA call on the same inputs
        viewed as (batch, heads, S, hd), beside the kernels' bounds."""
        bh_, s_, hd_ = q.shape
        scale = hd_ ** -0.5
        o, lse = _fwd_cuda(q, k, v, True, scale)
        delta = _delta(o, do)
        fwd = lambda: _fwd_cuda(q, k, v, True, scale)  # noqa: E731
        bwd = lambda: _bwd_cuda(q, k, v, do, lse, delta, True, scale)  # noqa: E731
        t = {"shape": [bh_, s_, hd_], "dtype": "bfloat16", "causal": True,
             "flash_fwd_ms": cuda_ms(fwd), "flash_bwd_ms": cuda_ms(bwd),
             "flash_fwd_plain_ms": cuda_ms(lambda: _fwd_plain(q, k, v, True, scale),
                                           calls=plain_calls, reps=plain_reps),
             "flash_bwd_plain_ms": cuda_ms(lambda: _bwd_plain(q, k, v, o, lse, do, True, scale),
                                           calls=plain_calls, reps=plain_reps)}
        q4, k4, v4 = (x.view(batch, -1, s_, hd_).detach().requires_grad_() for x in (q, k, v))
        do4 = do.view(batch, -1, s_, hd_)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        o4 = sdpa(q4, k4, v4, is_causal=True)

        def lib_fwd():
            with torch.no_grad():
                sdpa(q4, k4, v4, is_causal=True)

        lib_bwd = lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)  # noqa: E731
        t["sdpa_fwd_ms"], t["sdpa_bwd_ms"] = cuda_ms(lib_fwd), cuda_ms(lib_bwd)
        for which, (ms, by) in zip(("fwd", "bwd"), attention_bounds(bh_, s_, hd_)):
            t[f"flash_{which}_bound_ms"], t[f"flash_{which}_bound_by"] = ms, by
            t[f"flash_{which}_over_sdpa"] = t[f"flash_{which}_ms"] / t[f"sdpa_{which}_ms"]
        t["timing"] = "device time per call: events around 20 back-to-back calls, median of 7"
        if one_call:
            t["one_call"] = {"flash_fwd_ms": cuda_ms_one_call(fwd),
                             "sdpa_fwd_ms": cuda_ms_one_call(lib_fwd),
                             "flash_bwd_ms": cuda_ms_one_call(bwd),
                             "sdpa_bwd_ms": cuda_ms_one_call(lib_bwd)}
            t["one_call_timing"] = ("events around one call on an idle stream, median of 30: "
                                    "device time plus the host's enqueue")
        return t

    times = time_kernels(q, k, v, do, B, plain_calls=3, plain_reps=7, one_call=True)
    emit({"phase": "kernel_times", **times, "card": smi})
    fwd_ms, bwd_ms = times["flash_fwd_ms"], times["flash_bwd_ms"]
    fwd_plain_ms, bwd_plain_ms = times["flash_fwd_plain_ms"], times["flash_bwd_plain_ms"]
    lib_fwd_ms, lib_bwd_ms, one_call = times["sdpa_fwd_ms"], times["sdpa_bwd_ms"], times["one_call"]
    fwd_bound = times["flash_fwd_bound_ms"], times["flash_fwd_bound_by"]
    bwd_bound = times["flash_bwd_bound_ms"], times["flash_bwd_bound_by"]
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
    check_launches("main path", run, cfg.n_layer)
    require(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    loss_err = abs(losses[0] - ref_loss)
    gnorm_rel = abs(gnorms[0] - ref_gnorm) / ref_gnorm
    med_ms, tokens_per_s = run["step_ms_median"], run["items_per_s"]
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
    t_tokens_per_s = w["items_per_s"]
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
    check_launches("trainer", w, cfg.n_layer)
    require(all(math.isfinite(x) for x in t_losses), f"trainer: non-finite loss: {t_losses}")
    require(t_losses[-1] < t_losses[0], f"trainer: loss did not fall: {t_losses}")
    require(t_loss_err <= TRAINER_FIRST_LOSS_TOL,
            f"trainer first loss {t_losses[0]} vs main path {losses[0]}")
    require(not leftover_dirs, f"session directories left after shutdown: {leftover_dirs}")
    require(not leftover_pids, f"worker processes alive after shutdown: {leftover_pids}")

    # ------------------------------------------------------------------ 6b. collectives, the mesh
    phase_collective_nccl(smi)
    mesh_launches = phase_mesh_gang(smi, losses[0], gnorms[0])

    # ------------------------------------------------------------------ 6c. pipeline, context
    ring = phase_ring_check(smi)[0]  # the Llama shape's
    gang_launches = phase_pipe_ctx_gang(smi, losses[0], gnorms[0])

    # ------------------------------------------------------------------ 7. the Llama shape
    # Both bf16 kernels at Llama 3 8B's attention: bh 32 (B 1, 32 heads after
    # the kv heads are repeated), S 8192, d 128, causal.
    lbh, lhd = LLAMA_B * 32, 128
    llama_err = check("llama3_8b bf16 causal", (lbh, LLAMA_S, lhd), torch.bfloat16, True, seed=12,
                      phase="kernel_check_llama")
    q, k, v, do = inputs((lbh, LLAMA_S, lhd), torch.bfloat16, seed=13)
    llama_times = time_kernels(q, k, v, do, LLAMA_B, plain_calls=1, plain_reps=3, one_call=False)
    emit({"phase": "kernel_times_llama", **llama_times, "card": smi})
    del q, k, v, do
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 8. the model zoo
    zoo_launches = {"llama": phase_llama(smi)}
    zoo_launches["moe"], moe_loss, moe_gnorm = phase_moe(smi)
    phase_resnet50(smi)
    zoo_launches["remat_dots"] = phase_remat_dots(smi, losses[0], gnorms[0],
                                                  run["peak_memory_gib"])

    # ------------------------------------------------------------------ 8b. the rest of the mesh
    zoo_launches["expert_gang"] = phase_expert_tp_gang(smi, moe_loss, moe_gnorm)
    zoo_launches["elastic_reshard"] = phase_elastic_reshard(smi)

    # ------------------------------------------------------------------ 9. RLlib
    run_rl_phases(smi)

    # ------------------------------------------------------------------ 10. result
    launches_per_path = {name: {"main_path": launches[name], "trainer": t_launches[name],
                                "mesh_gang": mesh_launches[name],
                                **{path: n[name] for path, n in gang_launches.items()},
                                **{path: n[name] for path, n in zoo_launches.items()}}
                         for name in launches}

    def at_llama_shape(which, err):
        t = llama_times
        return {"shape": t["shape"], "ms": t[f"flash_{which}_ms"],
                "plain_ms": t[f"flash_{which}_plain_ms"],
                "bound_ms": t[f"flash_{which}_bound_ms"], "bound_by": t[f"flash_{which}_bound_by"],
                "library_ms": t[f"sdpa_{which}_ms"], "max_abs_err": err}

    def as_ring_blocks(which):
        return {"ring": ring["ring"], "blocks": ring["blocks"], "ms": ring["ms"][f"blocks_{which}"],
                "full_call_ms": ring["ms"][f"full_call_{which}"],
                "ring_ms": ring["ms"][f"ring_{which}"],
                "plain_ms": ring["ms"][f"blocks_{which}_plain"],
                "library_ms": ring["ms"][f"sdpa_full_{which}"]}

    kernels = {"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "ray_tpu/ops/flash_attention.py:59", "launches": launches["flash_fwd"],
         "launches_per_path": launches_per_path["flash_fwd"],
         "max_abs_err": main_err[0], "ms": fwd_ms, "plain_ms": fwd_plain_ms,
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": lib_fwd_ms,
         "ms_over_library_ms": fwd_ms / lib_fwd_ms, "ms_one_call": one_call["flash_fwd_ms"],
         "library_ms_one_call": one_call["sdpa_fwd_ms"],
         "llama_shape": at_llama_shape("fwd", llama_err[0]),
         "ring_blocks_llama_shape": as_ring_blocks("fwd")},
        {"name": "flash_bwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "ray_tpu/ops/flash_attention.py:160", "launches": launches["flash_bwd"],
         "launches_per_path": launches_per_path["flash_bwd"],
         "max_abs_err": main_err[1], "ms": bwd_ms, "plain_ms": bwd_plain_ms,
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "library_ms": lib_bwd_ms,
         "ms_over_library_ms": bwd_ms / lib_bwd_ms, "ms_one_call": one_call["flash_bwd_ms"],
         "library_ms_one_call": one_call["sdpa_bwd_ms"],
         "llama_shape": at_llama_shape("bwd", llama_err[1]),
         "ring_blocks_llama_shape": as_ring_blocks("bwd")},
    ]}
    problems = check_kernels_line(kernels, KERNEL_PATHS)
    require(not problems, f"kernels line: {problems}")
    emit(kernels)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
