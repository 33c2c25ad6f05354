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
6a. predictor: the main path's trained params through ``save_pytree`` and
   ``load_pytree`` (every leaf equal bit for bit; save s, load s and the
   ``pytree.pkl`` bytes printed), then ``TorchPredictor.from_checkpoint`` on
   the card scoring the workload's batch as ``{"tokens", "targets"}``: each
   position's next-token NLL, (B, S) f32 (the logits stay on the card), 12
   forward and 0 backward launches per ``predict``, the mean NLL within 1e-3
   of ``loss_fn`` on the same params and batch; the median ``predict`` ms
   over 10 calls, inference tokens/s and peak memory.
   Then Data, on a runtime of its own: ``batch_predictor``, the same params
   scoring a Dataset of 256 rows (16 blocks of 16) through
   ``BatchPredictor.predict(ds, batch_size=16, num_workers=2)`` on two pool
   actors that share the card (0.5 GPU each, one device id), each call's
   launches (12 forward, 0 backward) counted in its actor, every row's NLLs
   against the in-process ``TorchPredictor``'s on the same blocks, the node's
   ``GPU`` held while the actors live and free after; ``data_ingest``, the
   main path's workload for 4 steps through ``TorchTrainer(datasets=
   {"train": ds})`` on one GPU worker reading
   ``session.get_dataset_shard("train").iter_torch_batches(batch_size=16)``:
   the batches CUDA tensors, 12 + 12 launches a step, the first loss against
   ``first_step_reference`` on the rows the worker got; ``data_shutdown``.
   Then Serve, on a runtime of its own: ``serve``, the same params behind
   ``serve.start(http_options={"port": 0})`` in a deployment of two replicas
   holding 0.5 GPU each (one device id), whose ``__call__`` is an async
   ``@serve.batch(max_batch_size=16)`` method scoring rows of S + 1 token ids
   with ``TorchPredictor.from_checkpoint``: 128 rows as JSON POSTs from 32
   client threads through the proxy, then through a ``DeploymentHandle``,
   each reply's mean NLL within 1e-3 of the in-process predictor's, 12
   forward and 0 backward launches per batch call in each replica, the batch
   sizes summing to the requests sent, the node's ``GPU`` 0.0 free while
   serving and 1.0 after ``serve.shutdown()``; then one multiplexed replica
   (LRU of 2) over three GPT-2 small checkpoints asked m1, m2, m3, m1, each
   reply against its own model's NLL, each eviction giving back at least 90%
   of a model's bytes of ``memory_allocated``; replica start s, the
   controller's lock hold per replica start, cold and warm latency, requests/s
   and tokens/s over HTTP and the handle, the batch sizes formed, peak memory
   printed; ``serve_shutdown``.
   Then Tune, on a runtime of its own: ``tune``, first a Trainer sweep,
   ``Tuner(TorchTrainer(...))`` over ``{"train_loop_config": {"lr":
   grid_search([3e-4, 1e-3])}}``, each trial's gang one worker holding 0.5
   GPU, the main path's model from seed 0 at B 8 x S 1024 for 4 steps with a
   report each: both workers on device id "0" at once (the node's ``GPU`` 0.0
   free as the driver sees it), 12 + 12 launches a step in each, the first
   losses bit equal and within 1e-3 of plain attention on the same batch,
   ``get_best_result()`` the trial of the lower last loss; then PBT on two
   function trials holding 0.5 GPU each that train the same model in the
   trial actor at B 4 for 5 steps, reporting a ``Checkpoint.from_dict`` of
   params and AdamW state every 2 steps: at least one exploit, whose
   restarted actor holds the donor checkpoint's params on the card bit for
   bit (sha256) with the donor's config and lr explored, read in place; the
   journal and spec hold the param space's device tensor as a CPU tensor;
   ``GPU`` 1.0 free and no trial process left after each ``fit()``; each
   exploit's kill, actor start, CUDA, checkpoint read and onto-the-card
   seconds, the checkpoints' MB and persist seconds, trial actor starts,
   each trial's tokens/s, wall time and peak memory printed;
   ``tune_shutdown``.
   Then the operator's path, ``cli_job``: ``python -m ray_tpu_torch start
   --head --num-gpus 1 --dashboard-port 0`` (HOME a temporary directory),
   ``job submit`` of a script that joins the cluster through
   ``RAY_TPU_TORCH_ADDRESS`` and trains the main path's model from seed 0 at
   B 8 x S 1024 for 4 steps through ``TorchTrainer`` on one GPU worker; while
   the worker waits at step 1 for a KV flag, ``list actors`` shows it holding
   ``GPU`` 1.0 with device id "0" and the job's supervisor holding no GPU;
   after the job, ``job status`` SUCCEEDED, ``job logs`` with the script's
   line (the entrypoint saw ``CUDA_VISIBLE_DEVICES`` "", the worker "0" and
   ``cuda:0``, 12 + 12 launches a step, the first loss within 1e-3 of plain
   attention on the same batch), ``status`` with ``GPU`` 1.0 free, ``train
   --json`` (the goodput ledger: 4 steps, buckets summing to its wall time),
   ``timeline --output`` (the worker's task intervals); ``/api/cluster``,
   ``/api/jobs``, ``/api/train`` and ``/metrics`` agreeing with the CLI, no
   aiohttp in the head; then ``stop``: no process of the head's tree left,
   none on the card, its session directory gone. The read-only commands run
   as ``scripts.cli.main`` in this process; the seconds from head start to
   ready, from submit to RUNNING, to the first step and to SUCCEEDED, the
   warm tokens/s and the goodput fraction printed.
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
   against one rank's first step; ``elastic_reshard``, GPT-2 small at full
   width and 2 of its 12 layers (f32) under ``ScalingConfig(num_workers=2,
   elastic=True)``, each rank stashing its ``shard_for_rank`` of the params
   and Adam moments every step
   (``stash_checkpoint(rules=)``), rank 1 killed after round 3 by a
   ``PreemptionSimulator``: the gang re-forms at world 1 from the in-memory
   mirrors, the gathered state goes back on the card (``device_put_tree``)
   equal bit for bit to what both ranks held, and the final loss equals an
   uninterrupted one-rank run's within 1e-5.
9. RLlib (``ray_tpu_torch.rllib``), on numpy ``CartPole-v1`` and
   ``Pendulum-v1`` (no gymnasium on this path): ``rl_learner_check``, a
   ``TorchLearner`` on the card against one on the CPU from the same weights
   and minibatches, 10 updates each of PPO's, DQN's (double Q), C51's, A2C's,
   PG's, IMPALA's, APPO's, MARWIL's, SAC's, TD3's and CQL's loss, and each
   one's host ms, device busy time, kernels and copies per update (and the
   kernels of IMPALA's and APPO's V-trace loop);
   ``rl_mesh_learner``, two ``TorchLearner(mesh=)`` ranks on ``{"data":
   2}`` (each half of every minibatch's rows) against one on the whole
   minibatches, PPO's and DQN's 10 updates, DQN's also with importance
   weights; then on one
   runtime (``init(num_cpus=4)``) ``ppo`` (12 ``train()`` iterations of the
   JAX test's configuration, learner on the card, two runners on CPU actors;
   best return > first + 30), ``dqn`` (until best return >= 60, at most 25
   iterations), ``ppo_two_learners`` (two remote learners holding 0.5 GPU
   each, weights equal after each round), ``rl_onpolicy`` (A2C, PG, IMPALA,
   APPO by the JAX tests' bars), ``rl_continuous`` (SAC, TD3 on Pendulum),
   ``rl_apex`` (Ape-X DQN with 2 runners and 2 replay shards on CPU actors),
   ``rl_offline`` (BC and MARWIL from the trained PPO's episodes written
   with ``JsonWriter``, CQL from random data on a one-step task, BC again
   from a ``ray_tpu_torch.data`` Dataset of the PPO episodes' transitions
   through ``DatasetReader``, each evaluated on CPU runner actors), ``rl_multi_agent`` (PPO and DQN on two
   CartPole agents and SAC on two Pendulum agents, two policies each, one
   learner per policy on the card, by the JAX tests' bars; PPO's
   ``policies_to_train`` and ``save``/``restore`` of both policies), and
   ``rl_shutdown`` (nothing left after ``shutdown()``, no attention kernel
   launched by these phases).
10. a ``kernels`` line (launches per path: ``KERNEL_PATHS_BY_KERNEL``, the
   predictor's, the batch predictor's (its actors' sum) and Serve's (its
   replicas' sum) forward only; Tune's, every trial's summed; the CLI job's,
   its worker's; rank 0's on a gang; times at the Llama shape and of the ring's blocks with one SDPA
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
# The elastic_reshard phase: GPT-2 small at full width in f32 compute, its
# depth cut to ELASTIC_LAYERS of 12 (what it checks, a resume bit for bit and
# the final loss against an uninterrupted run, holds at any depth; the stash,
# digest and gloo all-reduce of each step scale with the params, and the cut
# keeps chip_smoke.py's run inside its time limit), ELASTIC_B rows of S 1024 a
# step, under ScalingConfig(num_workers=2, elastic=True) (two 0.5-GPU
# ranks over gloo, {data 2}); each step every rank stashes its shard of the
# params and Adam moments under ELASTIC_RULES (the large matrices split on
# dim 0, the rest replicated), and a PreemptionSimulator kills rank 1 after
# round ELASTIC_KILL_ROUND of ELASTIC_STEPS. f32 compute: its kernels and
# products are deterministic (the bf16 backward's dq is not, PERF.md), so the
# resumed state can be held bit for bit to what both ranks held, and the final
# loss to an uninterrupted one-rank run's within ELASTIC_LOSS_RTOL (the
# data-parallel steps sum the gradients' f32 parts in another order).
ELASTIC_STEPS, ELASTIC_KILL_ROUND, ELASTIC_B, ELASTIC_LAYERS = 6, 3, 8, 2
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
# The training paths the kernels line counts launches on: each must launch both
# kernels.
KERNEL_PATHS = ("main_path", "trainer", "mesh_gang", "pipeline_gang", "context_gang", "llama",
                "moe", "remat_dots", "expert_gang", "elastic_reshard", "data_ingest", "tune",
                "cli_job")
# The paths each kernel must launch on: the predictor, the batch predictor's
# pool actors and Serve's replicas (inference) run the forward only, so the
# backward must show 0 launches there.
KERNEL_PATHS_BY_KERNEL = {"flash_fwd": KERNEL_PATHS + ("predictor", "batch_predictor", "serve"),
                          "flash_bwd": KERNEL_PATHS}


def check_kernels_line(line, paths):
    """The problems of a ``kernels`` line, [] if none: each kernel has every
    key of ``KERNEL_KEYS``, a positive time and bound, a route and a bound_by
    of the contract's words, and was launched on each of ``paths`` (a
    sequence for every kernel, or a dict of one per kernel name: then a path
    a kernel is not named for must show no launch of it)."""
    problems = []
    for k in line["kernels"]:
        name = k.get("name", "?")
        expected = paths.get(name, ()) if isinstance(paths, dict) else paths
        problems += [f"{name}: no {key}" for key in KERNEL_KEYS if key not in k]
        if k.get("route") not in ("cuda", "triton"):
            problems.append(f"{name}: route {k.get('route')!r}")
        if k.get("bound_by") not in ("bytes", "operations"):
            problems.append(f"{name}: bound_by {k.get('bound_by')!r}")
        for key in ("ms", "plain_ms", "bound_ms"):
            if not (isinstance(k.get(key), (int, float)) and k[key] > 0):
                problems.append(f"{name}: {key} {k.get(key)!r}")
        per_path = k.get("launches_per_path", {})
        problems += [f"{name}: no launch on {p}" for p in expected if not per_path.get(p)]
        if isinstance(paths, dict):
            problems += [f"{name}: launched on {p}" for p, n in per_path.items()
                         if n and p not in expected]
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
    """GPT-2 small (f32, ``ELASTIC_LAYERS`` deep) under
    ``ScalingConfig(num_workers=2, elastic=True)``
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
    cut = (dict(n_layer=2, n_head=2, d_model=64, vocab_size=256, max_seq_len=128) if on_cpu
           else {"n_layer": ELASTIC_LAYERS})
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
            "backend": "gloo", "model": "gpt2_small", "n_layer": cfg.n_layer,
            "dtype": "float32", "global_batch": ELASTIC_B, "seq": seq, "steps": ELASTIC_STEPS,
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
        module, loss, opt, weights, extra, batches, _ = rl_learner_inputs(kind)
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
        module, loss, opt, weights, extra, batches, _ = rl_learner_inputs(kind)
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


# ---------------------------------------------------------------------------- the predictor
# The predictor phase: GPT-2 small's forward through TorchPredictor, PREDICT_CALLS
# timed calls after one warmup. Its mean next-token NLL is held to
# models.gpt.loss_fn on the same params and batch within PREDICT_LOSS_TOL: the
# same forward (kernels, bf16 compute, f32 head), reduced by another sum.
PREDICT_CALLS, PREDICT_LOSS_TOL = 10, 1e-3


def next_token_nll_fn(cfg):
    """An ``apply_fn`` for ``TorchPredictor``: each position's next-token
    NLL, (B, S) f32, from a ``{"tokens", "targets"}`` batch of (B, S) ids.
    The (B, S, vocab) f32 logits stay on the device."""
    import torch

    from ray_tpu_torch.models import gpt

    def apply(params, batch):
        logits = gpt.forward(params, batch["tokens"], cfg)
        target = torch.gather(logits, -1, batch["targets"].long()[..., None])[..., 0]
        return torch.logsumexp(logits, dim=-1) - target

    return apply


def phase_predictor(smi, params=None, cfg=None, device=None, batch=B, seq=S,
                    calls=PREDICT_CALLS):
    """GPT-2 small's params (the main path's after its steps; fresh ones from
    seed 0 when run alone) through ``save_pytree``/``load_pytree`` (every leaf
    equal bit for bit), then ``TorchPredictor.from_checkpoint`` on ``device``
    scoring the workload's batch as ``{"tokens", "targets"}``: per call
    n_layer forward launches and no backward, predictions finite of shape
    (B, S), their mean against ``loss_fn`` on the same params and batch.
    Returns the launches of the predict calls."""
    import shutil
    import tempfile

    import torch

    from ray_tpu_torch.air.checkpoint import Checkpoint, load_pytree, save_pytree
    from ray_tpu_torch.models import GPTConfig, init_params, loss_fn
    from ray_tpu_torch.models.training import tree_leaves
    from ray_tpu_torch.ops import launch_counts, reset_launch_counts
    from ray_tpu_torch.train import TorchPredictor

    cfg = cfg or GPTConfig.gpt2_small()
    t_start = time.perf_counter()
    if params is None:
        params = init_params(cfg, 0, device=device)
    device = tree_leaves(params)[0].device
    rng = np.random.default_rng(0)  # build_workload's batch
    tokens = rng.integers(0, cfg.vocab_size - 1, (batch, seq + 1)).astype(np.int32)
    feats = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    root = tempfile.mkdtemp(prefix="chip_smoke_predictor_")
    try:
        t0 = time.perf_counter()
        save_pytree(params, root)
        save_s = time.perf_counter() - t0
        pkl_bytes = os.path.getsize(os.path.join(root, "pytree.pkl"))
        t0 = time.perf_counter()
        loaded = load_pytree(root)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    src, got = tree_leaves(params), tree_leaves(loaded)
    bits_equal = len(src) == len(got) and all(
        a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.detach().cpu(), b)
        for a, b in zip(src, got))
    t0 = time.perf_counter()
    predictor = TorchPredictor.from_checkpoint(Checkpoint(data_dict={"params": loaded}),
                                               apply_fn=next_token_nll_fn(cfg), device=device)
    to_device_s = time.perf_counter() - t0
    placed = sorted({str(t.device) for t in tree_leaves(predictor.params)})
    with torch.inference_mode():
        ref_loss = loss_fn(params, {"tokens": torch.as_tensor(tokens, device=device)}, cfg).item()
    reset_peak_memory(device)
    reset_launch_counts()
    call_ms, per_call, preds = [], [], None
    for _ in range(1 + calls):
        before = launch_counts()
        device_sync(device)
        t0 = time.perf_counter()
        preds = predictor.predict(feats)["predictions"]  # numpy: the call waits for the card
        call_ms.append((time.perf_counter() - t0) * 1e3)
        after = launch_counts()
        per_call.append({k: after[k] - before[k] for k in after})
    launches = launch_counts()
    med_ms = statistics.median(call_ms[1:])
    mean_nll = float(np.mean(preds, dtype=np.float64))
    line = {"phase": "predictor", "n_layer": cfg.n_layer, "d_model": cfg.d_model,
            "entry": "TorchPredictor.from_checkpoint(...).predict", "batch": batch, "seq": seq,
            "dtype": str(cfg.dtype).replace("torch.", ""), "params_leaves": len(src),
            "save_s": save_s, "load_s": load_s, "pytree_pkl_bytes": pkl_bytes,
            "pytree_bits_equal": bits_equal, "to_device_s": to_device_s,
            "predictor_devices": placed, "predictions_shape": list(preds.shape),
            "predictions_dtype": str(preds.dtype),
            "predictions_finite": bool(np.isfinite(preds).all()),
            "mean_nll": mean_nll, "loss_fn": ref_loss, "mean_nll_abs_err": abs(mean_nll - ref_loss),
            "tol": PREDICT_LOSS_TOL, "predict_ms_warmup": call_ms[0],
            "predict_ms_timed": call_ms[1:], "predict_ms_median": med_ms,
            "inference_tokens_per_s": batch * seq / (med_ms / 1e3),
            "launches_per_call": per_call, "launches": launches,
            "peak_memory_gib": peak_memory_gib(device),
            "wall_s": time.perf_counter() - t_start, "card": smi}
    emit(line)
    require(bits_equal, "predictor: a leaf changed through save_pytree/load_pytree")
    require(placed == [str(device)], f"predictor: params on {placed}, expected {device}")
    require(line["predictions_shape"] == [batch, seq] and preds.dtype == np.float32
            and line["predictions_finite"], f"predictor: predictions {preds.shape} {preds.dtype}")
    require(line["mean_nll_abs_err"] <= PREDICT_LOSS_TOL,
            f"predictor: mean NLL {mean_nll} vs loss_fn {ref_loss}")
    require(all(c == {"flash_fwd": cfg.n_layer, "flash_bwd": 0} for c in per_call),
            f"predictor: launches per call {per_call}, expected {cfg.n_layer} forward, 0 backward")
    return launches


# ---------------------------------------------------------------------------- Data
# The batch_predictor phase: BATCH_PREDICT_ROWS rows of S tokens ({"tokens",
# "targets"} int32 from numpy seed 0, in blocks of B rows) scored by
# BatchPredictor.predict on a pool of BATCH_PREDICT_WORKERS actors that share
# the one card (num_gpus_per_worker None: 1/2 each, packed onto one device id),
# one block of B rows a call. Each row's NLLs are held to the in-process
# TorchPredictor's on the same rows within BATCH_PREDICT_TOL: the same kernels,
# shapes, weights and batch composition, so bit equality is expected (and
# printed); the limit is the predictor phase's (PREDICT_LOSS_TOL), which any
# other rounding of the bf16 forward stays far inside.
BATCH_PREDICT_ROWS, BATCH_PREDICT_WORKERS, BATCH_PREDICT_TOL = 256, 2, 1e-3
# The data_ingest phase: INGEST_STEPS train steps of the main path's workload
# through TorchTrainer(datasets={"train": ds}) on one GPU worker, each step's
# batch of B rows (S + 1 tokens, numpy seed 0) from
# session.get_dataset_shard("train").iter_torch_batches(batch_size=B). The
# first loss is held to first_step_reference on the rows the worker got, with
# the main path's limit against plain attention (LOSS_TOL).
INGEST_STEPS = 4


def count_plain_attention():
    """Count each call of the attention's plain version on CPU tensors as a
    launch of its kernel, in this process: a CPU rehearsal of the Data
    phases (whose pool actors and train worker are processes of their own)
    then reads the launch counts the card's run reads. Never called on the
    card."""
    # The module (the package's ``flash_attention`` attribute is the function).
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    def counting(fn, wrapper):
        def call(*args):
            wrapper.launches += 1
            return fn(*args)

        return call

    fa._fwd = counting(fa._fwd, fa._fwd_cuda)
    fa._bwd = counting(fa._bwd, fa._bwd_cuda)


def phase_batch_predictor(smi, params=None, cfg=None, device=None, rows=BATCH_PREDICT_ROWS,
                          batch=B, seq=S, workers=BATCH_PREDICT_WORKERS):
    """GPT-2 small's params (the main path's trained ones; fresh from seed 0
    when run alone) scored over a Dataset by ``BatchPredictor.predict`` on an
    actor pool that shares the card, against the in-process
    ``TorchPredictor`` on the same blocks. Each actor reports its own launch
    counts, device and the node's free ``GPU`` with every call's rows.
    Returns the phase's line (``launches``: the pool's, summed over its
    actors)."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.models import GPTConfig, init_params
    from ray_tpu_torch.models.training import tree_leaves
    from ray_tpu_torch.train import BatchPredictor, TorchPredictor

    cfg = cfg or GPTConfig.gpt2_small()
    t_start = time.perf_counter()
    if params is None:
        params = init_params(cfg, 0, device=device)
    device = tree_leaves(params)[0].device
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size - 1, (rows, seq + 1)).astype(np.int32)
    ds = rd.from_items([{"tokens": t[:-1], "targets": t[1:], "row": i}
                        for i, t in enumerate(tokens)], parallelism=rows // batch)
    ckpt = Checkpoint.from_dict({"params": params})
    apply_fn = next_token_nll_fn(cfg)

    class CountingPredictor(TorchPredictor):
        """``TorchPredictor`` that adds to each call's rows what this phase
        checks: the actor's pid, the call's launches (counted from 0 when the
        actor built its predictor), its device and ``CUDA_VISIBLE_DEVICES``,
        the node's free ``GPU``, its start and ready times and peak memory."""

        def __init__(self, *args, **kwargs):
            from ray_tpu_torch.ops import reset_launch_counts

            super().__init__(*args, **kwargs)
            if self.device.type == "cpu":
                count_plain_attention()
            reset_launch_counts()
            self.calls, self.stamps = 0, (process_start_time(), time.time())

        def predict(self, batch):
            from ray_tpu_torch.ops import launch_counts

            before, t0 = launch_counts(), time.perf_counter()
            out = super().predict(batch)  # numpy: the call waited for the card
            call_ms, after = (time.perf_counter() - t0) * 1e3, launch_counts()
            self.calls += 1
            n = len(out["predictions"])
            extra = {"pid": os.getpid(), "call": self.calls, "device": str(self.device),
                     "visible": os.environ.get("CUDA_VISIBLE_DEVICES", ""),
                     "gpu_free": ray_tpu_torch.available_resources().get("GPU", 0.0),
                     "process_start": self.stamps[0], "ready": self.stamps[1],
                     "peak_memory_gib": peak_memory_gib(self.device),
                     "call_ms": call_ms, "call_end": time.time(),
                     **{k: after[k] - before[k] for k in after}}
            return {**out, **{k: np.full(n, v) for k, v in extra.items()}}

    # The in-process predictor on the same blocks, one call a block.
    local = TorchPredictor.from_checkpoint(ckpt, apply_fn=apply_fn, device=device)
    blocks = [{"tokens": tokens[i:i + batch, :-1], "targets": tokens[i:i + batch, 1:]}
              for i in range(0, rows, batch)]
    local.predict(blocks[0])  # warmup
    device_sync(device)
    t0 = time.perf_counter()
    want = np.concatenate([local.predict(b)["predictions"] for b in blocks])
    local_s = time.perf_counter() - t0
    del local
    if device.type == "cuda":
        torch.cuda.empty_cache()

    gpu_total = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
    bp = BatchPredictor.from_checkpoint(ckpt, CountingPredictor, apply_fn=apply_fn,
                                        device=None if device.type == "cuda" else "cpu")
    t_submit, t0 = time.time(), time.perf_counter()
    scored = bp.predict(ds, feature_columns=["tokens", "targets"], keep_columns=["row"],
                        batch_size=batch, num_workers=workers).take_all()
    pool_s, t_done = time.perf_counter() - t0, time.time()
    deadline = time.monotonic() + 10
    while (ray_tpu_torch.available_resources().get("GPU", 0.0) < gpu_total
           and time.monotonic() < deadline):
        time.sleep(0.1)
    gpu_free_after = ray_tpu_torch.available_resources().get("GPU", 0.0)

    scored.sort(key=lambda r: int(r["row"]))
    got = np.stack([r["predictions"] for r in scored]) if scored else np.zeros((0, seq))
    calls = {(int(r["pid"]), int(r["call"])): r for r in scored}
    per_call = [{"flash_fwd": int(r["flash_fwd"]), "flash_bwd": int(r["flash_bwd"])}
                for r in calls.values()]
    actors = {}
    for r in scored:
        a = actors.setdefault(int(r["pid"]), {
            "pid": int(r["pid"]), "device": str(r["device"]), "visible": str(r["visible"]),
            "process_start_s": float(r["process_start"]) - t_submit,
            "ready_s": float(r["ready"]) - t_submit, "calls": 0, "rows": 0,
            "call_ms": [], "call_end_s": [], "peak_memory_gib": 0.0, "flash_fwd": 0,
            "flash_bwd": 0})
        a["rows"] += 1
        a["peak_memory_gib"] = max(a["peak_memory_gib"], float(r["peak_memory_gib"]))
    for (pid, _), r in sorted(calls.items()):
        actors[pid]["calls"] += 1
        actors[pid]["call_ms"].append(float(r["call_ms"]))
        actors[pid]["call_end_s"].append(float(r["call_end"]) - t_submit)
        actors[pid]["flash_fwd"] += int(r["flash_fwd"])
        actors[pid]["flash_bwd"] += int(r["flash_bwd"])
    launches = {k: sum(a[k] for a in actors.values()) for k in ("flash_fwd", "flash_bwd")}
    diff = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    ready = max((t_submit + a["ready_s"] for a in actors.values()), default=t_done)
    # After each actor's first call (which loads the libraries a fresh CUDA
    # process loads on its first work): the calls that end after the later of
    # the two first calls, over the time from that end to the last call's.
    warm_from = max((a["call_end_s"][0] for a in actors.values()), default=0.0)
    warm = [e for a in actors.values() for e in a["call_end_s"][1:] if e > warm_from]
    warm_s = max(warm, default=warm_from) - warm_from
    line = {"phase": "batch_predictor", "n_layer": cfg.n_layer, "d_model": cfg.d_model,
            "entry": "BatchPredictor.from_checkpoint(...).predict(ds).take_all()",
            "rows": rows, "seq": seq, "batch_size": batch, "blocks": ds.num_blocks(),
            "num_workers": workers, "num_gpus_per_worker": "None (1/num_workers each)",
            "gpu_total": gpu_total, "gpu_free_during_calls": sorted({float(r["gpu_free"])
                                                                     for r in scored}),
            "gpu_free_after": gpu_free_after, "actors": sorted(actors.values(),
                                                               key=lambda a: a["pid"]),
            "launches_per_call": per_call, "launches": launches,
            "predictions_shape": list(got.shape), "predictions_dtype": str(got.dtype),
            "predictions_finite": bool(np.isfinite(got).all()),
            "max_abs_diff_vs_in_process": diff, "bit_equal_to_in_process": bool(diff == 0.0),
            "tol": BATCH_PREDICT_TOL, "pool_s": pool_s,
            "rows_per_s": rows / pool_s, "tokens_per_s": rows * seq / pool_s,
            "tokens_per_s_after_actors_ready": rows * seq / max(t_done - ready, 1e-9),
            "first_call_ms": [a["call_ms"][0] for a in actors.values() if a["call_ms"]],
            "warm_calls": len(warm), "warm_s": warm_s,
            "warm_tokens_per_s": len(warm) * batch * seq / warm_s if warm_s > 0 else None,
            "in_process_s": local_s, "in_process_rows_per_s": rows / local_s,
            "in_process_tokens_per_s": rows * seq / local_s,
            "wall_s": time.perf_counter() - t_start, "card": smi}
    emit(line)
    n_calls = rows // batch
    require(len(scored) == rows and [int(r["row"]) for r in scored] == list(range(rows)),
            f"batch_predictor: {len(scored)} rows scored of {rows}")
    require(got.shape == (rows, seq) and got.dtype == np.float32 and line["predictions_finite"],
            f"batch_predictor: predictions {got.shape} {got.dtype}")
    require(diff <= BATCH_PREDICT_TOL, f"batch_predictor: rows differ from the in-process "
                                       f"predictor's by {diff}")
    require(len(actors) == workers, f"batch_predictor: {len(actors)} actors scored, "
                                    f"expected {workers}")
    require(len(per_call) == n_calls and all(
        c == {"flash_fwd": cfg.n_layer, "flash_bwd": 0} for c in per_call),
        f"batch_predictor: launches per call {per_call}, expected {n_calls} calls of "
        f"{cfg.n_layer} forward and 0 backward")
    require(launches == {"flash_fwd": cfg.n_layer * n_calls, "flash_bwd": 0},
            f"batch_predictor: launches {launches}")
    if device.type == "cuda":
        visible = {a["visible"] for a in actors.values()}
        require(len(visible) == 1 and "" not in visible and all(
            a["device"].startswith("cuda") for a in actors.values()),
            f"batch_predictor: actors on {sorted(actors.values(), key=lambda a: a['pid'])}")
        require(line["gpu_free_during_calls"] == [0.0] and gpu_free_after == gpu_total == 1,
                f"batch_predictor: GPU free {line['gpu_free_during_calls']} during the calls, "
                f"{gpu_free_after} of {gpu_total} after")
    return line


def ingest_loop(config):
    """The data_ingest phase's per-worker loop: the main path's model and
    optimizer from seed 0, each step's batch from this worker's dataset
    shard through ``iter_torch_batches`` (``config["batch_device"]``: None,
    the GPU, on the card), each step's launches counted from 0; reports the
    losses, launches, the batches' devices and dtypes, the time each batch
    took to arrive, and the first batch's tokens."""
    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import create_train_state, default_optimizer, make_train_step
    from ray_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg, device = config["cfg"], config["device"]
    if device == "cpu":
        count_plain_attention()
    opt = default_optimizer(learning_rate=3e-4)
    state = create_train_state(cfg, 0, opt, device=device)
    step = make_train_step(cfg, opt)
    shard = session.get_dataset_shard("train")
    batches = shard.iter_torch_batches(batch_size=config["batch"], device=config["batch_device"])
    reset_launch_counts()
    out = {"losses": [], "launches_per_step": [], "batch_devices": [], "batch_dtypes": [],
           "batch_wait_ms": [], "step_ms": []}
    t0 = time.perf_counter()
    for b in batches:
        out["batch_wait_ms"].append((time.perf_counter() - t0) * 1e3)
        tokens = b["tokens"]
        if not out["losses"]:
            out["first_tokens"] = tokens.cpu().numpy().tolist()
        out["batch_devices"].append(str(tokens.device))
        out["batch_dtypes"].append(str(tokens.dtype).replace("torch.", ""))
        before = launch_counts()
        device_sync(tokens.device)
        t1 = time.perf_counter()
        state, m = step(state, {"tokens": tokens})
        device_sync(tokens.device)
        out["step_ms"].append((time.perf_counter() - t1) * 1e3)
        after = launch_counts()
        out["losses"].append(m["loss"].item())
        out["launches_per_step"].append({k: after[k] - before[k] for k in after})
        t0 = time.perf_counter()
    out.update(launches=launch_counts(), pid=os.getpid(),
               cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
               device=str(state.params["wte"].device),
               peak_memory_gib=peak_memory_gib(state.params["wte"].device))
    session.report(out)


def phase_data_ingest(smi, cfg=None, device=None, batch=B, seq=S, steps=INGEST_STEPS):
    """The main path's workload fed by Data: ``TorchTrainer(datasets=
    {"train": ds})`` on one GPU worker, whose loop reads its shard's
    ``iter_torch_batches()``. Checks the batches arrive as CUDA tensors, each
    step's launches, and the first loss against ``first_step_reference`` on
    the rows the worker got. Returns the phase's line (``launches``: the
    worker's)."""
    import torch

    import ray_tpu_torch
    import ray_tpu_torch.train.torch as rt_torch
    from ray_tpu_torch import data as rd
    from ray_tpu_torch._private.accelerators.gpu import resolve_device
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.models import GPTConfig, gpt
    from ray_tpu_torch.train.torch import TorchConfig

    cfg = cfg or GPTConfig.gpt2_small()
    on_cpu = device is not None and torch.device(device).type == "cpu"
    t_start = time.perf_counter()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size - 1, (steps * batch, seq + 1)).astype(np.int32)
    ds = rd.from_items([{"tokens": t} for t in tokens], parallelism=steps)
    session_dir = ray_tpu_torch._private.worker.global_worker.session_dir
    trainer = rt_torch.TorchTrainer(
        ingest_loop,
        train_loop_config={"cfg": cfg, "batch": batch, "device": "cpu" if on_cpu else None,
                           "batch_device": "cpu" if on_cpu else None},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=not on_cpu),
        backend_config=TorchConfig(device="cpu") if on_cpu else None,
        run_config=RunConfig(name="chip_smoke_data_ingest",
                             storage_path=os.path.join(session_dir, "results")),
        datasets={"train": ds})
    t0 = time.perf_counter()
    result = trainer.fit()
    fit_s = time.perf_counter() - t0
    if result.error is not None:
        raise result.error
    w = result.metrics
    first = np.asarray(w["first_tokens"], np.int32)
    ref_loss, _ = first_step_reference(
        cfg, {"tokens": torch.as_tensor(first, device=resolve_device(device))}, gpt)
    loss_err = abs(w["losses"][0] - ref_loss)
    line = {"phase": "data_ingest", "entry": "TorchTrainer(datasets={'train': ds}).fit",
            "reads": "session.get_dataset_shard('train').iter_torch_batches(batch_size=B)",
            "n_layer": cfg.n_layer, "batch": batch, "seq": seq, "rows": steps * batch,
            "blocks": steps, "worker_pid": w["pid"],
            "worker_cuda_visible_devices": w["cuda_visible_devices"],
            "worker_device": w["device"], "batch_devices": w["batch_devices"],
            "batch_dtypes": w["batch_dtypes"], "losses": w["losses"],
            "first_step_reference": ref_loss, "first_loss_abs_err": loss_err, "tol": LOSS_TOL,
            "first_rows_are_the_first_block": bool(np.array_equal(first, tokens[:batch])),
            "launches_per_step": w["launches_per_step"], "launches": w["launches"],
            "batch_wait_ms": w["batch_wait_ms"], "step_ms": w["step_ms"],
            "peak_memory_gib": w["peak_memory_gib"], "fit_s": fit_s,
            "wall_s": time.perf_counter() - t_start, "card": smi}
    emit(line)
    want = "cpu" if on_cpu else "cuda"
    require(len(w["losses"]) == steps and all(math.isfinite(x) for x in w["losses"]),
            f"data_ingest: losses {w['losses']}, expected {steps} finite")
    require(all(d.startswith(want) for d in w["batch_devices"] + [w["device"]]),
            f"data_ingest: batches on {w['batch_devices']}, model on {w['device']}")
    require(all(c == {"flash_fwd": cfg.n_layer, "flash_bwd": cfg.n_layer}
                for c in w["launches_per_step"]),
            f"data_ingest: launches per step {w['launches_per_step']}")
    require(loss_err <= LOSS_TOL, f"data_ingest: first loss {w['losses'][0]} vs "
                                  f"first_step_reference {ref_loss}")
    return line


def run_data_phases(smi, params=None, cfg=None, device=None, **sizes):
    """``batch_predictor`` and ``data_ingest`` on one runtime
    (``init(num_cpus=4)``), then its shutdown: no session directory and none
    of its worker processes left. ``sizes`` (``rows``, ``batch``, ``seq``)
    shrink them for a CPU rehearsal. Returns each phase's launches."""
    import ray_tpu_torch

    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4)
    init_s = time.perf_counter() - t0
    session_dir = ray_tpu_torch._private.worker.global_worker.session_dir
    pids = runtime_worker_pids()
    ingest = {k: v for k, v in sizes.items() if k in ("batch", "seq")}
    try:
        bp = phase_batch_predictor(smi, params, cfg, device, **sizes)
        pids |= {a["pid"] for a in bp["actors"]} | runtime_worker_pids()
        di = phase_data_ingest(smi, cfg, device, **ingest)
        pids |= {di["worker_pid"]} | runtime_worker_pids()
    finally:
        ray_tpu_torch.shutdown()
    leftover_dirs = [session_dir] if os.path.exists(session_dir) else []
    leftover_pids = sorted(pid for pid in pids if pid_alive(pid))
    emit({"phase": "data_shutdown", "init_s": init_s, "run_worker_pids": sorted(pids),
          "leftover_session_dirs": leftover_dirs, "leftover_worker_pids": leftover_pids,
          "data_phases_s": time.perf_counter() - t0})
    require(not leftover_dirs, f"session directories left after shutdown: {leftover_dirs}")
    require(not leftover_pids, f"worker processes alive after shutdown: {leftover_pids}")
    return {"batch_predictor": bp["launches"], "data_ingest": di["launches"]}


# ---------------------------------------------------------------------------- Serve
# The serve phase: GPT-2 small (the main path's trained params; fresh from seed
# 0 when run alone) behind Serve on the card. One deployment of SERVE_REPLICAS
# replicas holding SERVE_GPU_SHARE of the GPU each (packed onto one device id),
# whose __call__ is an async @serve.batch method of up to SERVE_MAX_BATCH rows
# that scores rows of S + 1 token ids with TorchPredictor.from_checkpoint and
# answers each row's mean next-token NLL. SERVE_ROWS rows (numpy seed 0) go in
# as one JSON POST each from SERVE_CLIENTS client threads (urllib) through the
# proxy's ephemeral port, then again through a DeploymentHandle from as many
# threads. Each reply is held to the in-process TorchPredictor's NLL for its row
# within SERVE_TOL: the same kernels and weights in another batch composition,
# so the predictor's limit (PREDICT_LOSS_TOL) holds them. Then one replica with
# @serve.multiplexed(max_num_models_per_replica=SERVE_MUX_CAPACITY) over
# GPT-2 small checkpoints of SERVE_MUX_SEEDS, asked for the models in
# SERVE_MUX_ORDER by the multiplexed-model-id header: each reply within
# SERVE_TOL of its own model's in-process NLL, and each eviction must give back
# at least SERVE_EVICT_SHARE of one model's parameter bytes of the replica's
# torch.cuda.memory_allocated (what is left is allocator rounding).
SERVE_ROWS, SERVE_CLIENTS, SERVE_REPLICAS, SERVE_GPU_SHARE = 128, 32, 2, 0.5
SERVE_MAX_BATCH, SERVE_TOL = 16, PREDICT_LOSS_TOL
# How long a batch waits for more rows once its first arrived (the reference's
# default is 10 ms): 32 clients' next rows reach a replica within a few ms of
# the batch they were in, so 50 ms lets a replica's next batch fill.
SERVE_BATCH_WAIT_S = 0.05
SERVE_MUX_SEEDS, SERVE_MUX_CAPACITY = (1, 2, 3), 2
SERVE_MUX_ORDER = ("m1", "m2", "m3", "m1")
SERVE_EVICT_SHARE = 0.9
# Serve's system actors' names (ray_tpu_torch.serve._private.common).
SERVE_ACTOR_PREFIXES = ("SERVE_CONTROLLER", "SERVE_PROXY", "SERVE_REPLICA::")


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else None


def _serve_traffic(send, rows, clients):
    """Send each row once through ``send(row)`` from ``clients`` threads;
    returns (replies in row order, per-request latency s, wall s)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(i):
        t0 = time.perf_counter()
        out = send(rows[i])
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=clients) as pool:
        done = list(pool.map(one, range(len(rows))))
    return [d[0] for d in done], [d[1] for d in done], time.perf_counter() - t0


def phase_serve(smi, params=None, cfg=None, device=None, rows=SERVE_ROWS, seq=S,
                clients=SERVE_CLIENTS, max_batch=SERVE_MAX_BATCH, mux_seeds=SERVE_MUX_SEEDS):
    """GPT-2 small served by Serve on GPU replicas, over HTTP and a handle,
    then a multiplexed replica over three checkpoints (see the constants
    above). Needs a running runtime. Returns the phase's line (``launches``:
    the replicas' own counts of the requests' batch calls)."""
    import gc
    import shutil
    import tempfile
    import urllib.request

    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.air.checkpoint import Checkpoint, load_pytree, save_pytree
    from ray_tpu_torch.models import GPTConfig, init_params
    from ray_tpu_torch.models.training import tree_leaves
    from ray_tpu_torch.train import TorchPredictor

    cfg = cfg or GPTConfig.gpt2_small()
    t_start = time.perf_counter()
    if params is None:
        params = init_params(cfg, 0, device=device)
    device = tree_leaves(params)[0].device
    on_cpu = device.type == "cpu"
    replica_device = "cpu" if on_cpu else None  # None: the replica's default, its GPU
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size - 1, (rows, seq + 1)).astype(np.int32)
    apply_fn = next_token_nll_fn(cfg)
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        ckpt = os.path.join(root, "main")
        save_pytree(params, ckpt)
        mux_dirs = {}
        for i, seed in enumerate(mux_seeds):
            mux_dirs[f"m{i + 1}"] = os.path.join(root, f"m{i + 1}")
            mux_params = init_params(cfg, seed, device=device)
            save_pytree(mux_params, mux_dirs[f"m{i + 1}"])
            del mux_params

        # The in-process predictor on the same rows, SERVE_MAX_BATCH a call.
        local = TorchPredictor(params, apply_fn, device=device)
        blocks = [{"tokens": tokens[i:i + max_batch, :-1], "targets": tokens[i:i + max_batch, 1:]}
                  for i in range(0, rows, max_batch)]
        local.predict(blocks[0])  # warmup
        device_sync(device)
        t0 = time.perf_counter()
        want = np.concatenate([local.predict(b)["predictions"] for b in blocks]).mean(
            axis=1, dtype=np.float64)
        local_s = time.perf_counter() - t0
        del local
        mux_rows = tokens[:len(SERVE_MUX_ORDER)]
        mux_want = {}
        for mid, d in mux_dirs.items():
            p = TorchPredictor.from_checkpoint(Checkpoint(data_dict={"params": load_pytree(d)}),
                                               apply_fn=apply_fn, device=device)
            mux_want[mid] = p.predict({"tokens": mux_rows[:, :-1], "targets": mux_rows[:, 1:]})[
                "predictions"].mean(axis=1, dtype=np.float64).tolist()
            del p
        if not on_cpu:
            torch.cuda.empty_cache()

        @serve.deployment(name="Ping")
        def ping(req):
            return "pong"

        @serve.deployment(name="GPT2", num_replicas=SERVE_REPLICAS, max_concurrent_queries=
                          2 * max_batch, ray_actor_options={"num_gpus": SERVE_GPU_SHARE})
        class GPT2Scorer:
            """GPT-2 small's mean next-token NLL per row; each reply also
            carries what the phase checks of the batch call it was in."""

            def __init__(self, ckpt_dir, cfg, device):
                import ray_tpu_torch.ops as ops
                from ray_tpu_torch.air.checkpoint import Checkpoint, load_pytree
                from ray_tpu_torch.train import TorchPredictor

                t0 = time.time()
                self.process_start = process_start_time()
                self.predictor = TorchPredictor.from_checkpoint(
                    Checkpoint(data_dict={"params": load_pytree(ckpt_dir)}),
                    apply_fn=next_token_nll_fn(cfg), device=device)
                self.device = self.predictor.device
                if self.device.type == "cpu":
                    count_plain_attention()
                # One call before the first request: a fresh CUDA process's
                # first work loads its libraries (seconds).
                row = np.zeros((1, 2), np.int32)
                self.predictor.predict({"tokens": row[:, :1], "targets": row[:, 1:]})
                ops.reset_launch_counts()
                self.constructor_s, self.calls = time.time() - t0, 0

            @serve.batch(max_batch_size=max_batch, batch_wait_timeout_s=SERVE_BATCH_WAIT_S)
            async def __call__(self, requests):
                import ray_tpu_torch.ops as ops

                rows = np.asarray([r.json() if hasattr(r, "json") else r for r in requests],
                                  np.int32)
                before, t0 = ops.launch_counts(), time.perf_counter()
                nll = self.predictor.predict({"tokens": rows[:, :-1], "targets": rows[:, 1:]})[
                    "predictions"]  # numpy: the call waited for the card
                call_ms, after = (time.perf_counter() - t0) * 1e3, ops.launch_counts()
                self.calls += 1
                extra = {"pid": os.getpid(), "call": self.calls, "batch_size": len(rows),
                         "call_ms": call_ms, "device": str(self.device),
                         "visible": os.environ.get("CUDA_VISIBLE_DEVICES", ""),
                         "gpu_free": ray_tpu_torch.available_resources().get("GPU", 0.0),
                         "constructor_s": self.constructor_s,
                         "process_start": self.process_start,
                         "peak_memory_gib": peak_memory_gib(self.device),
                         **{k: after[k] - before[k] for k in after}}
                return [{"nll": float(r.mean(dtype=np.float64)), **extra} for r in nll]

        @serve.deployment(name="GPT2Mux", max_concurrent_queries=4,
                          ray_actor_options={"num_gpus": SERVE_GPU_SHARE})
        class GPT2Multiplexed:
            """One GPT-2 small per multiplexed model id, at most
            SERVE_MUX_CAPACITY on the card; each eviction's memory_allocated
            before and after its unload is kept."""

            def __init__(self, dirs, cfg, device):
                self.dirs, self.cfg, self.device = dirs, cfg, device
                self.evictions, self.loads = [], []
                if device == "cpu":
                    count_plain_attention()

            @serve.multiplexed(max_num_models_per_replica=SERVE_MUX_CAPACITY)
            async def get_model(self, model_id):
                from ray_tpu_torch.air.checkpoint import Checkpoint, load_pytree
                from ray_tpu_torch.train import TorchPredictor

                t0 = time.perf_counter()
                predictor = TorchPredictor.from_checkpoint(
                    Checkpoint(data_dict={"params": load_pytree(self.dirs[model_id])}),
                    apply_fn=next_token_nll_fn(self.cfg), device=self.device)
                self.loads.append({"model": model_id, "s": time.perf_counter() - t0})
                evictions = self.evictions

                class Loaded:
                    def __init__(self, predictor):
                        self.predictor = predictor

                    def __serve_unload__(self):
                        # The LRU dropped its reference; the params go with
                        # the predictor.
                        dev = self.predictor.device
                        before = memory_allocated(dev)
                        self.predictor = None
                        gc.collect()
                        evictions.append({"model": model_id, "allocated_before": before,
                                          "allocated_after": memory_allocated(dev)})

                loaded = Loaded(predictor)
                del predictor  # Loaded holds the only reference
                return loaded

            async def __call__(self, req):
                import ray_tpu_torch.ops as ops

                model = await self.get_model()
                row = np.asarray(req.json(), np.int32)[None]
                before = ops.launch_counts()
                nll = model.predictor.predict({"tokens": row[:, :-1], "targets": row[:, 1:]})[
                    "predictions"]
                after = ops.launch_counts()
                dev = model.predictor.device
                del model
                return {"model": serve.get_multiplexed_model_id(),
                        "nll": float(nll[0].mean(dtype=np.float64)),
                        "cached": self.get_model._model_cache.model_ids(),
                        "allocated": memory_allocated(dev), "loads": list(self.loads),
                        "evictions": list(self.evictions), "pid": os.getpid(),
                        "visible": os.environ.get("CUDA_VISIBLE_DEVICES", ""),
                        **{k: after[k] - before[k] for k in after}}

        gpu_total = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
        serve.start(http_options={"port": 0})
        port = serve.http_port()
        base = f"http://127.0.0.1:{port}"
        serve.run(ping.bind(), route_prefix="/ping", port=0)

        def post(path, row, headers=None):
            req = urllib.request.Request(base + path, data=json.dumps(row).encode(),
                                         headers=headers or {}, method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read())

        # Deploy, while another thread times a request to the Ping deployment
        # through the proxy and a serve.status() call (the controller's lock),
        # one after the other, until the deploy returns.
        stall = {"ping_http_s": [], "status_s": []}
        deploying = threading.Event()
        deploying.set()

        def probe():
            while deploying.is_set():
                t0 = time.perf_counter()
                with urllib.request.urlopen(base + "/ping", timeout=300) as r:
                    r.read()
                stall["ping_http_s"].append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                serve.status()
                stall["status_s"].append(time.perf_counter() - t0)
                time.sleep(0.05)

        # serve.run's readiness barrier (every proxy routes the new prefix),
        # timed apart from the deploy.
        wait_routes, route_waits = serve.api._wait_routes_live, []

        def timed_wait_routes(prefix, timeout=30.0):
            t0 = time.perf_counter()
            try:
                wait_routes(prefix, timeout)
            finally:
                route_waits.append(time.perf_counter() - t0)

        prober = threading.Thread(target=probe, daemon=True)
        prober.start()
        serve.api._wait_routes_live = timed_wait_routes
        t0 = time.perf_counter()
        try:
            handle = serve.run(GPT2Scorer.bind(ckpt, cfg, replica_device), route_prefix="/gpt2",
                               port=0)
        finally:
            run_s = time.perf_counter() - t0
            serve.api._wait_routes_live = wait_routes
            deploying.clear()
            prober.join()
        status = serve.status()["GPT2"]
        rows_list = [t.tolist() for t in tokens]

        t0 = time.perf_counter()
        cold = post("/gpt2", rows_list[0])
        cold_s = time.perf_counter() - t0
        http, http_lat, http_s = _serve_traffic(lambda r: post("/gpt2", r), rows_list, clients)
        via_handle, handle_lat, handle_s = _serve_traffic(lambda r: handle.remote(r).result(),
                                                          rows_list, clients)
        gpu_free_serving = ray_tpu_torch.available_resources().get("GPU", 0.0)
        serve.delete("GPT2")

        mux = serve.run(GPT2Multiplexed.bind(mux_dirs, cfg, replica_device),
                        route_prefix="/mux", port=0)
        del mux
        mux_replies = [post("/mux", r.tolist(), {"serve_multiplexed_model_id": mid})
                       for mid, r in zip(SERVE_MUX_ORDER, mux_rows)]
        serve_pids = {r["pid"] for r in http + via_handle + mux_replies}
        t0 = time.perf_counter()
        serve.shutdown()
        shutdown_s = time.perf_counter() - t0
        deadline = time.monotonic() + 10
        while (ray_tpu_torch.available_resources().get("GPU", 0.0) < gpu_total
               or any(pid_alive(p) for p in serve_pids)) and time.monotonic() < deadline:
            time.sleep(0.1)
        gpu_free_after = ray_tpu_torch.available_resources().get("GPU", 0.0)
        alive = sorted(a["name"] for a in
                       ray_tpu_torch._private.worker.global_worker.context.list_actors()
                       if (a["name"] or "").startswith(SERVE_ACTOR_PREFIXES)
                       and a["state"] != "DEAD")
        alive_pids = sorted(p for p in serve_pids if pid_alive(p))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def batch_calls(replies):
        return {(r["pid"], r["call"]): r for r in replies}

    calls = batch_calls(http + via_handle + [cold])
    per_call = [{"flash_fwd": c["flash_fwd"], "flash_bwd": c["flash_bwd"]}
                for c in calls.values()]
    replicas = {}
    for c in calls.values():
        rep = replicas.setdefault(c["pid"], {
            "pid": c["pid"], "device": c["device"], "visible": c["visible"],
            "constructor_s": c["constructor_s"], "batch_calls": 0, "rows": 0,
            "peak_memory_gib": 0.0, "batch_sizes": []})
        rep["batch_calls"] += 1
        rep["rows"] += c["batch_size"]
        rep["batch_sizes"].append(c["batch_size"])
        rep["peak_memory_gib"] = max(rep["peak_memory_gib"], c["peak_memory_gib"])
    got_http = np.asarray([r["nll"] for r in http])
    got_handle = np.asarray([r["nll"] for r in via_handle])
    err_http = float(np.abs(got_http - want).max())
    err_handle = float(np.abs(got_handle - want).max())
    mux_err = [abs(r["nll"] - mux_want[mid][i])
               for i, (mid, r) in enumerate(zip(SERVE_MUX_ORDER, mux_replies))]
    evictions = mux_replies[-1]["evictions"]
    evict_drop = [e["allocated_before"] - e["allocated_after"] for e in evictions]
    mux_calls = [{"flash_fwd": r["flash_fwd"], "flash_bwd": r["flash_bwd"]} for r in mux_replies]
    launches = {k: sum(c[k] for c in per_call) + sum(c[k] for c in mux_calls)
                for k in ("flash_fwd", "flash_bwd")}
    line = {"phase": "serve", "n_layer": cfg.n_layer, "d_model": cfg.d_model,
            "entry": "serve.run(GPT2Scorer.bind(...)); HTTP POST /gpt2 and handle.remote",
            "rows": rows, "seq": seq, "clients": clients, "replicas": SERVE_REPLICAS,
            "num_gpus_per_replica": SERVE_GPU_SHARE, "max_batch_size": max_batch,
            "batch_wait_timeout_s": SERVE_BATCH_WAIT_S, "proxy_port": port,
            "gpu_total": gpu_total,
            "gpu_free_during_calls": sorted({float(c["gpu_free"]) for c in calls.values()}),
            "gpu_free_serving": gpu_free_serving, "gpu_free_after_shutdown": gpu_free_after,
            "replica_start_s": status["replica_start_s"],
            "controller_lock_held_per_replica_start_s": status["replica_start_s"],
            "serve_run_s": run_s, "serve_run_wait_routes_live_s": route_waits,
            "serve_run_minus_replica_starts_and_route_wait_s":
                run_s - sum(status["replica_start_s"]) - sum(route_waits),
            "other_deployment_stall": {
                "ping_http_max_s": max(stall["ping_http_s"], default=None),
                "ping_http_n": len(stall["ping_http_s"]),
                "status_call_max_s": max(stall["status_s"], default=None),
                "status_call_n": len(stall["status_s"])},
            "replicas_seen": sorted(replicas.values(), key=lambda r: r["pid"]),
            "cold_request_s": cold_s,
            "http": {"wall_s": http_s, "requests_per_s": rows / http_s,
                     "tokens_per_s": rows * seq / http_s,
                     "p50_s": _percentile(http_lat, 50), "p99_s": _percentile(http_lat, 99),
                     "max_abs_err_vs_in_process": err_http},
            "handle": {"wall_s": handle_s, "requests_per_s": rows / handle_s,
                       "tokens_per_s": rows * seq / handle_s,
                       "p50_s": _percentile(handle_lat, 50),
                       "p99_s": _percentile(handle_lat, 99),
                       "max_abs_err_vs_in_process": err_handle},
            "batch_sizes": sorted((c["batch_size"] for c in calls.values()), reverse=True),
            "batch_calls": len(calls), "batch_call_ms_median":
                statistics.median(c["call_ms"] for c in calls.values()),
            "launches_per_batch_call": per_call, "launches": launches,
            "in_process_s": local_s, "in_process_rows_per_s": rows / local_s,
            "in_process_tokens_per_s": rows * seq / local_s,
            "tol": SERVE_TOL,
            "multiplex": {"order": list(SERVE_MUX_ORDER), "seeds": list(mux_seeds),
                          "capacity": SERVE_MUX_CAPACITY,
                          "cached_after_each": [r["cached"] for r in mux_replies],
                          "allocated_after_each": [r["allocated"] for r in mux_replies],
                          "loads": mux_replies[-1]["loads"], "evictions": evictions,
                          "eviction_drop_bytes": evict_drop, "param_bytes": param_bytes,
                          "abs_err_vs_in_process": mux_err, "launches_per_call": mux_calls,
                          "visible": sorted({r["visible"] for r in mux_replies})},
            "shutdown_s": shutdown_s, "serve_actors_alive_after": alive,
            "serve_pids_alive_after": alive_pids,
            "wall_s": time.perf_counter() - t_start, "card": smi}
    emit(line)
    require(len(http) == len(via_handle) == rows and np.isfinite(got_http).all()
            and np.isfinite(got_handle).all(), f"serve: {len(http)} HTTP and {len(via_handle)} "
            f"handle replies of {rows}, finite {np.isfinite(got_http).all()}")
    require(err_http <= SERVE_TOL and err_handle <= SERVE_TOL,
            f"serve: replies differ from the in-process predictor by {err_http} (HTTP), "
            f"{err_handle} (handle)")
    require(abs(cold["nll"] - want[0]) <= SERVE_TOL, f"serve: cold reply {cold['nll']}")
    require(all(c == {"flash_fwd": cfg.n_layer, "flash_bwd": 0} for c in per_call),
            f"serve: launches per batch call {per_call}, expected {cfg.n_layer} forward, "
            f"0 backward")
    require(sum(c["batch_size"] for c in calls.values()) == 2 * rows + 1,
            f"serve: batch sizes {line['batch_sizes']} sum to "
            f"{sum(c['batch_size'] for c in calls.values())}, {2 * rows + 1} requests sent")
    require(len(replicas) == SERVE_REPLICAS and len(status["replica_start_s"]) == SERVE_REPLICAS,
            f"serve: {len(replicas)} replicas answered, expected {SERVE_REPLICAS}")
    require(max(mux_err) <= SERVE_TOL, f"serve: multiplexed replies off by {mux_err}")
    require(mux_calls == [{"flash_fwd": cfg.n_layer, "flash_bwd": 0}] * len(SERVE_MUX_ORDER),
            f"serve: multiplexed launches {mux_calls}")
    require([e["model"] for e in evictions] == ["m1", "m2"]
            and mux_replies[-1]["cached"] == ["m3", "m1"],
            f"serve: evictions {[e['model'] for e in evictions]}, "
            f"cached {mux_replies[-1]['cached']}")
    require(not alive and not alive_pids, f"serve: alive after shutdown: {alive} {alive_pids}")
    if not on_cpu:
        require({r["visible"] for r in replicas.values()} == {"0"} and all(
            r["device"].startswith("cuda") for r in replicas.values()),
            f"serve: replicas on {line['replicas_seen']}")
        require(line["gpu_free_during_calls"] == [0.0] and gpu_free_after == gpu_total == 1,
                f"serve: GPU free {line['gpu_free_during_calls']} while serving, "
                f"{gpu_free_after} of {gpu_total} after shutdown")
        require(all(d >= SERVE_EVICT_SHARE * param_bytes for d in evict_drop),
                f"serve: evictions gave back {evict_drop} bytes of {param_bytes}")
    return line


def memory_allocated(device):
    """``torch.cuda.memory_allocated`` in bytes on a card; 0 on the CPU."""
    import torch

    dev = torch.device(device)
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def run_serve_phase(smi, params=None, cfg=None, device=None, **sizes):
    """``serve`` on a runtime of its own (``init(num_cpus=4)``; on the CPU
    with one logical GPU, which no CUDA backs), then its shutdown: no session
    directory and none of its worker processes left. ``sizes`` (``rows``,
    ``seq``, ``clients``, ``max_batch``, ``mux_seeds``) shrink it for a CPU
    rehearsal. Returns the serve path's launches."""
    import torch

    import ray_tpu_torch

    on_cpu = device is not None and torch.device(device).type == "cpu"
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4, **({"num_gpus": 1} if on_cpu else {}))
    init_s = time.perf_counter() - t0
    session_dir = ray_tpu_torch._private.worker.global_worker.session_dir
    pids = runtime_worker_pids()
    try:
        line = phase_serve(smi, params, cfg, device, **sizes)
        pids |= {r["pid"] for r in line["replicas_seen"]} | runtime_worker_pids()
    finally:
        ray_tpu_torch.shutdown()
    leftover_dirs = [session_dir] if os.path.exists(session_dir) else []
    leftover_pids = sorted(pid for pid in pids if pid_alive(pid))
    emit({"phase": "serve_shutdown", "init_s": init_s, "run_worker_pids": sorted(pids),
          "leftover_session_dirs": leftover_dirs, "leftover_worker_pids": leftover_pids,
          "serve_phase_s": time.perf_counter() - t0})
    require(not leftover_dirs, f"session directories left after shutdown: {leftover_dirs}")
    require(not leftover_pids, f"worker processes alive after shutdown: {leftover_pids}")
    return line["launches"]


# ---------------------------------------------------------------------------- Tune
# The tune phase, on a runtime of its own whose object store holds a few of the
# PBT part's checkpoints at once (TUNE_SYSTEM_CONFIG). First a Trainer sweep:
# Tuner(TorchTrainer(tune_trainer_loop)) over param_space={"train_loop_config":
# {"lr": grid_search(TUNE_LRS)}}, each trial's gang one worker holding
# TUNE_GPU_SHARE of the card, the main path's model from seed 0 at TUNE_B rows
# of S tokens (numpy seed 0), TUNE_STEPS steps, a report every step. Both
# trials start from the same weights and batch through the same kernels, so
# their first losses are held to each other bit for bit, and to plain
# attention on the same batch in the driver with the main path's limit
# (LOSS_TOL). Then PBT on function trainables: two trials holding
# TUNE_GPU_SHARE each (resources_per_trial) train the same model in the trial
# actor at PBT_B rows for PBT_STEPS steps, from lr PBT_LRS (one far too small;
# the other's loss falls at every step, where 1e-3's and 3e-4's rise by the
# fourth on this batch, which would send the good trial to the bottom too),
# under PopulationBasedTraining(perturbation_interval=PBT_INTERVAL,
# hyperparam_mutations={"lr": PBT_MUTATIONS}); a trial reports a
# Checkpoint.from_dict of its params and AdamW state at each perturbation
# boundary only. The slow trial holds its boundary report until the other's
# checkpoint is persisted, so the driver reads it after the other's and the
# slow trial, in the bottom half, exploits it: exactly one exploit (left to
# the order of the two reports, PBT exploits at the first boundary or a later
# one, and a restored trial that still trails is exploited again, 22-28 s
# each on an H100). The restarted actor must hold the donor checkpoint's
# params on the card bit for bit (sha256 over the host bytes), with the
# donor's config and lr explored. The PBT param_space also holds a tensor on
# the device (PBT_PROBE), which Tune's journal and spec must hold as a CPU
# tensor.
TUNE_B, TUNE_STEPS, TUNE_LRS, TUNE_GPU_SHARE = 8, 4, (3e-4, 1e-3), 0.5
PBT_B, PBT_STEPS, PBT_INTERVAL = 4, 3, 2
PBT_LRS, PBT_MUTATIONS = (1e-5, 1e-4), [5e-5, 1e-4]
PBT_PROBE = (0.0, 1.0, 2.0, 3.0)
TUNE_SYSTEM_CONFIG = {"object_store_memory": 16 << 30}


def tune_batch(cfg, batch, seq, device):
    """``batch`` rows of ``seq`` + 1 tokens from numpy seed 0 on ``device``."""
    import torch

    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size - 1, (batch, seq + 1))
    return {"tokens": torch.as_tensor(tokens.astype(np.int32), device=device)}


def tune_steps(state, step, batch, steps, first, report):
    """Steps ``first`` to ``steps`` (1-based) of ``step`` on ``batch``, each
    one's launches counted from 0; ``report(i, state, record)`` after each
    with its loss, wall times, launches and what the phase checks of the
    process."""
    import ray_tpu_torch
    from ray_tpu_torch.ops import launch_counts, reset_launch_counts

    dev = state.params["wte"].device
    reset_launch_counts()
    reset_peak_memory(dev)
    for i in range(first, steps + 1):
        before = launch_counts()
        device_sync(dev)
        t0 = time.time()
        state, m = step(state, batch)
        loss = m["loss"].item()  # waits for the step
        t1 = time.time()
        after = launch_counts()
        report(i, state, {
            "loss": loss, "step": i, "t0": t0, "t1": t1,
            "launches": {k: after[k] - before[k] for k in after}, "pid": os.getpid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES", ""), "device": str(dev),
            "gpu_free": ray_tpu_torch.available_resources().get("GPU", 0.0),
            "peak_memory_gib": peak_memory_gib(dev)})


def wait_for_the_other_trials(key, n, timeout=120.0):
    """Put this process under the KV prefix ``key``, then wait until ``n``
    processes have, so that the trials train at the same time (Tune launches
    them one after the other, and each process takes seconds to start);
    returns the seconds waited."""
    from ray_tpu_torch._private.worker import global_worker

    kv = global_worker.context.kv
    kv("put", f"{key}/{os.getpid()}".encode(), b"1")
    t0 = time.time()
    while len(kv("keys", f"{key}/".encode())) < n and time.time() - t0 < timeout:
        time.sleep(0.05)
    return time.time() - t0


def tune_trainer_loop(config):
    """The tune phase's Trainer sweep, per worker: the main path's model and
    AdamW at ``config["lr"]`` from seed 0, ``config["steps"]`` steps on one
    batch, a report every step (``tune_steps``)."""
    stamps = {"process_start": process_start_time(), "loop_start": time.time()}
    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import create_train_state, default_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config["cfg"]
    if config["device"] == "cpu":
        count_plain_attention()
    opt = default_optimizer(learning_rate=config["lr"])
    state = create_train_state(cfg, 0, opt, device=config["device"])
    batch = tune_batch(cfg, config["batch"], config["seq"], state.params["wte"].device)
    stamps["workload_built"] = time.time()
    stamps["waited_for_the_other_trial_s"] = wait_for_the_other_trials(
        config["barrier"], config["trials"])

    def report(i, state, record):
        session.report({**record, "stamps": stamps})

    tune_steps(state, make_train_step(cfg, opt), batch, config["steps"], 1, report)


def wait_for_a_peer_checkpoint(timeout=120.0):
    """Wait until another trial of this experiment has a checkpoint persisted
    (a ``checkpoint_*`` directory in its trial directory, which the driver
    renames into place before it registers it); returns the seconds waited."""
    from ray_tpu_torch.air import session

    own = session.get_trial_dir()
    pattern = os.path.join(os.path.dirname(own), "*", "checkpoint_*")
    t0 = time.time()
    while (not [p for p in glob.glob(pattern) if not p.startswith(own + os.sep)]
           and time.time() - t0 < timeout):
        time.sleep(0.05)
    return time.time() - t0


def tune_pbt_trainable(config):
    """The tune phase's PBT trainable, in the trial actor (which holds a
    share of the card): the main path's model and AdamW at ``config["lr"]``,
    from seed 0 or from the checkpoint Tune hands it, moved onto the card;
    a report every step (``tune_steps``), with a ``Checkpoint.from_dict`` of
    the params, AdamW state, step, trial id and config at each perturbation
    boundary only; the trial of ``config["slow_lr"]`` holds each boundary
    report until the other trial's checkpoint is persisted. A restored
    trial's first report says what it restored:
    the donor's trial id and step, and the sha256 of the params as read and
    as they lie on the card; every report carries the process's start, CUDA,
    checkpoint read and checkpoint-on-card times."""
    stamps = {"process_start": process_start_time(), "start": time.time()}
    import torch

    from ray_tpu_torch._private.accelerators.gpu import resolve_device
    from ray_tpu_torch.air import session
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.models import TrainState, create_train_state, default_optimizer
    from ray_tpu_torch.models import make_train_step
    from ray_tpu_torch.models.training import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(config["device"])
    if dev.type == "cpu":
        count_plain_attention()
    torch.zeros(1, device=dev)
    device_sync(dev)
    stamps["cuda_ready"] = time.time()
    cfg, opt = config["cfg"], default_optimizer(learning_rate=config["lr"])
    ckpt, restored = session.get_checkpoint(), None
    if ckpt is None:
        state = create_train_state(cfg, 0, opt, device=dev)
        stamps["waited_for_the_other_trial_s"] = wait_for_the_other_trials(
            config["barrier"], config["trials"])
    else:
        saved = ckpt.to_dict()
        stamps["ckpt_read"] = time.time()
        params = tree_map(lambda t: t.to(dev).requires_grad_(True), saved["params"])
        opt_state = {"count": saved["opt"]["count"],
                     "mu": tree_map(lambda t: t.to(dev), saved["opt"]["mu"]),
                     "nu": tree_map(lambda t: t.to(dev), saved["opt"]["nu"])}
        state = TrainState(params=params, opt_state=opt_state, step=saved["step"])
        device_sync(dev)
        stamps["ckpt_on_card"] = time.time()
        restored = {"from_trial": saved["trial_id"], "from_step": saved["step"],
                    "sha_read": state_digest(saved["params"]), "sha_on_card": state_digest(params),
                    "devices": sorted({str(t.device) for t in tree_leaves(params)})}
        del saved
    batch = tune_batch(cfg, config["batch"], config["seq"], dev)
    first_step = state.step + 1

    def report(i, state, record):
        nonlocal restored
        record.update(stamps=stamps, restored=restored, lr=config["lr"])
        if i % config["interval"] == 0:
            if config["lr"] == config["slow_lr"] and restored is None:
                record["waited_for_a_peer_checkpoint_s"] = wait_for_a_peer_checkpoint()
            t0 = time.perf_counter()
            ckpt = Checkpoint.from_dict({"params": state.params, "opt": state.opt_state,
                                         "step": i, "trial_id": session.get_trial_id(),
                                         "config": dict(config)})
            record["checkpoint_from_dict_s"] = time.perf_counter() - t0
            session.report(record, checkpoint=ckpt)
        else:
            session.report(record)
        restored = None

    tune_steps(state, make_train_step(cfg, opt), batch, config["steps"], first_step, report)


def _tune_recorder():
    """A Tune callback that keeps every trial result with the driver's time
    and the node's free ``GPU`` as the driver sees it, and every trial start."""
    import ray_tpu_torch
    from ray_tpu_torch import tune

    class Recorder(tune.Callback):
        def __init__(self):
            self.results, self.starts = [], []

        def on_trial_start(self, iteration, trials, trial, **info):
            self.starts.append({"trial_id": trial.trial_id, "restarts": trial.restarts,
                                "t": time.time()})

        def on_trial_result(self, iteration, trials, trial, result, **info):
            self.results.append({**result, "trial_id": trial.trial_id,
                                 "restarts": trial.restarts, "t_driver": time.time(),
                                 "gpu_free_driver": ray_tpu_torch.available_resources().get(
                                     "GPU", 0.0)})

    return Recorder()


@contextlib.contextmanager
def tune_timings():
    """While the block runs, time each trial actor's launch (creation and
    session start) and teardown in Tune's runner, and each checkpoint
    persist in this process (seconds and bytes on disk)."""
    from ray_tpu_torch.train._internal.checkpoint_manager import CheckpointManager
    from ray_tpu_torch.tune.execution.trial_runner import TrialRunner

    rec = {"launch": [], "teardown": [], "persist": []}
    launch, teardown, register = TrialRunner._launch, TrialRunner._teardown, \
        CheckpointManager.register

    def timed_launch(self, trial):
        t0 = time.time()
        launch(self, trial)
        rec["launch"].append({"trial_id": trial.trial_id, "restarts": trial.restarts, "t0": t0,
                              "s": time.time() - t0})

    def timed_teardown(self, trial):
        t0 = time.time()
        teardown(self, trial)
        rec["teardown"].append({"trial_id": trial.trial_id, "status": trial.status, "t0": t0,
                                "s": time.time() - t0})

    def timed_register(self, checkpoint, metrics):
        t0 = time.time()
        out = register(self, checkpoint, metrics)
        path = out.uri[len("file://"):]
        rec["persist"].append({"run_dir": self.run_dir, "s": time.time() - t0, "bytes": sum(
            os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))})
        return out

    TrialRunner._launch, TrialRunner._teardown = timed_launch, timed_teardown
    CheckpointManager.register = timed_register
    try:
        yield rec
    finally:
        TrialRunner._launch, TrialRunner._teardown = launch, teardown
        CheckpointManager.register = register


def _wait_released(gpu_total, pids, timeout=10.0):
    """Wait until the node's ``GPU`` is all free and ``pids`` are gone (a
    killed CUDA process takes a moment to release its context); returns the
    free ``GPU`` and the pids still alive."""
    import ray_tpu_torch

    deadline = time.monotonic() + timeout
    while (ray_tpu_torch.available_resources().get("GPU", 0.0) < gpu_total
           or any(pid_alive(p) for p in pids)) and time.monotonic() < deadline:
        time.sleep(0.1)
    return (ray_tpu_torch.available_resources().get("GPU", 0.0),
            sorted(p for p in pids if pid_alive(p)))


def _by_trial(results):
    out = {}
    for r in results:
        out.setdefault(r["trial_id"], []).append(r)
    return out


def _tokens_per_s(reports, tokens):
    """Tokens a step over the median step of ``reports``, each process's
    first step left out (it carries a fresh CUDA process's first work)."""
    warm = [r for prev, r in zip(reports, reports[1:]) if prev["pid"] == r["pid"]] or reports
    return tokens / statistics.median(r["t1"] - r["t0"] for r in warm)


def same_config(a, b, skip=()):
    """Whether two trial configs hold the same keys and values (tensors
    compared by value), apart from the keys in ``skip``."""
    import torch

    if set(a) != set(b):
        return False
    for k in set(a) - set(skip):
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                    and torch.equal(x.cpu(), y.cpu())):
                return False
        elif x != y:
            return False
    return True


def phase_tune(smi, cfg=None, device=None, batch=TUNE_B, pbt_batch=PBT_B, seq=S,
               steps=TUNE_STEPS, pbt_steps=PBT_STEPS):
    """The Trainer sweep and PBT of the constants above, on the running
    runtime (which must have one ``GPU``). Returns the phase's line
    (``launches``: every trial's, summed)."""
    import pickle
    import tempfile

    import torch

    import ray_tpu_torch
    import ray_tpu_torch.train.torch as rt_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch._private.accelerators.gpu import resolve_device
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.models import GPTConfig, gpt
    from ray_tpu_torch.tune.schedulers import PopulationBasedTraining

    cfg = cfg or GPTConfig.gpt2_small()
    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    trial_device = "cpu" if on_cpu else None  # None: the trial's default, its GPU
    t_start = time.perf_counter()
    session_dir = ray_tpu_torch._private.worker.global_worker.session_dir
    results_dir = os.path.join(session_dir, "results")
    gpu_total = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
    tmp_before = set(glob.glob(os.path.join(tempfile.gettempdir(), "ray_tpu_torch_ckpt_*")))

    # ---------------------------------------------------------- the Trainer sweep
    trainer = rt_torch.TorchTrainer(
        tune_trainer_loop,
        train_loop_config={"cfg": cfg, "batch": batch, "seq": seq, "steps": steps,
                           "device": trial_device, "barrier": "chip_smoke_tune_sweep",
                           "trials": len(TUNE_LRS)},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                     gpus_per_worker=TUNE_GPU_SHARE),
        backend_config=rt_torch.TorchConfig(device="cpu") if on_cpu else None,
        run_config=RunConfig(name="chip_smoke_tune_trainer", storage_path=results_dir))
    rec = _tune_recorder()
    tuner = tune.Tuner(
        trainer, param_space={"train_loop_config": {"lr": tune.grid_search(list(TUNE_LRS))}},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=RunConfig(name="chip_smoke_tune_sweep", storage_path=results_dir,
                             callbacks=[rec]))
    with tune_timings() as timing:
        t0 = time.perf_counter()
        grid = tuner.fit()
        sweep_s = time.perf_counter() - t0
    by_trial = _by_trial(rec.results)
    sweep_pids = {r["pid"] for r in rec.results}
    gpu_free_after, alive = _wait_released(gpu_total, sweep_pids)
    ref_loss, _ = first_step_reference(cfg, tune_batch(cfg, batch, seq, dev), gpt)
    trials = []
    for tid, reports in by_trial.items():
        reports.sort(key=lambda r: r["step"])
        launch = next(x for x in timing["launch"] if x["trial_id"] == tid)
        st = reports[0]["stamps"]
        trials.append({
            "trial_id": tid, "lr": reports[0]["config"]["train_loop_config"]["lr"],
            "losses": [r["loss"] for r in reports], "worker_pid": reports[0]["pid"],
            "worker_visible": sorted({r["visible"] for r in reports}),
            "worker_device": sorted({r["device"] for r in reports}),
            "launches_per_step": [r["launches"] for r in reports],
            "trial_actor_start_s": launch["s"],
            "worker_process_start_s": st["process_start"] - launch["t0"],
            "worker_loop_start_s": st["loop_start"] - launch["t0"],
            "workload_built_s": st["workload_built"] - launch["t0"],
            "first_step_s": reports[0]["t1"] - reports[0]["t0"],
            "step_s": [r["t1"] - r["t0"] for r in reports],
            "tokens_per_s": _tokens_per_s(reports, batch * seq),
            "wall_s": reports[-1]["t1"] - launch["t0"],
            "worker_alive": [st["process_start"], reports[-1]["t1"]],
            "peak_memory_gib": max(r["peak_memory_gib"] for r in reports),
            "gpu_free_in_worker": sorted({r["gpu_free"] for r in reports})})
    trials.sort(key=lambda t: t["lr"])
    first = [t["losses"][0] for t in trials]
    overlap_s = (min(t["worker_alive"][1] for t in trials)
                 - max(t["worker_alive"][0] for t in trials)) if len(trials) == 2 else 0.0
    best = grid.get_best_result()
    lowest = min(trials, key=lambda t: t["losses"][-1])
    sweep = {"entry": "Tuner(TorchTrainer(tune_trainer_loop, scaling_config=ScalingConfig("
                      "num_workers=1, use_gpu=True, gpus_per_worker=0.5))).fit()",
             "batch": batch, "seq": seq, "steps": steps, "lrs": list(TUNE_LRS),
             "trials": trials, "errors": [str(e) for e in grid.errors],
             "first_losses_bit_equal": len(set(first)) == 1,
             "first_step_reference": ref_loss,
             "first_loss_abs_err": max(abs(x - ref_loss) for x in first), "tol": LOSS_TOL,
             "workers_overlap_s": overlap_s,
             "gpu_free_seen_by_driver": sorted({r["gpu_free_driver"] for r in rec.results}),
             "best_trial": best.metrics["trial_id"], "lowest_last_loss_trial": lowest["trial_id"],
             "fit_s": sweep_s, "gpu_free_after": gpu_free_after, "pids_alive_after": alive}

    # --------------------------------------------------------------------- PBT
    probe = torch.tensor(PBT_PROBE, device=dev)
    rec2 = _tune_recorder()
    tuner = tune.Tuner(
        tune_pbt_trainable,
        param_space={"lr": tune.grid_search(list(PBT_LRS)), "cfg": cfg, "batch": pbt_batch,
                     "seq": seq, "steps": pbt_steps, "interval": PBT_INTERVAL,
                     "device": trial_device, "probe": probe, "barrier": "chip_smoke_tune_pbt",
                     "trials": len(PBT_LRS), "slow_lr": PBT_LRS[0]},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min",
            scheduler=PopulationBasedTraining(perturbation_interval=PBT_INTERVAL,
                                              hyperparam_mutations={"lr": list(PBT_MUTATIONS)}),
            resources_per_trial={"CPU": 1, "GPU": TUNE_GPU_SHARE}),
        run_config=RunConfig(name="chip_smoke_tune_pbt", storage_path=results_dir,
                             callbacks=[rec2]))
    with tune_timings() as timing2:
        t0 = time.perf_counter()
        grid2 = tuner.fit()
        pbt_s = time.perf_counter() - t0
    pbt_pids = {r["pid"] for r in rec2.results}
    gpu_free_after2, alive2 = _wait_released(gpu_total, pbt_pids)
    paths = {r.metrics["trial_id"]: r.path for r in grid2 if r.metrics}
    exploits = []
    for r in (x for x in rec2.results if x.get("restored")):
        got = r["restored"]
        donor_dir = paths[got["from_trial"]]
        with open(os.path.join(donor_dir, ".tune_checkpoint_metrics.json")) as f:
            manifest = json.load(f)
        name = next(n for n, m in manifest.items() if m.get("step") == got["from_step"])
        saved = Checkpoint.from_directory(os.path.join(donor_dir, name)).to_dict()
        launch = [x for x in timing2["launch"] if x["trial_id"] == r["trial_id"]
                  and x["restarts"] == r["restarts"]][-1]
        kill = [x for x in timing2["teardown"] if x["trial_id"] == r["trial_id"]
                and x["t0"] <= launch["t0"]][-1]
        st = r["stamps"]
        exploits.append({
            "trial_id": r["trial_id"], "restarts": r["restarts"], "donor": got["from_trial"],
            "donor_step": got["from_step"], "donor_checkpoint": name,
            "sha_donor_checkpoint": state_digest(saved["params"]),
            "sha_read": got["sha_read"], "sha_on_card": got["sha_on_card"],
            "params_devices": got["devices"], "lr": r["config"]["lr"],
            "donor_lr": saved["config"]["lr"],
            "config_is_donors_explored": same_config(r["config"], saved["config"], skip=("lr",))
            and r["config"]["lr"] in PBT_MUTATIONS,
            "kill_s": kill["s"], "launch_s": launch["s"],
            "actor_process_start_s": st["process_start"] - launch["t0"],
            "trainable_start_s": st["start"] - launch["t0"],
            "cuda_s": st["cuda_ready"] - st["start"],
            "checkpoint_read_s": st["ckpt_read"] - st["cuda_ready"],
            "checkpoint_to_card_s": st["ckpt_on_card"] - st["ckpt_read"],
            "first_step_s": r["t1"] - r["t0"],
            "decision_to_first_report_s": r["t_driver"] - kill["t0"]})
        del saved
    pbt_trials = []
    for tid, reports in _by_trial(rec2.results).items():
        launches = [x for x in timing2["launch"] if x["trial_id"] == tid]
        pbt_trials.append({
            "trial_id": tid, "lr_first": reports[0]["lr"], "lr_last": reports[-1]["lr"],
            "restarts": reports[-1]["restarts"], "steps": [r["step"] for r in reports],
            "losses": [r["loss"] for r in reports],
            "step_s": [r["t1"] - r["t0"] for r in reports],
            "pids": sorted({r["pid"] for r in reports}),
            "visible": sorted({r["visible"] for r in reports}),
            "device": sorted({r["device"] for r in reports}),
            "trial_actor_start_s": [x["s"] for x in launches],
            "tokens_per_s": _tokens_per_s(reports, pbt_batch * seq),
            "wall_s": reports[-1]["t_driver"] - launches[0]["t0"],
            "peak_memory_gib": max(r["peak_memory_gib"] for r in reports),
            "checkpoint_from_dict_s": [r["checkpoint_from_dict_s"] for r in reports
                                       if "checkpoint_from_dict_s" in r]})
    # Tune's journal and spec: the device tensor in param_space as a CPU tensor.
    exp_dir = os.path.join(results_dir, "chip_smoke_tune_pbt")
    with open(os.path.join(exp_dir, "experiment_state.json")) as f:
        journal = [serialization.loads(bytes.fromhex(t["config_pkl"]))["probe"]
                   for t in json.load(f)["trials"]]
    with open(os.path.join(exp_dir, "tuner.pkl"), "rb") as f:
        spec_probe = pickle.load(f)["param_space"]["probe"]
    stored = journal + [spec_probe]
    want = torch.tensor(PBT_PROBE)
    tmp_new = sorted(set(glob.glob(os.path.join(tempfile.gettempdir(),
                                                   "ray_tpu_torch_ckpt_*"))) - tmp_before)
    tmp_bytes = sum(os.path.getsize(os.path.join(d, f)) for d in tmp_new for f in os.listdir(d))
    persist = timing2["persist"]
    pbt = {"entry": "Tuner(tune_pbt_trainable, tune_config=TuneConfig(scheduler="
                    "PopulationBasedTraining(...), resources_per_trial={'CPU': 1, 'GPU': 0.5}))"
                    ".fit()",
           "batch": pbt_batch, "seq": seq, "steps": pbt_steps, "interval": PBT_INTERVAL,
           "lrs": list(PBT_LRS), "mutations": list(PBT_MUTATIONS), "trials": pbt_trials,
           "errors": [str(e) for e in grid2.errors], "exploits": exploits,
           "checkpoints": len(persist),
           "checkpoint_mb": [p["bytes"] / 1e6 for p in persist],
           "checkpoint_persist_s": [p["s"] for p in persist],
           "restored_checkpoint_tmp_dirs": len(tmp_new), "restored_checkpoint_tmp_mb":
               tmp_bytes / 1e6,
           "journal_and_spec_probe_devices": sorted({str(t.device) for t in stored}),
           "journal_and_spec_probe_equal": all(torch.equal(t, want) for t in stored),
           "gpu_free_seen_by_driver": sorted({r["gpu_free_driver"] for r in rec2.results}),
           "best_trial": grid2.get_best_result().metrics["trial_id"],
           "fit_s": pbt_s, "gpu_free_after": gpu_free_after2, "pids_alive_after": alive2}
    every = [r["launches"] for r in rec.results + rec2.results]
    launches = {k: sum(c[k] for c in every) for k in ("flash_fwd", "flash_bwd")}
    line = {"phase": "tune", "n_layer": cfg.n_layer, "d_model": cfg.d_model,
            "dtype": str(cfg.dtype).replace("torch.", ""), "gpu_total": gpu_total,
            "sweep": sweep, "pbt": pbt, "launches": launches,
            "wall_s": time.perf_counter() - t_start, "card": smi}
    emit(line)

    per_step = {"flash_fwd": cfg.n_layer, "flash_bwd": cfg.n_layer}
    require(len(grid) == len(TUNE_LRS) == len(trials) and not grid.errors,
            f"tune: sweep of {len(grid)} trials, {len(trials)} reported, errors {grid.errors}")
    for t in trials:
        require(len(t["losses"]) == steps and all(math.isfinite(x) for x in t["losses"]),
                f"tune: sweep trial {t['trial_id']} losses {t['losses']}")
        require(all(c == per_step for c in t["launches_per_step"]),
                f"tune: sweep trial {t['trial_id']} launches per step {t['launches_per_step']}")
    require(sweep["first_losses_bit_equal"], f"tune: sweep first losses {first} differ")
    require(sweep["first_loss_abs_err"] <= LOSS_TOL,
            f"tune: sweep first losses {first} vs plain attention {ref_loss}")
    require(overlap_s > 0, f"tune: the sweep's workers never ran at once ({overlap_s} s)")
    require(best.metrics["trial_id"] == lowest["trial_id"],
            f"tune: best result {best.metrics['trial_id']}, lowest last loss "
            f"{lowest['trial_id']}")
    require(len(grid2) == len(PBT_LRS) and not grid2.errors,
            f"tune: PBT of {len(grid2)} trials, errors {grid2.errors}")
    require(exploits, "tune: PBT made no exploit")
    for e in exploits:
        require(e["sha_on_card"] == e["sha_read"] == e["sha_donor_checkpoint"],
                f"tune: exploit of {e['trial_id']}: params on the card {e['sha_on_card']}, "
                f"read {e['sha_read']}, donor checkpoint {e['sha_donor_checkpoint']}")
        require(e["config_is_donors_explored"],
                f"tune: exploit of {e['trial_id']}: config lr {e['lr']} from donor lr "
                f"{e['donor_lr']}, other keys equal: {e['config_is_donors_explored']}")
        require(all(d.startswith(dev.type) for d in e["params_devices"]),
                f"tune: restored params on {e['params_devices']}")
    for t in pbt_trials:
        require(all(math.isfinite(x) for x in t["losses"]), f"tune: PBT losses {t['losses']}")
    require(all(c == per_step for c in (r["launches"] for r in rec2.results)),
            "tune: PBT launches per step "
            f"{[r['launches'] for r in rec2.results if r['launches'] != per_step]}")
    require(not tmp_new, f"tune: restored checkpoints copied into {tmp_new} ({tmp_bytes} bytes)")
    require(pbt["journal_and_spec_probe_devices"] == ["cpu"] and
            pbt["journal_and_spec_probe_equal"],
            f"tune: the journal's and spec's probe on {pbt['journal_and_spec_probe_devices']}")
    for part, seen, free_after, left in (("sweep", sweep["gpu_free_seen_by_driver"],
                                          gpu_free_after, alive),
                                         ("PBT", pbt["gpu_free_seen_by_driver"],
                                          gpu_free_after2, alive2)):
        require(0.0 in seen and free_after == gpu_total == 1,
                f"tune: {part}: GPU free {seen} during the run, {free_after} of {gpu_total} "
                f"after")
        require(not left, f"tune: {part}: trial processes alive after fit(): {left}")
    visible = {v for t in trials for v in t["worker_visible"]} | {
        v for t in pbt_trials for v in t["visible"]}
    require(visible == {"0"}, f"tune: trial processes saw CUDA_VISIBLE_DEVICES {visible}")
    if not on_cpu:
        devices = {d for t in trials for d in t["worker_device"]} | {
            d for t in pbt_trials for d in t["device"]}
        require(all(d.startswith("cuda") for d in devices), f"tune: trials ran on {devices}")
    return line


def run_tune_phase(smi, cfg=None, device=None, **sizes):
    """``tune`` on a runtime of its own (``init(num_cpus=4)``; on the CPU with
    one logical GPU, which no CUDA backs), then its shutdown: no session
    directory and none of its worker processes left. ``sizes`` (``batch``,
    ``pbt_batch``, ``seq``, ``steps``, ``pbt_steps``) shrink it for a CPU
    rehearsal. Returns the tune path's launches."""
    import torch

    import ray_tpu_torch

    on_cpu = device is not None and torch.device(device).type == "cpu"
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4, _system_config=dict(TUNE_SYSTEM_CONFIG),
                       **({"num_gpus": 1} if on_cpu else {}))
    init_s = time.perf_counter() - t0
    session_dir = ray_tpu_torch._private.worker.global_worker.session_dir
    pids = runtime_worker_pids()
    try:
        line = phase_tune(smi, cfg, device, **sizes)
        pids |= runtime_worker_pids()
        pids |= {t["worker_pid"] for t in line["sweep"]["trials"]}
        pids |= {p for t in line["pbt"]["trials"] for p in t["pids"]}
    finally:
        ray_tpu_torch.shutdown()
    leftover_dirs = [session_dir] if os.path.exists(session_dir) else []
    leftover_pids = sorted(pid for pid in pids if pid_alive(pid))
    emit({"phase": "tune_shutdown", "init_s": init_s, "run_worker_pids": sorted(pids),
          "leftover_session_dirs": leftover_dirs, "leftover_worker_pids": leftover_pids,
          "tune_phase_s": time.perf_counter() - t0})
    require(not leftover_dirs, f"session directories left after shutdown: {leftover_dirs}")
    require(not leftover_pids, f"worker processes alive after shutdown: {leftover_pids}")
    return line["launches"]


# ---------------------------------------------------------------------------- the CLI
# The cli_job phase: the operator's path through the port's CLI processes. A
# head (``python -m ray_tpu_torch start --head --num-gpus 1 --dashboard-port
# 0``, HOME a temporary directory, where the CLI keeps its state file), a job
# submitted to it (``job submit``) whose entrypoint trains the main path's
# model from seed 0 at B CLI_JOB_B x S 1024 for CLI_JOB_STEPS steps through
# TorchTrainer on one GPU worker, the cluster's state read through the CLI
# while the worker waits at a step for a KV flag and after the job, the same
# state through the dashboard, then ``stop``. The first loss is held to plain
# attention on the same batch with the main path's limit (LOSS_TOL), as the
# tune phase holds its own.
CLI_JOB_B, CLI_JOB_STEPS, CLI_JOB_WAIT_STEP = 8, 4, 1
CLI_JOB_FLAG = "chip_smoke_cli_job"


def cli_job_train_loop(config):
    """The cli_job phase's per-worker loop: the main path's model and AdamW
    from seed 0, ``config["steps"]`` steps on one batch, a report every step
    (``tune_steps``) with the records so far; after step
    ``config["wait_step"]`` it marks itself at that step in the KV and waits
    for the flag of the process that runs the phase, which reads the
    cluster's state meanwhile."""
    stamps = {"process_start": process_start_time(), "loop_start": time.time()}
    import torch

    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import create_train_state, default_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config["cfg"]
    if config["device"] == "cpu":
        count_plain_attention()
    opt = default_optimizer(learning_rate=3e-4)
    state = create_train_state(cfg, 0, opt, device=config["device"])
    batch = tune_batch(cfg, config["batch"], config["seq"], state.params["wte"].device)
    stamps["workload_built"] = time.time()
    history, kv = [], global_worker.context.kv

    def report(i, state, record):
        history.append(record)
        session.report({**record, "history": list(history), "stamps": stamps})
        if i == config["wait_step"]:
            t0 = time.time()
            kv("put", f"{config['flag']}/at_step".encode(), str(i).encode())
            while (kv("get", f"{config['flag']}/go".encode()) is None
                   and time.time() - t0 < config["wait_timeout_s"]):
                time.sleep(0.02)
            stamps["waited_for_the_driver_s"] = time.time() - t0

    tune_steps(state, make_train_step(cfg, opt), batch, config["steps"], 1, report)


def cli_job_entrypoint(config_path):
    """The cli_job phase's job entrypoint, run by the job's supervisor: join
    the cluster through ``RAY_TPU_TORCH_ADDRESS``, train through
    ``TorchTrainer`` with one GPU worker, and print one ``CLI_JOB {...}``
    line (the job's logs) with what the entrypoint saw and what the worker
    reported."""
    import pickle

    t_start = time.time()
    entry_visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    with open(config_path, "rb") as f:
        config = pickle.load(f)
    import ray_tpu_torch
    import ray_tpu_torch.train.torch as rt_torch
    from ray_tpu_torch.air import RunConfig, ScalingConfig

    ray_tpu_torch.init(address=os.environ["RAY_TPU_TORCH_ADDRESS"])
    t_init = time.time()
    on_cpu = config["device"] == "cpu"
    trainer = rt_torch.TorchTrainer(
        cli_job_train_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        backend_config=rt_torch.TorchConfig(device="cpu") if on_cpu else None,
        run_config=RunConfig(name="chip_smoke_cli_job", storage_path=config["results"]))
    result = trainer.fit()
    if result.error is not None:
        raise result.error
    out = {"entrypoint_visible": entry_visible, "entrypoint_pid": os.getpid(),
           "job_id": os.environ.get("RAY_TPU_TORCH_JOB_ID"), "start": t_start,
           "init_s": t_init - t_start, "fit_s": time.time() - t_init,
           "history": result.metrics["history"], "stamps": result.metrics["stamps"]}
    print("CLI_JOB " + json.dumps(out), flush=True)
    ray_tpu_torch.shutdown()


def process_tree(root):
    """``root`` and every process below it, by the parent pids in /proc."""
    children = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except OSError:
                continue
            children.setdefault(ppid, []).append(int(d))
    out, todo = set(), [root]
    while todo:
        pid = todo.pop()
        if pid not in out:
            out.add(pid)
            todo += children.get(pid, [])
    return out


def cuda_pids():
    """Pids of the processes holding a CUDA context, as ``nvidia-smi`` lists
    them; None where there is no ``nvidia-smi`` (a CPU rehearsal)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout
    except FileNotFoundError:
        return None
    return sorted(int(x) for x in out.split() if x.strip().isdigit())


def package_in_process(pid, name):
    """Whether package ``name`` is installed here, whether it has compiled
    extensions (which ``import name`` maps into a process), and whether
    process ``pid`` has one of its files mapped."""
    spec = importlib.util.find_spec(name)
    where = os.path.dirname(spec.origin) if spec and spec.origin else None
    try:
        with open(f"/proc/{pid}/maps") as f:
            mapped = f"/{name}/" in f.read()
    except OSError:
        mapped = None
    return {"installed": spec is not None, "origin": spec.origin if spec else None,
            "compiled_extensions": sorted(os.path.basename(p) for p in glob.glob(
                os.path.join(where, "**", "*.so"), recursive=True)) if where else [],
            "mapped_in_process": mapped}


def phase_cli_job(smi, cfg=None, device=None, batch=CLI_JOB_B, seq=S, steps=CLI_JOB_STEPS,
                  timeout_s=600.0):
    """The operator's path, from head start to ``stop``, through the port's
    CLI processes (constants above); ``start``, ``job submit`` and ``stop``
    run as processes, the read-only commands as ``scripts.cli.main`` in this
    process over one client connection. Returns the worker's launches."""
    import io
    import pickle
    import shlex
    import shutil
    import tempfile
    import urllib.request

    import ray_tpu_torch
    from ray_tpu_torch._private.accelerators.gpu import resolve_device
    from ray_tpu_torch.models import GPTConfig, gpt
    from ray_tpu_torch.scripts import cli

    cfg = cfg or GPTConfig.gpt2_small()
    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    root = os.path.dirname(os.path.abspath(__file__))
    home = tempfile.mkdtemp(prefix="chip_smoke_cli_job_")
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAY_TPU_TORCH_")}
    env.update(HOME=home, PYTHONPATH=root)
    t_start = time.perf_counter()
    # nvidia-smi may list a container's processes under another pid (all as
    # 1 on the card's machine), so the processes on the card are counted
    # too: after stop, no more than before the head started.
    cuda_before = cuda_pids()

    def run(*args):
        t0 = time.time()
        p = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args], cwd=root, env=env,
                           capture_output=True, text=True, timeout=timeout_s)
        require(p.returncode == 0, f"cli_job: {' '.join(args)}: rc {p.returncode}\n"
                                   f"{p.stdout[-2000:]}\n{p.stderr[-3000:]}")
        return p.stdout, time.time() - t0

    # 1. The head.
    out, head_start_s = run("start", "--head", "--num-gpus", "1", "--dashboard-port", "0")
    with open(os.path.join(home, ".ray_tpu_torch", "cli_state.json")) as f:
        head = json.load(f)["head"]
    saved_key = os.environ.get("RAY_TPU_TORCH_AUTHKEY_HEX")
    os.environ["RAY_TPU_TORCH_AUTHKEY_HEX"] = head["authkey_hex"]
    connected = False
    try:
        ray_tpu_torch.init(address=head["address"])
        connected = True
        kv = ray_tpu_torch._private.worker.global_worker.context.kv

        def read(*args):
            """``python -m ray_tpu_torch <args>``'s output, in this process
            over the one client connection (the CLI's _connect would init()
            each time)."""
            buf = io.StringIO()
            connect, cli._connect = cli._connect, lambda ns: ray_tpu_torch
            try:
                with contextlib.redirect_stdout(buf):
                    cli.main(list(args))
            finally:
                cli._connect = connect
            return buf.getvalue()

        status0 = json.loads(read("status"))
        # 2. The job.
        results = os.path.join(home, "results")
        config_path = os.path.join(home, "job_config.pkl")
        with open(config_path, "wb") as f:
            pickle.dump({"cfg": cfg, "batch": batch, "seq": seq, "steps": steps,
                         "device": "cpu" if on_cpu else None, "results": results,
                         "flag": CLI_JOB_FLAG, "wait_step": CLI_JOB_WAIT_STEP,
                         "wait_timeout_s": timeout_s}, f)
        script = os.path.join(home, "job_train.py")
        with open(script, "w") as f:
            f.write(f"import sys\nsys.path.insert(0, {root!r})\nimport chip_smoke\n\n"
                    f"chip_smoke.cli_job_entrypoint({config_path!r})\n")
        t_submit = time.time()
        out, submit_s = run("job", "submit", "--entrypoint",
                            f"{shlex.quote(sys.executable)} {shlex.quote(script)}")
        job_id = out.split()[0]
        # 3. The state while the worker waits at its step.
        t_running = None
        deadline = time.time() + timeout_s
        while kv("get", f"{CLI_JOB_FLAG}/at_step".encode()) is None:
            st = read("job", "status", job_id).strip()
            if t_running is None and st != "PENDING":
                t_running = time.time()
            require(st in ("PENDING", "RUNNING") and time.time() < deadline,
                    f"cli_job: job {job_id} {st} before its worker reached step "
                    f"{CLI_JOB_WAIT_STEP}:\n{read('job', 'logs', job_id)[-3000:]}")
            time.sleep(0.05)
        t_at_step = time.time()
        t_running = t_running or t_at_step
        during = json.loads(read("list", "actors"))
        status_during = json.loads(read("status"))
        nodes_during = json.loads(read("list", "nodes"))
        tree_during = process_tree(head["pid"])
        cuda_during = cuda_pids()
        kv("put", f"{CLI_JOB_FLAG}/go".encode(), b"1")
        # 4. The state after the job.
        while True:
            st = read("job", "status", job_id).strip()
            if st in ("SUCCEEDED", "FAILED", "STOPPED") or time.time() > deadline:
                break
            time.sleep(0.1)
        t_done = time.time()
        logs = read("job", "logs", job_id)
        require(st == "SUCCEEDED", f"cli_job: job {job_id} {st}:\n{logs[-4000:]}")
        job_out = json.loads(next(ln for ln in logs.splitlines()
                                  if ln.startswith("CLI_JOB "))[len("CLI_JOB "):])
        while json.loads(read("status"))["available_resources"].get("GPU") != 1.0 and \
                time.time() < deadline:
            time.sleep(0.1)
        status_after = json.loads(read("status"))
        train = json.loads(read("train", "--json"))
        jobs = json.loads(read("jobs", "--json"))
        timeline_path = os.path.join(home, "timeline.json")
        read("timeline", "--output", timeline_path)
        with open(timeline_path) as f:
            timeline = json.load(f)
        # 5. The same state through the dashboard.
        base = f"http://127.0.0.1:{head['dashboard_port']}"

        def http(path):
            with urllib.request.urlopen(base + path, timeout=60) as resp:
                return resp.status, resp.read().decode()

        api = {k: json.loads(http(f"/api/{k}")[1]) for k in ("cluster", "jobs", "train")}
        metrics_status, metrics = http("/metrics")
        head_aiohttp = package_in_process(head["pid"], "aiohttp")  # while the head lives
        tree_after = process_tree(head["pid"])
    finally:
        if connected:
            ray_tpu_torch.shutdown()
        if saved_key is None:
            os.environ.pop("RAY_TPU_TORCH_AUTHKEY_HEX", None)
        else:
            os.environ["RAY_TPU_TORCH_AUTHKEY_HEX"] = saved_key
        # 6. Stop the head.
        t0 = time.time()
        stop_out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "stop"], cwd=root,
                                  env=env, capture_output=True, text=True, timeout=timeout_s)
        stop_s = time.time() - t0
    tree = sorted(tree_during | tree_after)
    deadline = time.time() + 30
    while any(pid_alive(p) for p in tree) and time.time() < deadline:
        time.sleep(0.1)
    stop_wait_s = time.time() - t0
    alive = sorted(p for p in tree if pid_alive(p))
    on_card = cuda_pids()
    session_left = os.path.exists(head["session_dir"])
    shutil.rmtree(home, ignore_errors=True)

    history, stamps = job_out["history"], job_out["stamps"]
    worker = [a for a in during if a["class_name"] == "RayTrainWorker" and a["state"] == "ALIVE"]
    sup = [a for a in during if (a["name"] or "").startswith(f"JOB_SUPERVISOR::{job_id}")]
    ref_loss, _ = first_step_reference(cfg, tune_batch(cfg, batch, seq, dev), gpt)
    losses = [r["loss"] for r in history]
    warm = [r["t1"] - r["t0"] for r in history[1:]] or [history[0]["t1"] - history[0]["t0"]]
    (gang,) = [g for g in train["gangs"].values() if g.get("steps") == steps] or [None]
    bucket_sum = sum(gang["buckets"].values()) if gang else None
    task_events = [e for e in timeline if e.get("cat") == "task"]
    worker_tasks = [e for e in task_events if e["name"].startswith("RayTrainWorker.")]
    launches = {k: sum(r["launches"][k] for r in history) for k in ("flash_fwd", "flash_bwd")}
    line = {
        "phase": "cli_job", "n_layer": cfg.n_layer, "d_model": cfg.d_model,
        "dtype": str(cfg.dtype).replace("torch.", ""), "batch": batch, "seq": seq,
        "steps": steps, "job_id": job_id,
        "head": {"pid": head["pid"], "start_s": head_start_s, "dashboard_port":
                 head["dashboard_port"], "cluster_resources": status0["cluster_resources"]},
        "seconds": {"head_start_to_ready": head_start_s, "submit_process": submit_s,
                    "submit_to_running": t_running - t_submit,
                    "submit_to_first_step": history[0]["t1"] - t_submit,
                    "submit_to_worker_process": stamps["process_start"] - t_submit,
                    "worker_process_to_workload_built":
                        stamps["workload_built"] - stamps["process_start"],
                    "first_step": history[0]["t1"] - history[0]["t0"],
                    "worker_waited_for_the_driver": stamps.get("waited_for_the_driver_s"),
                    "at_step_to_succeeded": t_done - t_at_step,
                    "submit_to_succeeded": t_done - t_submit, "stop_process": stop_s,
                    "stop_to_tree_gone": stop_wait_s,
                    "job_entrypoint_init": job_out["init_s"], "job_fit": job_out["fit_s"]},
        "entrypoint_visible": job_out["entrypoint_visible"],
        "worker": {"pid": history[0]["pid"], "visible": sorted({r["visible"] for r in history}),
                   "device": sorted({r["device"] for r in history}), "losses": losses,
                   "launches_per_step": [r["launches"] for r in history],
                   "step_s": [r["t1"] - r["t0"] for r in history],
                   "tokens_per_s_warm": batch * seq / statistics.median(warm),
                   "peak_memory_gib": max(r["peak_memory_gib"] for r in history),
                   "gpu_free_in_worker": sorted({r["gpu_free"] for r in history})},
        "first_step_reference": ref_loss, "first_loss_abs_err": abs(losses[0] - ref_loss),
        "tol": LOSS_TOL,
        "list_actors_during": {"worker": worker, "supervisor": sup},
        "gpu_during": {"available": status_during["available_resources"].get("GPU"),
                       "node_available": [n["available"].get("GPU") for n in nodes_during]},
        "job_status": st, "logs_hold_the_json_line": True,
        "gpu_after": {"available": status_after["available_resources"].get("GPU"),
                      "total": status_after["cluster_resources"].get("GPU")},
        "goodput": {k: gang[k] for k in ("steps", "wall_s", "buckets", "coverage",
                                        "goodput_frac")} if gang else None,
        "goodput_bucket_sum_s": bucket_sum,
        "timeline": {"events": len(timeline), "task_events": len(task_events),
                     "worker_task_events": len(worker_tasks),
                     "cats": sorted({e.get("cat") for e in timeline})},
        "dashboard": {"cluster_equals_status": api["cluster"]["cluster_resources"] ==
                      status_after["cluster_resources"] and
                      api["cluster"]["available_resources"] == status_after["available_resources"],
                      "jobs_equal_cli": {j["job"]: j["state"] for j in api["jobs"]} ==
                      {j["job"]: j["state"] for j in jobs},
                      "train_equals_cli": api["train"] == train,
                      "metrics_status": metrics_status,
                      "metrics_has_scheduler_counters":
                          "ray_tpu_scheduler_tasks_dispatched_total" in metrics},
        "head_aiohttp": head_aiohttp,
        "stop": {"stdout": stop_out.stdout.strip(), "rc": stop_out.returncode,
                 "tree": tree, "alive_after": alive, "cuda_pids_before": cuda_before,
                 "cuda_pids_during": cuda_during, "cuda_pids_after": on_card,
                 "tree_on_card_after": sorted(set(tree) & set(on_card or ())),
                 "session_dir_left": session_left},
        "launches": launches, "wall_s": time.perf_counter() - t_start, "card": smi}
    emit(line)

    per_step = {"flash_fwd": cfg.n_layer, "flash_bwd": cfg.n_layer}
    require(status0["cluster_resources"].get("GPU") == 1.0,
            f"cli_job: the head's cluster {status0['cluster_resources']}")
    require(len(history) == steps and all(math.isfinite(x) for x in losses),
            f"cli_job: worker losses {losses}")
    require(all(r["launches"] == per_step for r in history),
            f"cli_job: launches per step {[r['launches'] for r in history]}")
    require(line["worker"]["visible"] == ["0"], f"cli_job: worker saw {line['worker']['visible']}")
    if not on_cpu:
        require(line["worker"]["device"] == ["cuda:0"],
                f"cli_job: worker ran on {line['worker']['device']}")
    require(job_out["entrypoint_visible"] == "",
            f"cli_job: the entrypoint saw CUDA_VISIBLE_DEVICES {job_out['entrypoint_visible']!r}")
    require(line["first_loss_abs_err"] <= LOSS_TOL,
            f"cli_job: first loss {losses[0]} vs plain attention {ref_loss}")
    require(len(worker) == 1 and worker[0]["resources"].get("GPU") == 1.0
            and worker[0]["gpu_ids"] == ["0"], f"cli_job: list actors showed the worker {worker}")
    require(len(sup) == 1 and sup[0]["state"] == "ALIVE" and not sup[0]["resources"].get("GPU")
            and sup[0]["gpu_ids"] == [], f"cli_job: list actors showed the supervisor {sup}")
    require(line["gpu_during"]["available"] == 0.0, f"cli_job: GPU during {line['gpu_during']}")
    require(line["gpu_after"] == {"available": 1.0, "total": 1.0},
            f"cli_job: GPU after the job {line['gpu_after']}")
    require(gang is not None and abs(bucket_sum - gang["wall_s"]) <= 1e-3 + 1e-3 * gang["wall_s"],
            f"cli_job: goodput ledger {train}")
    require(worker_tasks, f"cli_job: the timeline holds no task of the worker "
                          f"({sorted({e['name'] for e in task_events})})")
    require(all(line["dashboard"][k] for k in ("cluster_equals_status", "jobs_equal_cli",
                                               "train_equals_cli",
                                               "metrics_has_scheduler_counters"))
            and metrics_status == 200, f"cli_job: dashboard {line['dashboard']}")
    require(line["head_aiohttp"]["mapped_in_process"] is False,
            f"cli_job: the head loaded aiohttp: {line['head_aiohttp']}")
    require(stop_out.returncode == 0 and not alive and not session_left
            and not line["stop"]["tree_on_card_after"]
            and len(on_card or ()) <= len(cuda_before or ()),
            f"cli_job: after stop: {line['stop']}")
    return launches


# ---------------------------------------------------------------------------- RLlib
# The RL phases' CartPole: gymnasium's CartPole-v1 (envs/classic_control/
# cartpole.py: dynamics, thresholds, reset draw) under its 500-step TimeLimit,
# in numpy, so the path needs no gymnasium.
CARTPOLE_MAX_STEPS = 500
# And gymnasium's Pendulum-v1 (envs/classic_control/pendulum.py) under its
# 200-step TimeLimit, for SAC and TD3.
PENDULUM_MAX_STEPS = 200
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


class Pendulum:
    """gymnasium's ``Pendulum-v1`` (``gym.make("Pendulum-v1")``) in numpy:
    the torque-limited pendulum's Euler step, cost angle^2 + 0.1 speed^2 +
    0.001 torque^2 as minus the reward, truncation at 200 steps, and the
    reset angle and speed drawn uniform in [-pi, pi) x [-1, 1) from
    ``np.random.default_rng(seed)``."""

    max_speed, max_torque, dt, g, m, l = 8.0, 2.0, 0.05, 10.0, 1.0, 1.0

    def __init__(self, max_episode_steps=PENDULUM_MAX_STEPS):
        self.max_episode_steps = max_episode_steps
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.observation_space = BoxSpace(-high, high)
        torque = np.full(1, self.max_torque, np.float32)
        self.action_space = BoxSpace(-torque, torque)
        self.np_random, self.state, self.elapsed = None, None, 0

    def _obs(self):
        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot], dtype=np.float32)

    def reset(self, *, seed=None, options=None):
        if seed is not None or self.np_random is None:
            self.np_random = np.random.default_rng(seed)
        high = np.array([np.pi, 1.0])
        self.state = self.np_random.uniform(low=-high, high=high)
        self.elapsed = 0
        return self._obs(), {}

    def step(self, action):
        th, thdot = self.state
        u = np.clip(action, -self.max_torque, self.max_torque)[0]
        costs = (((th + np.pi) % (2 * np.pi)) - np.pi) ** 2 + 0.1 * thdot**2 + 0.001 * (u**2)
        newthdot = thdot + (3 * self.g / (2 * self.l) * np.sin(th)
                            + 3.0 / (self.m * self.l**2) * u) * self.dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        self.state = np.array([th + newthdot * self.dt, newthdot])
        self.elapsed += 1
        return self._obs(), -costs, False, self.elapsed >= self.max_episode_steps, {}

    def close(self):
        pass


class LinearTargetEnv:
    """The one-step continuous task of tests/test_rllib_extras.py:344 that CQL
    learns offline: obs uniform in [-1, 1), reward -(a - obs / 2)^2, every
    episode one step long (random actions score -0.45 on average)."""

    def __init__(self):
        box = np.ones(1, np.float32)
        self.observation_space = BoxSpace(-box, box)
        self.action_space = BoxSpace(-box, box)
        self._rng, self._obs = np.random.default_rng(0), None

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._obs = self._rng.uniform(-1, 1, (1,)).astype(np.float32)
        return self._obs, {}

    def step(self, action):
        a = float(np.clip(np.asarray(action).ravel()[0], -1, 1))
        reward = -((a - 0.5 * float(self._obs[0])) ** 2)
        self._obs = self._rng.uniform(-1, 1, (1,)).astype(np.float32)
        return self._obs, reward, True, False, {}

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


def a2c_config():
    """A2C as tests/test_rllib.py:610-632 trains it, on the numpy CartPole."""
    from ray_tpu_torch.rllib import A2CConfig

    return (A2CConfig().environment(CartPole)
            .env_runners(num_env_runners=2, num_envs_per_runner=8, rollout_fragment_length=32)
            .training(lr=1e-3, entropy_coeff=0.01, lambda_=0.95))


def pg_config():
    """PG as tests/test_rllib.py:635-660 trains it, on the numpy CartPole."""
    from ray_tpu_torch.rllib import PGConfig

    return (PGConfig().environment(CartPole)
            .env_runners(num_env_runners=2, num_envs_per_runner=8, rollout_fragment_length=512)
            .training(lr=4e-3, entropy_coeff=0.005))


def impala_config(cls_name="IMPALAConfig"):
    """IMPALA (or APPO, ``cls_name="APPOConfig"``) as tests/test_rllib.py:
    362-372 and :549-560 train them, on the numpy CartPole."""
    import ray_tpu_torch.rllib as rllib

    return (getattr(rllib, cls_name)().environment(CartPole)
            .env_runners(num_env_runners=2, num_envs_per_runner=8, rollout_fragment_length=64)
            .training(lr=5e-4, gamma=0.99, entropy_coeff=0.01))


def sac_config():
    """SAC as tests/test_rllib.py:440-460 trains it, on the numpy Pendulum."""
    from ray_tpu_torch.rllib import SACConfig

    return (SACConfig().environment(Pendulum)
            .env_runners(num_env_runners=2, num_envs_per_runner=4, rollout_fragment_length=32)
            .training(lr=7e-4, learning_starts=400, train_batch_size=128,
                      updates_per_iteration=256, model={"hiddens": (64, 64)}))


def td3_config():
    """TD3 as tests/test_rllib_extras.py:288-300 trains it, on the numpy
    Pendulum."""
    from ray_tpu_torch.rllib import TD3Config

    return (TD3Config().environment(Pendulum)
            .env_runners(num_env_runners=2, num_envs_per_runner=4, rollout_fragment_length=32)
            .training(lr=1e-3, learning_starts=400, train_batch_size=128,
                      updates_per_iteration=256,
                      model={"hiddens": (64, 64), "activation": "relu"}))


def apex_config():
    """Ape-X DQN as tests/test_rllib_exploration.py:286-301 runs it, on the
    numpy CartPole: 2 runners, 2 replay shards."""
    from ray_tpu_torch.rllib import ApexDQNConfig

    return (ApexDQNConfig().environment(CartPole)
            .training(train_batch_size=32, learning_starts=96, updates_per_iteration=6,
                      buffer_capacity=4000)
            .env_runners(num_env_runners=2, num_envs_per_runner=2, rollout_fragment_length=32))


def offline_config(name, path):
    """BC or MARWIL (``name``) as tests/test_rllib_offline.py:107-115 and
    :160-172 train them from ``path`` (JSON files, or a Dataset as :141
    does), or CQL as tests/test_rllib_extras.py:395-403 does, on the numpy
    envs."""
    import ray_tpu_torch.rllib as rllib

    if name == "cql":
        return (rllib.CQLConfig().environment(LinearTargetEnv)
                .training(lr=1e-3, train_batch_size=256, updates_per_iteration=40,
                          min_q_weight=1.0, model={"hiddens": (32, 32)})
                .offline_data(input_=os.path.join(path, "*.json"))
                .evaluation(evaluation_duration=64))
    cfg = rllib.BCConfig() if name == "bc" else rllib.MARWILConfig().training(beta=1.0)
    return (cfg.environment(CartPole)
            .training(lr=1e-3, train_batch_size=512, updates_per_iteration=20)
            .offline_data(input_=path))


RL_CHECK_KINDS = ("ppo", "dqn", "c51", "a2c", "pg", "impala", "appo", "marwil", "sac", "td3",
                  "cql")


def rl_learner_inputs(kind, seed=0):
    """One loss's module, loss function, optimizer, weights, extra state,
    RL_UPDATES minibatches and extra-state update (the polyak target blend,
    or None), from numpy seed ``seed``, at the shapes the RL phases train
    with: PPO's minibatch 128 rows, DQN's train batch 64 (CartPole, obs 4, 2
    actions); A2C's, PG's and MARWIL's 512 rows; IMPALA's and APPO's (16 envs,
    64 steps); SAC's and TD3's 128 rows on Pendulum (obs 3, 1 torque), CQL's
    256 with 4 sampled actions of each kind a row (obs 1, 1 action).
    ``kind``: one of RL_CHECK_KINDS, or "dqn_weighted" (DQN's loss weights as
    prioritized replay's importance weights, in [0.2, 1], and 0 on every
    eighth row, a truncation)."""
    from ray_tpu_torch.models import params_to_numpy
    from ray_tpu_torch.rllib import ModelCatalog
    from ray_tpu_torch.rllib.algorithms import a2c, appo, cql, impala, marwil, pg, sac, td3
    from ray_tpu_torch.rllib.algorithms.dqn import make_c51_loss, make_dqn_loss
    from ray_tpu_torch.rllib.algorithms.ppo import make_ppo_loss
    from ray_tpu_torch.rllib.core.distributional import DistributionalQModule
    from ray_tpu_torch.rllib.core.learner import adam
    from ray_tpu_torch.rllib.core.rl_module import MLPModule, QMLPModule

    rng = np.random.default_rng(seed)
    obs_dim, n_act, extra_update, shape = 4, 2, None, None
    if kind in ("ppo", "a2c", "pg", "marwil", "impala", "appo"):
        module = MLPModule(obs_dim, n_act)
        if kind == "ppo":
            cfg = ppo_config()
            loss, rows = make_ppo_loss(cfg), cfg.minibatch_size
        elif kind in ("impala", "appo"):
            cfg = impala_config("APPOConfig" if kind == "appo" else "IMPALAConfig")
            loss = (appo.make_appo_loss if kind == "appo" else impala.make_impala_loss)(cfg)
            shape = (cfg.num_env_runners * cfg.num_envs_per_runner, cfg.rollout_fragment_length)
            rows = shape[0]
        else:
            cfg = {"a2c": a2c_config, "pg": pg_config,
                   "marwil": lambda: offline_config("marwil", None)}[kind]()
            loss = {"a2c": a2c.make_a2c_loss, "pg": pg.make_pg_loss,
                    "marwil": marwil.make_marwil_loss}[kind](cfg)
            rows = 512
    elif kind in ("sac", "td3", "cql"):
        cfg = {"sac": sac_config, "td3": td3_config,
               "cql": lambda: offline_config("cql", "")}[kind]()
        env = LinearTargetEnv() if kind == "cql" else Pendulum()
        obs_dim, space = env.observation_space.shape[0], env.action_space
        module = ModelCatalog.get_module(
            "deterministic_continuous" if kind == "td3" else "squashed_gaussian", obs_dim, space,
            cfg.model)
        towers = ("pi", "q1", "q2") if kind == "td3" else ("q1", "q2")
        extra_update = sac.make_polyak(cfg.tau, towers)
        if kind == "td3":
            loss = td3.make_td3_loss(cfg)
        else:
            make = cql.make_cql_loss if kind == "cql" else sac.make_sac_loss
            loss = make(cfg, -float(space.shape[0]))
        rows = cfg.train_batch_size
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
    if kind in ("dqn", "dqn_weighted", "c51"):
        extra = {"target_params": weights}
    elif kind == "appo":  # a lagging target apart from the params
        extra = params_to_numpy(module.init(seed + 1, device="cpu"))
    elif extra_update is not None:
        extra = {k: weights[k] for k in towers}
    else:
        extra = None

    def normal(*shape_):
        return rng.standard_normal(shape_).astype(np.float32)

    def batch(i):
        if shape is not None:  # IMPALA, APPO: env-major (N, T)
            n, t = shape
            dones = (rng.random(shape) < 0.02).astype(np.float32)
            terms = (dones * (rng.random(shape) < 0.5)).astype(np.float32)
            truncs = dones - terms
            return {"obs": normal(n, t, obs_dim), "actions": rng.integers(0, n_act, shape),
                    "logp": np.log(rng.uniform(0.3, 0.7, shape)).astype(np.float32),
                    "rewards": np.ones(shape, np.float32), "dones": dones, "terminateds": terms,
                    "truncateds": truncs, "final_obs": normal(n, t, obs_dim) * truncs[..., None],
                    "last_obs": normal(n, obs_dim), "kl_coeff": np.ones(n, np.float32)}
        b = {"obs": normal(rows, obs_dim)}
        if kind in ("sac", "td3", "cql"):
            act_dim, low, high = module.act_dim, module.act_low, module.act_high
            b.update(actions=rng.uniform(low, high, (rows, act_dim)).astype(np.float32),
                     rewards=normal(rows), next_obs=normal(rows, obs_dim),
                     terminateds=(rng.random(rows) < 0.05).astype(np.float32))
            if kind == "td3":
                b.update(target_noise=normal(rows, act_dim) * cfg.target_noise,
                         actor_weight=np.full(rows, float(i % cfg.policy_delay == 0), np.float32))
            else:
                b.update(noise_next=normal(rows, act_dim), noise_pi=normal(rows, act_dim))
            if kind == "cql":
                r = cfg.cql_num_actions
                b.update(cql_random_actions=rng.uniform(low, high, (rows, r, act_dim)).astype(
                    np.float32), cql_noise_pi=normal(rows, r, act_dim),
                    cql_noise_next=normal(rows, r, act_dim))
            return b
        b["actions"] = rng.integers(0, n_act, rows)
        if kind == "ppo":
            b.update(logp=np.log(rng.uniform(0.3, 0.7, rows)).astype(np.float32),
                     behavior_logits=(0.1 * rng.standard_normal((rows, n_act))).astype(np.float32),
                     advantages=normal(rows), value_targets=normal(rows),
                     kl_coeff=np.full(rows, cfg.kl_coeff, np.float32))
        elif kind == "a2c":
            b.update(advantages=normal(rows), value_targets=normal(rows))
        elif kind in ("pg", "marwil"):
            b["returns"] = normal(rows)
            if kind == "marwil":
                b["ma_sqd_adv_norm"] = np.full(rows, 100.0, np.float32)
        else:
            b.update(rewards=np.ones(rows, np.float32), next_obs=normal(rows, obs_dim),
                     terminateds=(rng.random(rows) < 0.05).astype(np.float32),
                     loss_weight=np.ones(rows, np.float32))
            if kind == "dqn_weighted":
                b["loss_weight"] = rng.uniform(0.2, 1.0, rows).astype(np.float32)
                b["loss_weight"][::8] = 0.0
        return b

    opt = adam(cfg.lr, getattr(cfg, "grad_clip", None))
    return module, loss, opt, weights, extra, [batch(i) for i in range(RL_UPDATES)], extra_update


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


def vtrace_kernels(module, loss_cfg, weights, batch, device):
    """The CUDA kernels one call of the V-trace function launches on
    ``batch`` (IMPALA's and APPO's loss call it once an update), under the
    profiler: the T-step reverse loop and the bootstrap forwards."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import params_from_numpy
    from ray_tpu_torch.rllib.algorithms.impala import vtrace

    params = params_from_numpy(weights, device)
    tb = {k: torch.tensor(v, device=device) for k, v in batch.items()}
    with torch.no_grad():
        logits, values = module.forward(params, tb["obs"])
        logp = torch.gather(torch.log_softmax(logits, -1), -1, tb["actions"][..., None])[..., 0]
    args = (module, params, tb, logp, values, loss_cfg.gamma, loss_cfg.vtrace_clip_rho_threshold,
            loss_cfg.vtrace_clip_pg_rho_threshold, loss_cfg.vtrace_clip_c_threshold)
    vtrace(*args)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        vtrace(*args)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not e.key.startswith(("Memcpy", "Memset")))
    return {"kernels_per_update": kernels, "time_steps": int(batch["rewards"].shape[1])}


def phase_rl_learner_check(smi, device="cuda"):
    """A TorchLearner on ``device`` against one on the CPU, from the same
    numpy weights and minibatches: RL_UPDATES updates of each loss of
    RL_CHECK_KINDS (PPO, DQN with double Q, C51 with 51 atoms, A2C, PG,
    IMPALA, APPO, MARWIL, SAC, TD3, CQL; the polyak target blend after each
    of SAC's, TD3's and CQL's), each update's losses, aux and grad norm
    compared, the params and extra state after the last; then RL_PROFILED
    more updates on the card under the profiler (and, for IMPALA and APPO,
    the kernels of one V-trace call)."""
    from ray_tpu_torch.models.training import tree_leaves
    from ray_tpu_torch.rllib import TorchLearner

    lines = []
    for kind in RL_CHECK_KINDS:
        module, loss, opt, weights, extra, batches, extra_update = rl_learner_inputs(kind)
        learner, ref_learner = (TorchLearner(module, loss, optimizer=opt, device=dev,
                                             extra_update_fn=extra_update)
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
        pairs = list(zip(tree_leaves(learner.get_weights()),
                         tree_leaves(ref_learner.get_weights())))
        if extra is not None:
            pairs += zip(tree_leaves(learner.get_extra()), tree_leaves(ref_learner.get_extra()))
        param_err = max(float(np.max(np.abs(a - b))) for a, b in pairs)
        worst = {k: max(e[k] for e in errs) for k in errs[0]}
        line = {"phase": "rl_learner_check", "loss": kind, "device": device,
                "placement": learner.placement(), "updates": len(batches),
                "rows": len(batches[0]["obs"]), "batch_shape": list(batches[0]["rewards"].shape)
                if "rewards" in batches[0] else [len(batches[0]["obs"])],
                "max_rel_err_per_key": worst,
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
            if kind in ("impala", "appo"):
                loss_cfg = impala_config("APPOConfig" if kind == "appo" else "IMPALAConfig")
                line["vtrace"] = vtrace_kernels(module, loss_cfg, weights, batches[0], device)
        lines.append(line)
        emit(line)
        require(line["placement"]["device"].startswith(device),
                f"rl_learner_check {kind}: params on {line['placement']['device']}")
        require(max(worst.values()) <= RL_TOL, f"rl_learner_check {kind}: {worst}")
        require(param_err <= RL_PARAM_TOL, f"rl_learner_check {kind}: params {param_err}")
    return lines


def rl_placement(algo, device):
    """The learners' and runners' placement, checked: every learner's params
    on ``device`` (every policy's, on a policy map), every runner a CPU
    process that sees no GPU."""
    import ray_tpu_torch

    groups = algo.learner_groups.values() if algo.is_multi_agent else [algo.learner_group]
    learners = [p for group in groups for p in group.placement()]
    runners = ray_tpu_torch.get([r.placement.remote() for r in algo.env_runners])
    require(all(p["device"].startswith(device) for p in learners), f"learners on {learners}")
    require(all(r["cuda_visible_devices"] == "" and r["device"] == "cpu" for r in runners),
            f"runners {runners}: expected CUDA_VISIBLE_DEVICES '' and the CPU")
    return {"learners": learners, "runners": runners}


def rl_iteration(result, steps):
    """One train() result as the RL phases print it (an offline algorithm
    samples nothing: no sample time, no env steps/s)."""
    learn_s, updates = result.get("learn_time_s"), result.get("num_learner_updates", 0)
    sample_s = result.get("sample_time_s")
    return {"iteration": result["training_iteration"], "return": result.get("episode_return_mean"),
            "total_loss": result.get("total_loss"), "sample_s": sample_s,
            "learn_s": learn_s, "iteration_s": result["time_this_iter_s"],
            "env_steps_per_s": steps / sample_s if sample_s else None,
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
    weights = algo.learner_group.get_weights()
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
    return dict(line, weights=weights)  # the trained policy rl_offline records


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


# The rest of single-agent RLlib, by the JAX package's tests' bars: A2C, IMPALA
# and APPO reach a best return of 60 within 40 iterations
# (tests/test_rllib.py:375-389, :563-577, :610-632), PG gains 25 over its first
# return (stopping early at 40; :635-660); SAC and TD3 lift Pendulum over -400
# and -500 within 25 (:467-490, tests/test_rllib_extras.py:303-324); BC and
# MARWIL score over 150 at evaluation (tests/test_rllib_offline.py:124-207),
# CQL over -0.15 on the one-step task (tests/test_rllib_extras.py:344-417).
ONPOLICY_MAX_ITERS, ONPOLICY_BAR = 40, 60.0
PG_GAIN, PG_STOP_GAIN = 25.0, 40.0
CONTINUOUS_MAX_ITERS, SAC_BAR, TD3_BAR = 25, -400.0, -500.0
APEX_ITERS = 8
BC_ITERS, MARWIL_ITERS, CQL_ITERS = 10, 12, 8
OFFLINE_EPISODES, OFFLINE_EVAL_EPISODES, OFFLINE_BAR, CQL_BAR = 40, 8, 150.0, -0.15


def rl_train(algo, steps, max_iters, stop=None, extra=None):
    """``algo.train()`` up to ``max_iters`` times, until ``stop(first, best)``
    of the episode returns; each result as ``rl_iteration`` prints it, plus
    ``extra(result)``. Returns (rows, first return, best return)."""
    rows, first, best = [], None, None
    for _ in range(max_iters):
        result = algo.train()
        rows.append(dict(rl_iteration(result, steps), **(extra(result) if extra else {})))
        ret = rows[-1]["return"]
        if ret is not None:
            first = ret if first is None else first
            best = ret if best is None else max(best, ret)
        if stop is not None and best is not None and stop(first, best):
            break
    return rows, first, best


def rl_totals(rows, steps):
    """A phase's iterations, return curve, sample and learn seconds, env
    steps/s and updates/s over all its iterations."""
    sample_s = sum(r["sample_s"] or 0.0 for r in rows)
    learn_s = sum(r["learn_s"] or 0.0 for r in rows)
    updates = sum(r["updates"] for r in rows)
    return {"iterations": len(rows), "returns": [r["return"] for r in rows],
            "sample_s": sample_s, "learn_s": learn_s,
            "env_steps_per_s": steps * len(rows) / sample_s if sample_s else None,
            "updates_per_s": updates / learn_s if learn_s else None}


def rl_steps(cfg):
    """Env steps one iteration samples: every runner's fragment."""
    return cfg.num_env_runners * cfg.num_envs_per_runner * cfg.rollout_fragment_length


def actor_placements(handles):
    """Each actor's process and the GPU ids it sees, checked: none."""
    import ray_tpu_torch

    got = ray_tpu_torch.get([h.placement.remote() for h in handles])
    require(all(p["cuda_visible_devices"] == "" for p in got),
            f"actors {got}: expected CUDA_VISIBLE_DEVICES ''")
    return got


def rl_finish(algo, line, smi, t_start):
    """Stop ``algo`` after noting the runtime's workers in ``line`` and the
    wall seconds since ``t_start`` (its build); print it."""
    line["worker_pids"] = sorted(runtime_worker_pids())
    algo.stop()
    line["wall_s"], line["card"] = time.perf_counter() - t_start, smi
    emit(line)
    return line


def phase_rl_onpolicy(smi, device="cuda", max_iters=ONPOLICY_MAX_ITERS, bars=True):
    """A2C, PG, IMPALA and APPO on the numpy CartPole through
    ``build().train()``: the learner on ``device``, two runners on CPU actors,
    each until its bar or ``max_iters`` iterations (``bars=False``: a
    rehearsal, the bars unchecked)."""
    lines = []
    for name, make in (("a2c", a2c_config), ("pg", pg_config), ("impala", impala_config),
                       ("appo", lambda: impala_config("APPOConfig"))):
        cfg = make()
        steps = rl_steps(cfg)
        t_start = time.perf_counter()
        algo = cfg.build()
        placement = rl_placement(algo, device)
        if name == "pg":
            stop = lambda first, best: best > first + PG_STOP_GAIN  # noqa: E731
        else:
            stop = lambda first, best: best >= ONPOLICY_BAR  # noqa: E731
        extra = {"impala": lambda r: {"mean_rho": r["mean_rho"]},
                 "appo": lambda r: {"mean_is_ratio": r["mean_is_ratio"], "mean_kl": r["mean_kl"],
                                    "kl_coeff": algo.kl_coeff}}.get(name)
        rows, first, best = rl_train(algo, steps, max_iters, stop, extra)
        line = rl_finish(algo, {"phase": "rl_onpolicy", "algo": name, "env": "CartPole-v1 (numpy)",
                                "env_steps_per_iteration": steps, "placement": placement,
                                **rl_totals(rows, steps), "per_iteration": rows,
                                "first_return": first, "best_return": best}, smi, t_start)
        lines.append(line)
        require(all(math.isfinite(r["total_loss"]) for r in rows if r["total_loss"] is not None),
                f"rl_onpolicy {name}: losses {rows}")
        if name == "appo":
            require(0.5 < rows[-1]["mean_is_ratio"] < 1.5, f"rl_onpolicy appo: {rows[-1]}")
        if bars:
            require(best is not None, f"rl_onpolicy {name}: no episode finished")
            if name == "pg":
                require(best > first + PG_GAIN, f"rl_onpolicy pg: first {first} best {best}")
            else:
                require(best >= ONPOLICY_BAR, f"rl_onpolicy {name}: best return {best}")
    return lines


def phase_rl_continuous(smi, device="cuda", max_iters=CONTINUOUS_MAX_ITERS, bars=True):
    """SAC and TD3 on the numpy Pendulum: the learner on ``device``, two
    runners on CPU actors, until the best return passes the bar or
    ``max_iters`` iterations; SAC's temperature stays positive and every
    critic loss finite."""
    lines = []
    for name, make, bar in (("sac", sac_config, SAC_BAR), ("td3", td3_config, TD3_BAR)):
        cfg = make()
        steps = rl_steps(cfg)
        t_start = time.perf_counter()
        algo = cfg.build()
        placement = rl_placement(algo, device)

        def extra(r):
            return {k: r.get(k) for k in ("critic_loss", "actor_loss", "alpha", "buffer_size")}

        rows, first, best = rl_train(algo, steps, max_iters, lambda f, b: b > bar, extra)
        line = rl_finish(algo, {"phase": "rl_continuous", "algo": name,
                                "env": "Pendulum-v1 (numpy)",
                                "env_steps_per_iteration": steps, "placement": placement,
                                "updates_per_iteration": cfg.updates_per_iteration,
                                "train_batch_size": cfg.train_batch_size,
                                **rl_totals(rows, steps), "per_iteration": rows,
                                "first_return": first, "best_return": best, "bar": bar},
                         smi, t_start)
        lines.append(line)
        critic = [r["critic_loss"] for r in rows if r["critic_loss"] is not None]
        require(critic and all(math.isfinite(c) for c in critic),
                f"rl_continuous {name}: critic losses {critic}")
        if name == "sac":
            require(rows[-1]["alpha"] > 0.0, f"rl_continuous sac: alpha {rows[-1]['alpha']}")
        if bars:
            require(best is not None and best > bar, f"rl_continuous {name}: best {best} <= {bar}")
    return lines


def phase_rl_apex(smi, device="cuda", iters=APEX_ITERS):
    """Ape-X DQN on the numpy CartPole, 2 runners and 2 replay shards (CPU
    actors), the learner on ``device``, ``iters`` iterations: every shard
    fills, the per-worker epsilons follow the power schedule, and learner
    updates run and refresh the shards' priorities. The return curve is
    printed, not gated (the JAX test sets no bar)."""
    import ray_tpu_torch

    cfg = apex_config()
    steps = rl_steps(cfg)
    t_start = time.perf_counter()
    algo = cfg.build()
    placement = dict(rl_placement(algo, device), shards=actor_placements(algo.replay_shards))
    eps = algo.worker_epsilons()
    n = len(algo.env_runners)
    schedule = [cfg.per_worker_epsilon_base ** (1.0 + i / (n - 1) * cfg.per_worker_epsilon_exponent)
                for i in range(n)]

    def extra(r):
        return {"replay_shard_sizes": r["replay_shard_sizes"], "beta": r["beta"],
                "fragments_pushed": r["fragments_pushed"], "td_error_mean": r.get("td_error_mean")}

    rows, first, best = rl_train(algo, steps, iters, extra=extra)
    stats = ray_tpu_torch.get([s.stats.remote() for s in algo.replay_shards])
    line = rl_finish(algo, {"phase": "rl_apex", "env": "CartPole-v1 (numpy)",
                            "num_replay_shards": cfg.num_replay_shards,
                            "env_steps_per_iteration": steps, "placement": placement,
                            "worker_epsilons": eps, "epsilon_schedule": schedule,
                            **rl_totals(rows, steps), "per_iteration": rows,
                            "shard_stats": stats, "first_return": first, "best_return": best},
                     smi, t_start)
    sizes = rows[-1]["replay_shard_sizes"]
    require(len(sizes) == 2 and all(x > 0 for x in sizes), f"rl_apex: shard sizes {sizes}")
    require(n == 2 and eps == schedule and eps[0] > eps[1], f"rl_apex: epsilons {eps}")
    require(any(r["td_error_mean"] is not None for r in rows), "rl_apex: no learner update ran")
    require(any(st["max_priority"] != 1.0 for st in stats), f"rl_apex: priorities {stats}")
    return line


def greedy_episodes(weights, n, seed0=0, random_every=0):
    """``n`` CartPole episodes of the policy ``weights`` (an ``MLPModule``
    tree), acting greedily on the CPU, as per-episode columns for
    ``JsonWriter``; with ``random_every=k``, every k-th episode acts at
    random instead (numpy seed 0)."""
    import torch

    from ray_tpu_torch.models import params_from_numpy
    from ray_tpu_torch.rllib import MLPModule

    module, params = MLPModule(4, 2), params_from_numpy(weights, "cpu")
    rng = np.random.default_rng(0)
    for ep in range(n):
        env = CartPole()
        obs, _ = env.reset(seed=seed0 + ep)
        rows = {k: [] for k in ("obs", "actions", "rewards", "terminateds", "truncateds")}
        done = False
        while not done:
            if random_every and ep % random_every == 1:
                a = int(rng.integers(2))
            else:
                with torch.no_grad():
                    a = int(torch.argmax(module.forward(params, torch.from_numpy(obs))[0]))
            nxt, r, term, trunc, _ = env.step(a)
            for k, v in zip(rows, (obs.tolist(), a, float(r), bool(term), bool(trunc))):
                rows[k].append(v)
            obs, done = nxt, term or trunc
        yield rows


def write_offline_data(root, ppo_weights):
    """The offline phases' JSON files, written with the port's JsonWriter:
    ``ppo``, greedy episodes of the trained PPO; ``mixed``, the same PPO on
    even episodes and random actions on odd ones; ``cql``, uniform random
    actions on the one-step task (tests/test_rllib_extras.py:385-399).
    Returns the PPO episodes' mean return and their transitions as rows of
    ``obs`` and ``actions`` (tests/test_rllib_offline.py:141's Dataset)."""
    from ray_tpu_torch.rllib.offline import JsonWriter

    returns, transitions = [], []
    for name, every in (("ppo", 0), ("mixed", 2)):
        writer = JsonWriter(os.path.join(root, name))
        for rows in greedy_episodes(ppo_weights, OFFLINE_EPISODES, random_every=every):
            writer.write(rows)
            if name == "ppo":
                returns.append(sum(rows["rewards"]))
                transitions += [{"obs": np.asarray(o, np.float32), "actions": a}
                                for o, a in zip(rows["obs"], rows["actions"])]
        writer.close()
    rng = np.random.default_rng(7)
    writer = JsonWriter(os.path.join(root, "cql"))
    for _ in range(40):
        obs = rng.uniform(-1, 1, (64, 1)).astype(np.float32)
        actions = rng.uniform(-1, 1, (64, 1)).astype(np.float32)
        rewards = -np.square(actions[:, 0] - 0.5 * obs[:, 0])
        writer.write({"obs": obs, "actions": actions, "rewards": rewards.astype(np.float32),
                      "next_obs": rng.uniform(-1, 1, (64, 1)).astype(np.float32),
                      "dones": np.ones(64, np.float32)})
    writer.close()
    return float(np.mean(returns)), transitions


def phase_rl_offline(smi, ppo_weights, device="cuda", iters=None, bars=True):
    """BC (from the trained PPO's greedy episodes), MARWIL (from those mixed
    with random ones) and CQL (from random actions on the one-step task),
    each reading JSON files through ``offline_data(input_=)``, then BC again
    from a ``ray_tpu_torch.data`` Dataset of the PPO episodes' transitions
    (through ``DatasetReader``); each learner on ``device``, no runner
    sampling for training; then each one's evaluation on CPU runner actors,
    against the JAX tests' bars."""
    import shutil
    import tempfile

    from ray_tpu_torch import data as rd

    root = tempfile.mkdtemp(prefix="chip_smoke_offline_")
    t0 = time.perf_counter()
    behavior_return, transitions = write_offline_data(root, ppo_weights)
    ppo_dataset = rd.from_items(transitions)
    write_s = time.perf_counter() - t0
    keys = ("vf_loss", "ma_sqd_adv_norm", "critic_loss", "cql_penalty", "policy_loss")
    lines = []
    for name, data, n_iters in (("bc", "ppo", BC_ITERS), ("marwil", "mixed", MARWIL_ITERS),
                                ("cql", "cql", CQL_ITERS), ("bc", "ppo_dataset", BC_ITERS)):
        source = ppo_dataset if data == "ppo_dataset" else os.path.join(root, data)
        cfg = offline_config(name, source)
        t_start = time.perf_counter()
        algo = cfg.build()
        placement = rl_placement(algo, device)
        require(not algo.env_runners, f"rl_offline {name}: training runners {algo.env_runners}")
        rows, _, _ = rl_train(algo, 0, iters or n_iters,
                              extra=lambda r: {k: r[k] for k in keys if k in r})
        if name == "cql":
            ev = algo.evaluate()["evaluation"]
            evaluators = algo._eval_runners
        else:
            ev = algo.evaluate(num_episodes=OFFLINE_EVAL_EPISODES)
            evaluators = [algo._eval_runner]
        placement["evaluation_runners"] = actor_placements(evaluators)
        last = rows[-1]
        line = rl_finish(algo, {"phase": "rl_offline", "algo": name, "data": data,
                                "reader": type(algo.reader).__name__,
                                "dataset_rows": len(transitions) if data == "ppo_dataset"
                                else None, "placement": placement,
                                "behavior_return_mean": None if name == "cql" else behavior_return,
                                "write_s": write_s, **rl_totals(rows, 0), "per_iteration": rows,
                                "evaluation_return_mean": ev.get("episode_return_mean"),
                                "evaluation_episodes": ev.get("episodes", ev.get("num_episodes")),
                                "bar": CQL_BAR if name == "cql" else OFFLINE_BAR}, smi, t_start)
        lines.append(line)
        require(all(math.isfinite(r["total_loss"]) for r in rows), f"rl_offline {name}: {rows}")
        if name == "bc":
            require(last["vf_loss"] == 0.0, f"rl_offline bc: vf_loss {last['vf_loss']}")
        if name == "marwil":
            start = cfg.moving_average_sqd_adv_norm_start
            # The advantage norm's EMA moved off its start (by ~1e-8 of the
            # gap an update: over the whole run, not one iteration).
            moved = abs(last["ma_sqd_adv_norm"] - start) > 1e-6 * start
            require(last["vf_loss"] > 0.0 and (moved or not bars), f"rl_offline marwil: {last}")
        if name == "cql":
            require(math.isfinite(last["critic_loss"]) and math.isfinite(last["cql_penalty"]),
                    f"rl_offline cql: {last}")
        if bars:
            got = line["evaluation_return_mean"]
            require(got is not None and got > line["bar"],
                    f"rl_offline {name}: evaluation return {got} <= {line['bar']}")
    shutil.rmtree(root, ignore_errors=True)
    return lines


# Multi-agent RLlib, by the JAX package's tests' configurations and bars: two
# agents of one env, agent "0" on policy p0 and the other on p1. PPO gains 40
# over its first summed return within 15 iterations (stopping at 60;
# tests/test_rllib_multiagent.py:78-123), DQN 10 within 15
# (tests/test_rllib_extras.py:207-244), SAC runs at most 4 iterations on
# Pendulum, its losses finite and its policies apart (:246-286). DQN's bar on
# one seed is a coin toss in both packages (by 15 iterations its targets have
# synced once; tests/multi_agent_dqn_seeds.py, seeds 0-8 on the CPU: the JAX
# package misses it at seeds 6 and 7, the port at 0 and 3), so DQN runs at
# MA_DQN_SEEDS and its bar holds the mean of their curves.
MA_ITERS, MA_PPO_GAIN, MA_PPO_STOP, MA_DQN_GAIN, MA_SAC_ITERS = 15, 40.0, 60.0, 10.0, 4
MA_DQN_SEEDS = (0, 1, 2)


def ma_configs():
    """PPO, DQN (CartPole) and SAC (Pendulum) over two agents and two
    policies, as the JAX tests configure them, on the numpy envs."""
    import ray_tpu_torch.rllib as rllib

    def two_agents(cfg, env):
        creator = rllib.make_multi_agent(env)
        return (cfg.environment(lambda c=None: creator({"num_agents": 2}))
                .multi_agent(policies=["p0", "p1"],
                             policy_mapping_fn=lambda aid: "p0" if aid == "0" else "p1"))

    ppo = (rllib.PPOConfig()
           .env_runners(num_env_runners=2, num_envs_per_runner=2, rollout_fragment_length=64)
           .training(lr=3e-4, gamma=0.99, minibatch_size=128, num_epochs=4, entropy_coeff=0.01))
    dqn = (rllib.DQNConfig()
           .env_runners(num_env_runners=2, num_envs_per_runner=2, rollout_fragment_length=64)
           .training(lr=1e-3, learning_starts=500, train_batch_size=64, updates_per_iteration=16,
                     epsilon_decay_steps=4000, model={"hiddens": (64, 64)}))
    sac = (rllib.SACConfig()
           .env_runners(num_env_runners=1, num_envs_per_runner=2, rollout_fragment_length=64)
           .training(learning_starts=200, train_batch_size=64, updates_per_iteration=4,
                     model={"hiddens": (32, 32)}))
    return {"ppo": two_agents(ppo, CartPole), "dqn": two_agents(dqn, CartPole),
            "sac": two_agents(sac, Pendulum)}


def ma_weights(algo):
    return {pid: lg.get_weights() for pid, lg in algo.learner_groups.items()}


def ma_finite(result, key):
    """Whether both policies' ``key`` in a train() result is finite."""
    return all(math.isfinite(result.get(f"policy_{p}/{key}", math.nan)) for p in ("p0", "p1"))


def ma_ppo_checks(algo, cfg, line):
    """PPO's policy map, trained: ``policies_to_train=["p0"]`` leaves p1's
    weights bit for bit through one iteration, and ``save``/``restore``
    round-trips both policies and a set ``kl_coeff["p1"]`` into a new
    algorithm, which then trains."""
    import shutil
    import tempfile

    from ray_tpu_torch.models.training import tree_leaves

    algo.config.policies_to_train = ["p0"]
    before = ma_weights(algo)
    frozen = algo.train()
    after = ma_weights(algo)
    algo.config.policies_to_train = None
    line["frozen_p1_bits_equal"] = all(np.array_equal(a, b) for a, b in zip(
        tree_leaves(before["p1"]), tree_leaves(after["p1"])))
    line["trained_p0_moved"] = any(not np.array_equal(a, b) for a, b in zip(
        tree_leaves(before["p0"]), tree_leaves(after["p0"])))
    line["frozen_iteration_trained"] = sorted(
        k.split("/")[0] for k in frozen if k.endswith("/total_loss"))
    algo.kl_coeff["p1"] = 0.456
    root = tempfile.mkdtemp(prefix="chip_smoke_ma_")
    try:
        path = algo.save(os.path.join(root, "ck"))
        saved = ma_weights(algo)
        restored = cfg.build()
        try:
            restored.restore(path)
            got = ma_weights(restored)
            line["restored_bits_equal"] = all(
                np.array_equal(a, b) for pid in saved
                for a, b in zip(tree_leaves(saved[pid]), tree_leaves(got[pid])))
            line["restored_kl_coeff_p1"] = restored.kl_coeff["p1"]
            line["restored_trains"] = ma_finite(restored.train(), "total_loss")
            line["restored_worker_pids"] = sorted(runtime_worker_pids())
        finally:
            restored.stop()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_rl_multi_agent(smi, device="cuda", max_iters=None, bars=True):
    """Multi-agent PPO, DQN and SAC through ``build().train()``: one learner
    per policy on ``device``, the runners CPU actors. PPO also runs
    ``ma_ppo_checks``. ``max_iters`` cuts every run (a rehearsal, with
    ``bars=False``)."""
    from ray_tpu_torch.models.training import tree_leaves

    configs, lines = ma_configs(), []
    keys = {"ppo": ("total_loss", "kl_coeff"), "dqn": ("td_error_mean", "buffer_size"),
            "sac": ("critic_loss", "alpha", "buffer_size")}
    for name in ("ppo", "dqn", "sac"):
        t_start = time.perf_counter()
        steps = 2 * rl_steps(configs[name])  # two agents an env step
        runs = []
        for seed in (MA_DQN_SEEDS if name == "dqn" else (0,)):
            cfg = configs[name].copy()
            cfg.seed = seed
            algo = cfg.build()
            placement = rl_placement(algo, device)
            results = []

            def extra(r, results=results, name=name):
                results.append(r)
                return {f"{p}/{k}": r.get(f"policy_{p}/{k}") for p in ("p0", "p1")
                        for k in keys[name]}

            iters = MA_SAC_ITERS if name == "sac" else MA_ITERS
            stop = (lambda f, b: b > f + MA_PPO_STOP) if name == "ppo" else None
            rows, first, best = rl_train(algo, steps, min(iters, max_iters or iters), stop,
                                         extra)
            runs.append({"seed": seed, "algo": algo, "placement": placement, "rows": rows,
                         "first": first, "best": best, "last": results[-1], "cfg": cfg})
            if name != "dqn":
                break
            line_pids = sorted(runtime_worker_pids())
            algo.stop()
            runs[-1]["worker_pids"] = line_pids
        run = runs[-1]
        rows = [r for x in runs for r in x["rows"]]
        line = {"phase": "rl_multi_agent", "algo": name,
                "env": ("Pendulum-v1" if name == "sac" else "CartPole-v1") + " (numpy) x 2 agents",
                "policies": sorted(run["algo"].learner_groups), "env_steps_per_iteration": steps,
                "placement": run["placement"], **rl_totals(rows, steps), "per_iteration": rows,
                "first_return": run["first"], "best_return": run["best"]}
        if name == "dqn":
            # The mean over seeds of each iteration's return (where every
            # seed finished an episode), its first and its best.
            curves = [[r["return"] for r in x["rows"]] for x in runs]
            mean = [float(np.mean(c)) if all(v is not None for v in c) else None
                    for c in zip(*curves)]
            done = [m for m in mean if m is not None]
            line.update(seeds=list(MA_DQN_SEEDS), per_seed=[
                {"seed": x["seed"], "returns": [r["return"] for r in x["rows"]],
                 "first": x["first"], "best": x["best"]} for x in runs],
                mean_returns=mean, first_return=done[0] if done else None,
                best_return=max(done) if done else None,
                bar=f"mean over seeds: best > first + {MA_DQN_GAIN}")
            line["worker_pids"] = sorted({p for x in runs for p in x["worker_pids"]})
            line["wall_s"], line["card"] = time.perf_counter() - t_start, smi
            emit(line)
        else:
            algo = run["algo"]
            if name == "ppo":
                line["bar"] = f"best > first + {MA_PPO_GAIN}"
                ma_ppo_checks(algo, run["cfg"], line)
            else:
                w = ma_weights(algo)
                line["policy_weights_differ"] = any(
                    not np.allclose(a, b) for a, b in zip(tree_leaves(w["p0"]), tree_leaves(w["p1"])))
            rl_finish(algo, line, smi, t_start)
            line["worker_pids"] = sorted(set(line["worker_pids"])
                                         | set(line.get("restored_worker_pids", ())))
        lines.append(line)
        for x in runs:
            require(len(x["placement"]["learners"]) == 2 and all(
                p["device"].startswith(device) for p in x["placement"]["learners"]),
                f"rl_multi_agent {name}: {x['placement']}")
        last, first, best = run["last"], line["first_return"], line["best_return"]
        if name == "ppo":
            require(ma_finite(last, "total_loss"), f"rl_multi_agent ppo: losses {last}")
            require(line["frozen_p1_bits_equal"] and line["trained_p0_moved"]
                    and line["frozen_iteration_trained"] == ["policy_p0"],
                    f"rl_multi_agent ppo: policies_to_train {line}")
            require(line["restored_bits_equal"] and line["restored_kl_coeff_p1"] == 0.456
                    and line["restored_trains"], f"rl_multi_agent ppo: save/restore {line}")
        elif name == "sac":
            require(line["policy_weights_differ"], "rl_multi_agent sac: policies share weights")
        if bars:
            if name == "ppo":
                require(first is not None and best > first + MA_PPO_GAIN,
                        f"rl_multi_agent ppo: no learning, first {first} best {best}")
            elif name == "dqn":
                require(all(f"policy_{p}/td_error_mean" in x["last"] for x in runs
                            for p in ("p0", "p1")), f"rl_multi_agent dqn: {sorted(last)}")
                require(first is not None and best > first + MA_DQN_GAIN,
                        f"rl_multi_agent dqn: no learning, mean first {first} best {best}")
            else:
                require(ma_finite(last, "critic_loss") and ma_finite(last, "alpha"),
                        f"rl_multi_agent sac: {sorted(last)}")
    return lines


def run_rl_phases(smi):
    """The RL phases: the learner check, then PPO, DQN, two learners, the
    on-policy, continuous, Ape-X, offline and multi-agent algorithms on one
    runtime, whose shutdown is checked to leave no session directory and no
    worker process (runner, learner, replay shard or evaluation runner)
    behind. None launches an attention kernel."""
    import ray_tpu_torch
    from ray_tpu_torch.ops import launch_counts

    before, start = launch_counts(), time.perf_counter()
    phase_rl_learner_check(smi)
    learner_check_s = time.perf_counter() - start
    phase_rl_mesh_learner(smi)
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4)
    init_s = time.perf_counter() - t0
    session_dir = ray_tpu_torch._private.worker.global_worker.session_dir
    require(ray_tpu_torch.cluster_resources().get("GPU") == 1,
            f"node resources {ray_tpu_torch.cluster_resources()}: expected GPU: 1")
    ppo = phase_ppo(smi)
    pids = set(ppo["worker_pids"])
    for phase in (phase_dqn, phase_ppo_two_learners):
        pids |= set(phase(smi)["worker_pids"])
    t0 = time.perf_counter()
    lines = (phase_rl_onpolicy(smi) + phase_rl_continuous(smi) + [phase_rl_apex(smi)]
             + phase_rl_offline(smi, ppo["weights"]) + phase_rl_multi_agent(smi))
    new_phases_s = time.perf_counter() - t0 + learner_check_s
    rl_shutdown(session_dir, pids, lines, before, start, init_s,
                new_phases_s=new_phases_s,
                new_phases_s_by_phase={p: sum(x.get("wall_s", 0.0) for x in lines
                                              if x["phase"] == p)
                                       for p in ("rl_onpolicy", "rl_continuous", "rl_apex",
                                                 "rl_offline", "rl_multi_agent")})


def rl_shutdown(session_dir, pids, lines, before, start, init_s, **extra):
    """Shut the RL phases' runtime down and check it left no session
    directory and no worker process (those ``pids`` and every ``lines``'
    ``worker_pids``), and that no attention kernel launched since ``before``;
    print the ``rl_shutdown`` line (with ``extra``)."""
    import ray_tpu_torch
    from ray_tpu_torch.ops import launch_counts

    pids = set(pids)
    for line in lines:
        pids |= set(line["worker_pids"])
    t0 = time.perf_counter()
    ray_tpu_torch.shutdown()
    shutdown_s = time.perf_counter() - t0
    leftover_dirs = [session_dir] if os.path.exists(session_dir) else []
    leftover_pids = sorted(pid for pid in pids if pid_alive(pid))
    line = {"phase": "rl_shutdown", "rl_phases_s": time.perf_counter() - start, **extra,
            "init_s": init_s, "shutdown_s": shutdown_s,
            "run_worker_pids": sorted(pids), "leftover_session_dirs": leftover_dirs,
            "leftover_worker_pids": leftover_pids, "attention_kernel_launches":
            {k: n - before[k] for k, n in launch_counts().items()}}
    emit(line)
    require(not leftover_dirs, f"session directories left after shutdown: {leftover_dirs}")
    require(not leftover_pids, f"worker processes alive after shutdown: {leftover_pids}")
    require(not any(line["attention_kernel_launches"].values()),
            f"the RL phases launched attention kernels: {line['attention_kernel_launches']}")
    return line


def run_rl_multi_agent(smi, device="cuda", max_iters=None, bars=True):
    """``rl_multi_agent`` alone on a runtime of its own, then its shutdown
    check."""
    import ray_tpu_torch
    from ray_tpu_torch.ops import launch_counts

    before, start = launch_counts(), time.perf_counter()
    ray_tpu_torch.init(num_cpus=4)
    init_s = time.perf_counter() - start
    session_dir = ray_tpu_torch._private.worker.global_worker.session_dir
    lines = phase_rl_multi_agent(smi, device, max_iters=max_iters, bars=bars)
    return lines, rl_shutdown(session_dir, (), lines, before, start, init_s,
                              new_phases_s_by_phase={"rl_multi_agent": sum(
                                  x["wall_s"] for x in lines)})


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
    # This process's GPU memory goes first (the worker shares the one card),
    # all but the trained params (0.5 GB), which the predictor phase scores.
    main_params = state.params
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

    # ------------------------------------------------------------------ 6a. the predictor, Data, Serve, Tune
    predictor_launches = phase_predictor(smi, main_params)
    data_launches = run_data_phases(smi, main_params)
    serve_launches = run_serve_phase(smi, main_params)
    del main_params
    torch.cuda.empty_cache()
    tune_launches = run_tune_phase(smi)
    cli_job_launches = phase_cli_job(smi)

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
                                "predictor": predictor_launches[name],
                                **{path: n[name] for path, n in data_launches.items()},
                                "serve": serve_launches[name], "tune": tune_launches[name],
                                "cli_job": cli_job_launches[name],
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
    problems = check_kernels_line(kernels, KERNEL_PATHS_BY_KERNEL)
    require(not problems, f"kernels line: {problems}")
    emit(kernels)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
