#!/usr/bin/env python3
"""The port's multi-GPU paths on the four NVIDIA GPUs of one host.

    python3 tools/port_multichip.py [--rehearse] [PHASE ...]

Run it on a host with four cards.
It prints ``nvidia-smi topo -m`` (and NVLink status and CUDA peer access) and
each card's name and power limit, then one
JSON line per phase (also appended to ``chiprun_out/port_multichip.jsonl``);
a failed check exits non-zero. The phases, all by default, in this order:

- ``collective_bw``: 4 actors holding a GPU each join one NCCL group through
  ``ray_tpu_torch.util.collective``; every op is checked on CUDA tensors;
  then allreduce is timed at 1 MiB ... 1 GiB in f32 and bf16 (algbw = bytes /
  time, busbw = algbw * 2(n - 1) / n), beside ``torch.distributed.all_reduce``
  on the same buffers, and the TCP group at 1 ... 64 MiB of host data.
- ``gpt2_dp4``: GPT-2 small through ``TorchTrainer(num_workers=4,
  use_gpu=True)`` on the default mesh (``data=4``) over NCCL, global B 64 x
  S 1024 (16 rows per card), 3 warmup and 10 timed steps, against the
  one-card main path (B 16) run first in this process: tokens/s per GPU,
  and the first loss against the one-card loss on the same global batch.
- ``gpt2_fsdp4``, ``gpt2_dp2_tp2``: the same on ``{"fsdp": 4}`` and
  ``{"data": 2, "tensor": 2}``; first loss against ``gpt2_dp4``'s, peak
  memory per card.
- ``llama3_8b_fsdp4``: ``LlamaConfig.llama3_8b()`` at full depth (32 layers)
  on ``{"fsdp": 4}``, B 4 x S 8192 (1 row per card), 3 steps: the first loss
  against its value at init, 32 + 32 launches per rank per step, peak memory
  per card, tokens/s per GPU and MFU.
- ``gpt2_pp2_dp2``, ``gpt2_cp2_dp2``: the gpt2 phases on ``{"pipeline": 2,
  "data": 2}`` (GPipe, M 4: two 16-row microbatches per data rank) and
  ``{"context": 2, "data": 2}`` (the ring over NCCL, s_local 512).
- ``llama3_8b_pp4``: Llama 3 8B at full depth on ``{"pipeline": 4}`` (8
  layers a stage), B 4 x S 8192, M 4 one-row microbatches, 3 steps: the first
  loss against its value at init (and fsdp4's, where that phase ran first),
  8 x 4 launches per rank per step, tokens/s per GPU, MFU, the bubble share
  (P - 1) / (M + P - 1) beside the step time, peak memory per card.
- ``llama3_8b_cp4``: Llama 3 8B at full width cut to 4 layers on
  ``{"context": 4}``, one row of S 8192 (s_local 2048), 3 steps, the ring over
  NCCL: the first loss against one card's on the same row and its tokens/s
  (both measured first on card 0 in this process), 4 (r + 1) launches per
  step on context rank r, the ring's rotation overlapping its kernels (device
  ms in which both run), peak memory per card.

``--rehearse`` runs every phase on the CPU at toy sizes (gloo, nano
configs, no launch or memory checks), to find faults before a chip call.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from chip_smoke import PEAK_BF16_FLOPS, emit, require  # noqa: E402

WORLD = 4
MIB = 1 << 20
ALLREDUCE_MIB = (1, 4, 16, 64, 256, 1024)
TCP_MIB = (1, 4, 16, 64)
BW_WARMUP, BW_ITERS, TCP_ITERS = 3, 10, 3
GPT_GLOBAL_B, S = 64, 1024
GPT_WARMUP, GPT_TIMED = 3, 10
LLAMA_GLOBAL_B, LLAMA_S, LLAMA_STEPS = 4, 8192, 3
# The mesh runs' first loss against the one-card loss on the same batch, and
# the fsdp and tensor runs' against dp's: the same weights and tokens, sums
# split across ranks in another order.
FIRST_LOSS_TOL = 1e-3
PHASES = ("collective_bw", "gpt2_dp4", "gpt2_fsdp4", "gpt2_dp2_tp2", "llama3_8b_fsdp4",
          "gpt2_pp2_dp2", "gpt2_cp2_dp2", "llama3_8b_pp4", "llama3_8b_cp4")
LLAMA_CP_LAYERS = 4  # chip_smoke's llama depth: one card holds it, for the baseline
OUT = os.path.join(ROOT, "chiprun_out", "port_multichip.jsonl")

# Toy sizes for --rehearse on the CPU.
NANO_GPT = dict(n_layer=2, n_head=2, d_model=64, vocab_size=256, max_seq_len=128)
NANO_LLAMA = dict(n_layer=4, n_head=4, n_kv_head=2, d_model=64, d_ff=128, vocab_size=256,
                  max_seq_len=128)  # 4 layers: one a stage on {pipeline 4}


def record(line):
    emit(line)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(line, default=float) + "\n")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------- collective_bw
class CollectiveWorker:
    """One rank of the collective phase, in an actor holding one GPU (or, in
    a rehearsal, the CPU)."""

    def __init__(self, rank, world, on_cpu):
        self.rank, self.world, self.on_cpu = rank, world, on_cpu

    def setup(self, port):
        import datetime

        import torch
        import torch.distributed as dist

        from ray_tpu_torch.util import collective as col

        self.col = col
        device = "cpu" if self.on_cpu else None
        col.init_collective_group(self.world, self.rank, backend="nccl", group_name="bw",
                                  device=device)
        col.init_collective_group(self.world, self.rank, backend="tcp", group_name="bw_tcp")
        # The yardstick: torch.distributed's own group over the same ranks.
        dist.init_process_group("gloo" if self.on_cpu else "nccl",
                                init_method=f"tcp://127.0.0.1:{port}", rank=self.rank,
                                world_size=self.world, timeout=datetime.timedelta(seconds=300))
        self.device = torch.device("cpu") if self.on_cpu else torch.device("cuda", 0)
        return {"rank": self.rank, "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": str(self.device),
                "device_name": None if self.on_cpu else torch.cuda.get_device_name(0)}

    def check_ops(self):
        """Every op on this rank's tensors; the expected values are computed
        here from the other ranks' inputs, which are known."""
        import torch

        from ray_tpu_torch.util.collective import ReduceOp

        col, g, r, n, dev = self.col, "bw", self.rank, self.world, self.device
        bad = []

        def expect(name, got, want):
            if got is None or want is None:
                if got is not want:
                    bad.append(name)
            elif not (str(got.device) == str(want.device) and torch.equal(got, want)):
                bad.append(name)

        for dtype in (torch.float32, torch.bfloat16):
            def x(rank):
                return (torch.arange(8 * n, device=dev) % 5 + rank + 1).to(dtype)

            xs = [x(i) for i in range(n)]
            stack = torch.stack(xs)
            dn = str(dtype).split(".")[1]
            want = {"sum": stack.sum(0), "product": stack.prod(0), "min": stack.min(0).values,
                    "max": stack.max(0).values, "mean": stack.sum(0) / n}
            for op in ReduceOp:
                got = col.allreduce(x(r), g, op)
                if op == ReduceOp.MEAN:
                    if not torch.allclose(got.float(), want["mean"].float(), rtol=1e-2):
                        bad.append(f"{dn} allreduce mean")
                else:
                    expect(f"{dn} allreduce {op.value}", got, want[op.value])
            expect(f"{dn} reduce", col.reduce(x(r), 1, g), want["sum"] if r == 1 else None)
            expect(f"{dn} broadcast", col.broadcast(x(r), 2, g), xs[2])
            for i, t in enumerate(col.allgather(x(r), g)):
                expect(f"{dn} allgather {i}", t, xs[i])
            expect(f"{dn} reducescatter", col.reducescatter(x(r), g),
                   want["sum"].chunk(n)[r])
            ring = [(i, (i + 1) % n) for i in range(n)]
            expect(f"{dn} sendrecv ring", col.sendrecv(x(r), ring, g), xs[(r - 1) % n])
            expect(f"{dn} sendrecv one", col.sendrecv(x(r), [(3, 0)], g),
                   xs[3] if r == 0 else torch.zeros_like(xs[0]))
            expect(f"{dn} allreduce_multidevice", col.allreduce_multidevice([x(r)], g)[0],
                   want["sum"])
            for i, t in enumerate(col.allgather_multidevice([x(r)], g)):
                expect(f"{dn} allgather_multidevice {i}", t, xs[i])
            expect(f"{dn} reducescatter_multidevice", col.reducescatter_multidevice([x(r)], g)[0],
                   want["sum"].chunk(n)[r])
            if r == 0:
                col.send(x(r), 1, g)
            elif r == 1:
                expect(f"{dn} send/recv", col.recv(xs[0].shape, dtype, 0, g), xs[0])
            col.barrier(g)
        return bad

    def bench(self, sizes_mib, dtypes, warmup, iters):
        """Seconds per allreduce through the group and through
        torch.distributed, per size and dtype (every rank runs the same
        sequence; rank 0's clock is reported)."""
        import torch
        import torch.distributed as dist

        sync = (lambda: None) if self.on_cpu else torch.cuda.synchronize
        out = []
        for dtype_name in dtypes:
            dtype = getattr(torch, dtype_name)
            for mib in sizes_mib:
                numel = mib * MIB // torch.tensor([], dtype=dtype).element_size()
                buf = torch.ones(numel, dtype=dtype, device=self.device)
                row = {"dtype": dtype_name, "mib": mib, "bytes": numel * buf.element_size()}
                for name, fn in (("ours", lambda: self.col.allreduce(buf, "bw")),
                                 ("torch", lambda: dist.all_reduce(buf))):
                    for _ in range(warmup):
                        fn()
                    sync()
                    dist.barrier()
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        fn()
                    sync()
                    row[f"{name}_s"] = (time.perf_counter() - t0) / iters
                out.append(row)
                del buf
        return out

    def bench_tcp(self, sizes_mib, iters):
        import torch.distributed as dist

        out = []
        for mib in sizes_mib:
            x = np.ones(mib * MIB // 4, np.float32)
            self.col.allreduce(x, "bw_tcp")
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(iters):
                self.col.allreduce(x, "bw_tcp")
            out.append({"dtype": "float32", "mib": mib, "bytes": x.nbytes,
                        "tcp_s": (time.perf_counter() - t0) / iters})
        return out

    def close(self):
        import torch.distributed as dist

        self.col.destroy_collective_group("bw")
        self.col.destroy_collective_group("bw_tcp")
        dist.destroy_process_group()


def _bandwidth(row, key, n):
    algbw = row["bytes"] / row[key] / 1e9
    return algbw, algbw * 2 * (n - 1) / n


def phase_collective_bw(smi, rehearse):
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=WORLD + 4)
    try:
        actor = ray_tpu_torch.remote(num_cpus=1, num_gpus=0 if rehearse else 1)(CollectiveWorker)
        workers = [actor.remote(r, WORLD, rehearse) for r in range(WORLD)]
        port = _free_port()
        setup = ray_tpu_torch.get([w.setup.remote(port) for w in workers], timeout=300)
        bad = ray_tpu_torch.get([w.check_ops.remote() for w in workers], timeout=300)
        sizes = (1, 4) if rehearse else ALLREDUCE_MIB
        bench = ray_tpu_torch.get(
            [w.bench.remote(sizes, ("float32", "bfloat16"), BW_WARMUP, BW_ITERS)
             for w in workers], timeout=900)[0]
        tcp = ray_tpu_torch.get([w.bench_tcp.remote((1,) if rehearse else TCP_MIB, TCP_ITERS)
                                 for w in workers], timeout=900)[0]
        ray_tpu_torch.get([w.close.remote() for w in workers], timeout=120)
    finally:
        ray_tpu_torch.shutdown()
    for row in bench:
        for key in ("ours", "torch"):
            row[f"{key}_algbw_gbps"], row[f"{key}_busbw_gbps"] = _bandwidth(row, f"{key}_s", WORLD)
    for row in tcp:
        row["tcp_algbw_gbps"], row["tcp_busbw_gbps"] = _bandwidth(row, "tcp_s", WORLD)
    line = {"phase": "collective_bw", "world": WORLD, "ranks": setup,
            "mismatches_per_rank": bad, "allreduce": bench, "tcp_allreduce": tcp,
            "timing": f"host clock around {BW_ITERS} back-to-back calls after {BW_WARMUP}, "
                      "synchronized, rank 0", "card": smi}
    record(line)
    require(not any(bad), f"collective_bw: ops that disagree, per rank: {bad}")
    if not rehearse:
        require(len({s["cuda_visible_devices"] for s in setup}) == WORLD,
                f"collective_bw: actors share a GPU: {setup}")
    return line


# ---------------------------------------------------------------------------- trainer phases
def one_card_baseline(smi, rehearse):
    """The main path on card 0 (tokens/s), and the one-card loss of the
    initial weights on the gpt2 phases' global batch (the mean of its four
    16-row chunks' means)."""
    import torch

    from ray_tpu_torch.models import GPTConfig, gpt

    if rehearse:
        cfg = GPTConfig(**NANO_GPT)
        device, items = "cpu", 4 * 32
    else:
        cfg = GPTConfig.gpt2_small()
        device, items = None, chip_smoke.B * S
    seq = 32 if rehearse else S
    gb = 8 if rehearse else GPT_GLOBAL_B
    out = {}
    if not rehearse:
        cfg_, opt, state, batch = chip_smoke.build_workload()
        state, _, run = chip_smoke.run_steps(cfg_, opt, state, batch, items=items)
        out.update(main_path_tokens_per_s=run["items_per_s"],
                   main_path_step_ms_median=run["step_ms_median"],
                   main_path_losses=run["losses"][:3])
        del state, batch
        torch.cuda.empty_cache()
    params = gpt.init_params(cfg, 0, device)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size - 1, (gb, seq + 1))
    chunks = []
    with torch.no_grad():
        for rows in np.split(tokens.astype(np.int32), 4):
            batch = {"tokens": torch.as_tensor(rows, device=params["wte"].device)}
            chunks.append(gpt.loss_fn(params, batch, cfg).item())
    del params
    if not rehearse:
        torch.cuda.empty_cache()
    out["one_card_loss_global_batch"] = float(np.mean(chunks))
    record({"phase": "one_card_baseline", **out, "card": smi})
    return out


def trainer_phase(name, smi, rehearse, mesh, model, global_batch, seq, warmup, timed, cut=None):
    from ray_tpu_torch.air import ScalingConfig

    cut = dict(cut or {})
    if rehearse:
        cut = {**(NANO_LLAMA if model == "llama3_8b" else NANO_GPT),
               **{k: v for k, v in cut.items() if k == "n_layer"}}
        global_batch = min(global_batch, 8 if model != "llama3_8b" else 4)
        seq, warmup, timed = 32, 1, 1
    scaling = ScalingConfig(num_workers=WORLD, use_gpu=not rehearse, mesh=mesh)
    config = {"model": model, "cut": cut, "global_batch": global_batch, "seq": seq,
              "warmup": warmup, "timed": timed}
    if rehearse:
        config["device"] = "cpu"
    out = chip_smoke.run_mesh_gang(scaling, "gloo" if rehearse else "nccl", config,
                                   f"multichip_{name}")
    ranks = out["ranks"]
    r0 = ranks[0]
    tokens_per_gpu = [r["items_per_s"] for r in ranks]
    line = {"phase": name, "entry": "TorchTrainer.fit", "model": model,
            "n_layer": r0["n_layer"], "mesh": mesh or {"data": WORLD}, "backend": r0["backend"],
            "global_batch": global_batch, "seq": seq, "mesh_shape": r0["mesh_shape"],
            "losses": r0["losses"], "grad_norms": r0["grad_norms"],
            "step_ms_median_per_rank": [r["step_ms_median"] for r in ranks],
            "tokens_per_s_per_gpu": tokens_per_gpu,
            "collective_ms_per_step_per_rank": [r["collective_ms_per_step"] for r in ranks],
            "peak_memory_gib_per_rank": [r["peak_memory_gib"] for r in ranks],
            "state_peak_gib_per_rank": [r["state_peak_gib"] for r in ranks],
            "init_s_per_rank": [r["init_s"] for r in ranks],
            "launches_per_step_rank0": r0["launches_per_step"],
            "p2p_overlap_per_step_per_rank": [r["p2p_overlap_per_step"] for r in ranks],
            "devices": [(r["cuda_visible_devices"], r["device"]) for r in ranks],
            "fit_s": out["fit_s"], "leftover_session_dirs": out["leftover_session_dirs"],
            "leftover_worker_pids": out["leftover_worker_pids"], "card": smi}
    require(all(math.isfinite(x) for r in ranks for x in r["losses"]),
            f"{name}: non-finite loss")
    require(all(r["losses"] == r0["losses"] for r in ranks), f"{name}: ranks disagree on the loss")
    require(not out["leftover_session_dirs"] and not out["leftover_worker_pids"],
            f"{name}: left after shutdown")
    if not rehearse:
        require(len({r["cuda_visible_devices"] for r in ranks}) == WORLD,
                f"{name}: ranks share a GPU: {line['devices']}")
    return line, ranks


def check_launches(name, ranks, mesh, n_layer, global_batch, rehearse):
    """Each rank's launches per step: n_layer each off a pipeline or context
    axis, else ``chip_smoke.pipe_ctx_expected_launches``."""
    if rehearse:
        return
    expected = chip_smoke.pipe_ctx_expected_launches(mesh or {"data": WORLD}, n_layer,
                                                     global_batch)
    for r in ranks:
        chip_smoke.check_launches(f"{name} rank {r['rank']}", r, expected[r["rank"]])


def phase_gpt2(name, mesh, smi, rehearse, baseline, dp_first_loss=None):
    line, ranks = trainer_phase(name, smi, rehearse, mesh, "gpt2_small", GPT_GLOBAL_B, S,
                                GPT_WARMUP, GPT_TIMED)
    first = line["losses"][0]
    line["one_card_loss_global_batch"] = baseline["one_card_loss_global_batch"]
    line["first_loss_abs_err_vs_one_card"] = abs(first - baseline["one_card_loss_global_batch"])
    if "main_path_tokens_per_s" in baseline:
        line["one_card_main_path_tokens_per_s"] = baseline["main_path_tokens_per_s"]
        line["tokens_per_s_per_gpu_over_one_card"] = [
            t / baseline["main_path_tokens_per_s"] for t in line["tokens_per_s_per_gpu"]]
    if dp_first_loss is not None:
        line["first_loss_abs_err_vs_dp4"] = abs(first - dp_first_loss)
    record(line)
    check_launches(name, ranks, mesh, 12, GPT_GLOBAL_B, rehearse)
    require(line["first_loss_abs_err_vs_one_card"] <= FIRST_LOSS_TOL,
            f"{name}: first loss {first} vs one card {baseline['one_card_loss_global_batch']}")
    if dp_first_loss is not None:
        require(line["first_loss_abs_err_vs_dp4"] <= FIRST_LOSS_TOL,
                f"{name}: first loss {first} vs gpt2_dp4's {dp_first_loss}")
    return line


def llama_line(name, line, cfg, seq, rehearse):
    """Params, flops per token and MFU per GPU for a Llama phase's line."""
    from ray_tpu_torch.models import llama

    flops = llama.train_flops_per_token(cfg, seq)
    line.update(params=llama.num_params(cfg), train_flops_per_token=flops,
                mfu_per_gpu=[flops * t / PEAK_BF16_FLOPS for t in line["tokens_per_s_per_gpu"]],
                mfu_peak="989 TFLOP/s, H100 SXM dense bf16")
    return line


def phase_llama(smi, rehearse, name="llama3_8b_fsdp4", mesh=None, fsdp=None):
    """Llama 3 8B at full depth: ``{"fsdp": 4}``, or ``{"pipeline": 4}``
    (``llama3_8b_pp4``), B 4 x S 8192; beside ``fsdp``, the fsdp4 phase's
    line of this run where it ran (the same weights and batch)."""
    from ray_tpu_torch.models import LlamaConfig

    import dataclasses

    mesh = mesh or {"fsdp": WORLD}
    line, ranks = trainer_phase(name, smi, rehearse, mesh, "llama3_8b", LLAMA_GLOBAL_B,
                                LLAMA_S, 1, LLAMA_STEPS - 1)
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), **(NANO_LLAMA if rehearse else {}))
    seq = line["seq"] if not rehearse else 32
    expected = chip_smoke.init_loss_expected(cfg.vocab_size, cfg.d_model)
    line.update(init_loss_expected=expected,
                first_loss_abs_err_vs_init=abs(line["losses"][0] - expected))
    if fsdp is not None:
        line.update(fsdp4_losses=fsdp["losses"],
                    first_loss_abs_err_vs_fsdp4=abs(line["losses"][0] - fsdp["losses"][0]))
    if mesh.get("pipeline", 1) > 1:
        from ray_tpu_torch.parallel.pipeline import default_microbatches

        m = default_microbatches(line["global_batch"], mesh["pipeline"])
        line.update(microbatches=m, bubble_share=chip_smoke.bubble_share(mesh["pipeline"], m))
    record(llama_line(name, line, cfg, seq, rehearse))
    check_launches(name, ranks, mesh, cfg.n_layer, LLAMA_GLOBAL_B, rehearse)
    if not rehearse:
        require(line["first_loss_abs_err_vs_init"] <= chip_smoke.INIT_LOSS_TOL,
                f"{name}: first loss {line['losses'][0]}, expected {expected} at init")
    if fsdp is not None:
        require(line["first_loss_abs_err_vs_fsdp4"] <= FIRST_LOSS_TOL,
                f"{name}: first loss {line['losses'][0]} vs fsdp4's {fsdp['losses'][0]}")
    return line


def llama_one_card(smi, rehearse, layers):
    """Llama 3 8B cut to ``layers`` layers on card 0 in this process, on the
    cp phase's row (numpy seed 0): the first loss, and tokens/s over 2 timed
    steps after 1 (the rehearsal: the first loss alone, on the CPU)."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import (LlamaConfig, create_train_state, default_optimizer,
                                      shard_batch)

    cut = {**NANO_LLAMA, "n_layer": layers} if rehearse else {"n_layer": layers}
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), **cut)
    seq = 32 if rehearse else LLAMA_S
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size - 1, (1, seq + 1))
    device = "cpu" if rehearse else None
    batch = shard_batch({"tokens": tokens.astype(np.int32)}, device=device)
    opt = default_optimizer(learning_rate=3e-4)
    state = create_train_state(cfg, 0, opt, device=device)
    if rehearse:
        from ray_tpu_torch.models import llama

        with torch.no_grad():
            out = {"losses": [llama.loss_fn(state.params, batch, cfg).item()]}
    else:
        _, _, run = chip_smoke.run_steps(cfg, opt, state, batch, warmup=1, timed=2, items=seq)
        out = {k: run[k] for k in ("losses", "step_ms_median", "items_per_s", "peak_memory_gib")}
    del state, batch
    if not rehearse:
        torch.cuda.empty_cache()
    record({"phase": "llama_one_card", "n_layer": layers, "seq": seq, **out, "card": smi})
    return out


def phase_llama_cp4(smi, rehearse):
    """Llama 3 8B at full width cut to 4 layers on ``{"context": 4}``, one row
    of S 8192, against the same on card 0."""
    from ray_tpu_torch.models import LlamaConfig

    import dataclasses

    name, mesh = "llama3_8b_cp4", {"context": WORLD}
    one = llama_one_card(smi, rehearse, LLAMA_CP_LAYERS)
    line, ranks = trainer_phase(name, smi, rehearse, mesh, "llama3_8b", 1, LLAMA_S, 1,
                                LLAMA_STEPS - 1, cut={"n_layer": LLAMA_CP_LAYERS})
    cut = {**NANO_LLAMA, "n_layer": LLAMA_CP_LAYERS} if rehearse else {"n_layer": LLAMA_CP_LAYERS}
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), **cut)
    line.update(one_card_first_loss=one["losses"][0],
                first_loss_abs_err_vs_one_card=abs(line["losses"][0] - one["losses"][0]))
    if "items_per_s" in one:
        line.update(one_card_tokens_per_s=one["items_per_s"],
                    tokens_per_s_per_gpu_over_one_card=[t / one["items_per_s"]
                                                        for t in line["tokens_per_s_per_gpu"]])
    record(llama_line(name, line, cfg, line["seq"] if not rehearse else 32, rehearse))
    check_launches(name, ranks, mesh, cfg.n_layer, 1, rehearse)
    require(line["first_loss_abs_err_vs_one_card"] <= FIRST_LOSS_TOL,
            f"{name}: first loss {line['losses'][0]} vs one card's {one['losses'][0]}")
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rehearse", action="store_true",
                        help="run every phase on the CPU at toy sizes")
    parser.add_argument("phases", nargs="*", help=f"any of {', '.join(PHASES)} (default: all)")
    args = parser.parse_args(argv)
    unknown = set(args.phases) - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")
    args.phases = args.phases or list(PHASES)
    rehearse = args.rehearse
    import torch

    if not rehearse:
        if torch.cuda.device_count() < WORLD:
            raise SystemExit(f"port_multichip: needs {WORLD} GPUs, sees {torch.cuda.device_count()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # The link type: `topo -m` where the host allows it, NVLink status
        # and CUDA's peer access between every pair of cards.
        topo = {}
        for cmd in (["nvidia-smi", "topo", "-m"], ["nvidia-smi", "nvlink", "--status"]):
            p = subprocess.run(cmd, capture_output=True, text=True)
            topo[" ".join(cmd[1:])] = {"rc": p.returncode, "out": p.stdout[-4000:],
                                       "err": p.stderr[-1000:]}
            print(p.stdout or p.stderr, flush=True)
        n = torch.cuda.device_count()
        topo["peer_access"] = [[i == j or torch.cuda.can_device_access_peer(i, j)
                                for j in range(n)] for i in range(n)]
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
    else:
        topo, smi = "rehearsal on the CPU", ["cpu"]
    record({"phase": "cards", "nvidia_smi": smi, "topo": topo, "torch": torch.__version__,
            "cuda": torch.version.cuda, "rehearse": rehearse})
    card = smi[0]
    t0 = time.perf_counter()
    lines = {}
    if "collective_bw" in args.phases:
        lines["collective_bw"] = phase_collective_bw(card, rehearse)
    gpt_phases = [p for p in args.phases if p.startswith("gpt2")]
    if gpt_phases:
        baseline = one_card_baseline(card, rehearse)
        dp = phase_gpt2("gpt2_dp4", None, card, rehearse, baseline)
        for name, mesh in (("gpt2_fsdp4", {"fsdp": WORLD}),
                           ("gpt2_dp2_tp2", {"data": 2, "tensor": 2}),
                           ("gpt2_pp2_dp2", {"pipeline": 2, "data": 2}),
                           ("gpt2_cp2_dp2", {"data": 2, "context": 2})):
            if name in gpt_phases:
                phase_gpt2(name, mesh, card, rehearse, baseline, dp["losses"][0])
    fsdp = phase_llama(card, rehearse) if "llama3_8b_fsdp4" in args.phases else None
    if "llama3_8b_pp4" in args.phases:
        phase_llama(card, rehearse, "llama3_8b_pp4", {"pipeline": WORLD}, fsdp)
    if "llama3_8b_cp4" in args.phases:
        phase_llama_cp4(card, rehearse)
    record({"phase": "done", "seconds": time.perf_counter() - t0, "phases": args.phases})


if __name__ == "__main__":
    main()
