"""What DTensor's own sharding propagation does with the port's model on a
mesh, on the torch this machine has.

    python3 tools/port_dtensor_probe.py [--rehearse] [embedding] [host_cost]

``--rehearse`` runs ``host_cost`` on the CPU with nano GPT.

The port runs its mesh forward on local shards with the collectives written
out (``ray_tpu_torch/parallel/spmd.py``). This script measures the two
reasons it gives for not leaving them to DTensor's propagation, one JSON
line each (rank 0's), also appended to ``chiprun_out/port_dtensor_probe.jsonl``:

- ``embedding`` (CPU, 4 gloo ranks, runs anywhere): ``F.embedding`` of
  batch-sharded tokens in a table sharded on its vocab rows over ``tensor``,
  by DTensor propagation, on the port's six-axis mesh (``{data 2, tensor
  2}``), on a 2-D ``(data, tensor)`` mesh and on a 1-D ``tensor`` mesh of 4:
  whether it runs, and its largest error against the plain lookup. Then the
  nano GPT loss (f32) from DTensor params placed by ``ShardingRules`` on the
  six-axis mesh, every op dispatched through DTensor (the model's plain path
  with ``mesh=None``; attention through ``local_map``): its loss and
  gradients against the port's mesh path, the first error, or, when it has
  not finished in ``PROPAGATION_LIMIT_S``, where rank 0 was then.
- ``host_cost`` (one GPU): GPT-2 small at full width and depth, bf16, B 8 x
  S 1024, forward and backward, with every param a DTensor replicated on a
  world-1 mesh (so DTensor dispatches every op but moves nothing; the
  attention kernels and the f32 head through ``local_map``), the port's
  six-axis mesh and a 1-D one, against the same step on plain tensors: the
  first step's seconds (DTensor propagates each new op's sharding then), the
  host's time to issue a step and the step's time, medians of
  ``HOST_COST_STEPS`` after two, CUDA events for the step.
"""

from __future__ import annotations

import faulthandler
import functools
import json
import os
import socket
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "chiprun_out", "port_dtensor_probe.jsonl")
RANKS = 4
HOST_COST_B, HOST_COST_S, HOST_COST_STEPS = 8, 1024, 10
PROPAGATION_LIMIT_S = 120


def emit(line):
    text = json.dumps(line)
    print(text, flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(text + "\n")


def _error(e):
    frames = traceback.extract_tb(e.__traceback__)
    return {"error": f"{type(e).__name__}: {str(e)[:400]}",
            "where": [f"{os.path.basename(f.filename)}:{f.lineno}" for f in frames[-4:]]}


def _attention_local_map(mesh, attention):
    """``attention(q, k, v)`` on each rank's (batch, heads) block."""
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.parallel.mesh import spec_placements

    qkv = spec_placements([("data", "fsdp"), "tensor", None, None])
    return local_map(lambda q, k, v: attention(q, k, v, causal=True), out_placements=qkv,
                     in_placements=(qkv, qkv, qkv), device_mesh=mesh, redistribute_inputs=True)


def rank_embedding(rank):
    """One rank of the ``embedding`` phase; rank 0 prints its line in two
    parts, the second after the propagated forward."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from ray_tpu_torch.models import GPTConfig, gpt, shard_batch
    from ray_tpu_torch.models.training import tree_leaves
    from ray_tpu_torch.ops import xla_attention
    from ray_tpu_torch.parallel import MeshSpec, ShardingRules, shard_params

    line = {"phase": "embedding", "torch": torch.__version__, "ranks": RANKS}
    torch.manual_seed(0)
    V, D, B, S = 256, 64, 4, 32
    table = torch.randn(V, D)
    tokens = torch.randint(0, V, (B, S))
    want = F.embedding(tokens, table)
    meshes = {
        "six_axis_data2_tensor2": (MeshSpec(data=2, tensor=2).build("cpu"), 5, 0),
        "2d_data2_tensor2": (init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "tensor")),
                             1, 0),
        "1d_tensor4": (init_device_mesh("cpu", (4,), mesh_dim_names=("tensor",)), 0, None),
    }
    for name, (mesh, tensor_dim, data_dim) in meshes.items():
        t_pl = [Replicate()] * mesh.ndim
        t_pl[tensor_dim] = Shard(0)
        x_pl = [Replicate()] * mesh.ndim
        if data_dim is not None:
            x_pl[data_dim] = Shard(0)
        try:
            got = F.embedding(distribute_tensor(tokens, mesh, x_pl),
                              distribute_tensor(table, mesh, t_pl)).full_tensor()
            line[name] = {"ok": True, "max_abs_err": float((got - want).abs().max())}
        except Exception as e:  # the finding itself
            line[name] = {"ok": False, **_error(e)}

    cfg = GPTConfig.nano(dtype=torch.float32)
    mesh = MeshSpec(data=2, tensor=2).build("cpu")
    full = gpt.init_params(cfg, 0, device="cpu")
    batch_np = {"tokens": np.random.default_rng(0).integers(0, 256, (B, S + 1)).astype(np.int32)}

    def loss_and_grads(propagate):
        params = shard_params(full, mesh, ShardingRules(), gpt.param_logical_axes(cfg))
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        batch = shard_batch(batch_np, mesh)
        if propagate:
            loss = gpt.loss_fn(params, batch, cfg, _attention_local_map(mesh, xla_attention))
        else:
            loss = gpt.loss_fn(params, batch, cfg, mesh=mesh)
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.full_tensor() if hasattr(loss, "full_tensor") else loss).item(), [
            g.full_tensor() for g in grads]

    ref_loss, ref_grads = loss_and_grads(False)
    line["gpt_nano_spmd_loss"] = ref_loss
    if rank == 0:
        print(json.dumps(line), flush=True)
    # A propagation that runs past the limit prints every thread's stack and
    # exits; the parent reads rank 0's.
    faulthandler.dump_traceback_later(PROPAGATION_LIMIT_S, exit=True)
    t0 = time.perf_counter()
    try:
        loss, grads = loss_and_grads(True)
        out = {"ok": True, "s": time.perf_counter() - t0, "loss": loss,
               "max_abs_grad_err": max(float((a - b).abs().max())
                                       for a, b in zip(grads, ref_grads))}
    except Exception as e:
        out = {"ok": False, "s": time.perf_counter() - t0, **_error(e)}
    faulthandler.cancel_dump_traceback_later()
    if rank == 0:
        print(json.dumps({"gpt_nano_propagation": out}), flush=True)


def phase_embedding():
    """Runs ``rank_embedding`` in RANKS gloo processes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), str(port)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROPAGATION_LIMIT_S + 180))
    finally:
        for p in procs:
            p.kill()
    lines = [json.loads(x) for x in outs[0][0].splitlines() if x.startswith("{")]
    if not lines:
        print("\n".join(err[-3000:] for _, err in outs), file=sys.stderr)
        raise SystemExit("embedding: rank 0 printed nothing")
    line = lines[0]
    if len(lines) > 1:
        line.update(lines[1])
    else:
        frames = [x.strip() for x in outs[0][1].splitlines() if x.strip().startswith("File ")]
        ours = [f for f in frames if "ray_tpu_torch" in f or "port_dtensor_probe" in f]
        line["gpt_nano_propagation"] = {"ok": False, "did_not_finish_in_s": PROPAGATION_LIMIT_S,
                                        "rank0_stack": frames[:3] + ours[:6]}
    emit(line)


def phase_host_cost(rehearse):
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.models import GPTConfig, gpt
    from ray_tpu_torch.models.training import tree_leaves, tree_map
    from ray_tpu_torch.ops import flash_attention, launch_counts, reset_launch_counts
    from ray_tpu_torch.ops.basic import HeadF32
    from ray_tpu_torch.parallel import MeshSpec

    if rehearse:
        smi, device, backend, cfg, (b, seq) = "cpu", "cpu", "gloo", GPTConfig.nano(), (2, 32)
        torch.cuda.synchronize = lambda: None
    else:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
        device, backend, cfg, (b, seq) = "cuda", "nccl", GPTConfig.gpt2_small(), (
            HOST_COST_B, HOST_COST_S)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    mesh = MeshSpec(data=1).build(device)
    full = gpt.init_params(cfg, 0, device=device)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size - 1, (b, seq + 1)).astype(np.int32), device=device)
    plain_head = gpt._lm_head

    def attention(q, k, v):
        return flash_attention(q, k, v, causal=True)

    def head_f32(x, w):
        return HeadF32.apply(x, w)

    def dtensor_head(head, x, w):
        if x.dtype == torch.float32:
            return x @ w.t()
        return head(x.reshape(-1, x.shape[-1]), w).view(*x.shape[:-1], w.shape[0])

    line = {"phase": "host_cost", "torch": torch.__version__, "card": smi,
            "batch": [b, seq], "steps": HOST_COST_STEPS}
    meshes = {"dtensor_six_axis": mesh,
              "dtensor_1d": init_device_mesh(device, (1,), mesh_dim_names=("data",))}
    for name in ("plain", *meshes):
        if name == "plain":
            params = tree_map(lambda t: t.detach().requires_grad_(True), full)
            batch, fn = {"tokens": tokens}, None
        else:
            m = meshes[name]
            r = [Replicate()] * m.ndim
            params = tree_map(lambda t: distribute_tensor(t.detach(), m, r).requires_grad_(True),
                              full)
            batch = {"tokens": distribute_tensor(tokens, m, r)}
            fn, head = (local_map(f, out_placements=r, in_placements=(r,) * n, device_mesh=m)
                        for f, n in ((attention, 3), (head_f32, 2)))
            gpt._lm_head = functools.partial(dtensor_head, head)
        leaves = tree_leaves(params)
        host, step = [], []
        cuda = device == "cuda"
        try:
            for i in range(HOST_COST_STEPS + 2):
                reset_launch_counts()
                torch.cuda.synchronize()
                if cuda:
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                t0 = time.perf_counter()
                loss = gpt.loss_fn(params, batch, cfg, fn)
                grads = torch.autograd.grad(loss, leaves)
                t1 = time.perf_counter()
                if cuda:
                    end.record()
                torch.cuda.synchronize()
                if i == 0:
                    first_s = time.perf_counter() - t0
                if i >= 2:
                    host.append((t1 - t0) * 1e3)
                    step.append(start.elapsed_time(end) if cuda else (t1 - t0) * 1e3)
            loss_value = float(loss.full_tensor() if name != "plain" else loss.detach())
            line[name] = {"host_ms": float(np.median(host)), "step_ms": float(np.median(step)),
                          "first_step_s": first_s, "loss": loss_value,
                          "launches": dict(launch_counts())}
            del grads
        except Exception as e:
            line[name] = {"ok": False, **_error(e)}
        finally:
            gpt._lm_head = plain_head
    for name in meshes:
        if "host_ms" in line["plain"] and "host_ms" in line[name]:
            line[name]["host_ms_added"] = line[name]["host_ms"] - line["plain"]["host_ms"]
            line[name]["step_ms_added"] = line[name]["step_ms"] - line["plain"]["step_ms"]
    dist.destroy_process_group()
    emit(line)


def main(argv):
    if argv[:1] == ["--rank"]:
        import datetime

        import torch.distributed as dist

        rank, port = int(argv[1]), int(argv[2])
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=RANKS, timeout=datetime.timedelta(seconds=60))
        rank_embedding(rank)
        dist.destroy_process_group()
        return
    rehearse = "--rehearse" in argv
    phases = [a for a in argv if a != "--rehearse"] or ["embedding", "host_cost"]
    if "embedding" in phases:
        phase_embedding()
    if "host_cost" in phases:
        phase_host_cost(rehearse)


if __name__ == "__main__":
    main(sys.argv[1:])
