#!/usr/bin/env python3
"""The readings that the check's limits are set from, at a cell's own size.

    python3 port_bench/control.py --workload <cell> [--seeds 12] [--control-seeds 3]
        [--fault-seeds 3] [--out FILE]

For each seed, the program's first ``checked_steps`` steps on the window's
path (``loop.Worker``) against the float32 reference: the sound readings,
whose largest sets a limit's lower end. For the first ``--control-seeds``,
the control: the reference itself in the precision below the
configuration's (``reference/<reference>.py``, ``precision="fp8"``) against
the float32 reference. For the first ``--fault-seeds``, each fault of
``faults.py`` that the cell can have, planted in the program. Every reading
is a JSON line on standard output (and in ``--out``). No benchmark run runs
this: a cell's runs compare against ``limits/<cell>.json``.

A cell on one GPU runs in this process; a cell on more runs the same plan
in each worker of a ``TorchTrainer`` gang, the reference on rank 0. The
tests call ``readings(..., device="cpu")``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST_SEED, SEED_STEP = 2**31 + 7919, 104729


def cell_faults(cell):
    return ("unchanged", "half_batch") + (("no_exchange",) if cell["traffic"].get("workers", 1) > 1
                                          else ())


def plan(cell, seeds, control_seeds, fault_seeds):
    out = [("program", s, None) for s in seeds]
    out += [("control", s, None) for s in seeds[:control_seeds]]
    out += [("fault", s, f) for f in cell_faults(cell) for s in seeds[:fault_seeds]]
    return out


def run_plan(cell, steps, device, mesh=None, rank=0, world=1):
    """The readings of each (kind, seed, fault) of ``steps``, on rank 0 (None
    on the others)."""
    import torch

    from port_bench import check, faults
    from port_bench.loop import Worker, reference_readings

    references, lines = {}, []

    def reference(seed):
        if seed not in references:
            references[seed] = reference_readings(cell, seed, device)
        return references[seed]

    for kind, seed, fault in steps:
        t = time.perf_counter()
        if kind == "control":
            ranks = ([{"program": reference_readings(cell, seed, device, "fp8")}] if rank == 0
                     else [])
        else:
            undo = faults.plant(fault, cell["model"]) if fault else None
            try:
                w = Worker(cell, seed, device, mesh, rank, world)
                w.build()
                mine = w.checked_steps()
                w.free()
            finally:
                if undo:
                    undo()
            ranks = [{"program": mine}]
            if world > 1:
                import torch.distributed as dist

                gathered = [None] * world if rank == 0 else None
                dist.gather_object(mine, gathered, dst=0)
                ranks = [{"program": p} for p in gathered] if rank == 0 else []
        if rank == 0:
            g = check.worst_over_ranks(ranks, reference(seed))
            lines.append({"kind": kind, "fault": fault, "seed": seed, **g,
                          "program": [r["program"] for r in ranks],
                          "reference": reference(seed), "seconds": time.perf_counter() - t})
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return lines if rank == 0 else None


def control_loop(config):
    """``run_plan`` in each worker of a gang."""
    import torch

    from ray_tpu_torch.air import session

    rank, world = session.get_world_rank(), session.get_world_size()
    if config["device"] == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    mesh = session.get_mesh()
    lines = run_plan(config["cell"], config["steps"], device, mesh, rank, world)
    session.report({"lines": lines})


def readings(cell, steps, device="cuda"):
    import torch

    workers = cell["traffic"].get("workers", 1)
    if workers == 1:
        return run_plan(cell, steps, torch.device(device))
    import ray_tpu_torch
    import ray_tpu_torch.train.torch as rt_torch
    from ray_tpu_torch.air import FailureConfig, RunConfig, ScalingConfig

    on_card = device == "cuda"
    ray_tpu_torch.init(num_cpus=max(4, workers + 2), num_gpus=workers if on_card else 0,
                       log_to_driver=False)
    try:
        session_dir = ray_tpu_torch._private.worker.global_worker.session_dir
        trainer = rt_torch.TorchTrainer(
            control_loop, train_loop_config={"cell": cell, "steps": steps, "device": device},
            scaling_config=ScalingConfig(num_workers=workers, use_gpu=on_card,
                                         mesh=cell["traffic"].get("mesh")),
            backend_config=rt_torch.TorchConfig(backend="nccl" if on_card else "gloo",
                                                device=None if on_card else "cpu"),
            run_config=RunConfig(name="port_bench_control",
                                 storage_path=os.path.join(session_dir, "results"),
                                 failure_config=FailureConfig(max_failures=0)))
        result = trainer.fit()
        if result.error is not None:
            raise result.error
        return result.metrics["lines"]
    finally:
        ray_tpu_torch.shutdown()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from port_bench import cells
    from port_bench.run import cache_dirs

    cell = cells.resolve(args.workload)
    cache_dirs(ROOT)
    seeds = [FIRST_SEED + SEED_STEP * i for i in range(args.seeds)]
    lines = readings(cell, plan(cell, seeds, args.control_seeds, args.fault_seeds))
    for line in lines:
        line["workload"] = args.workload
        print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
