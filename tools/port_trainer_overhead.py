#!/usr/bin/env python3
"""Where the time goes between the port's bare train loop and the same loop
through ``TorchTrainer.fit()``, on one NVIDIA GPU.

Runs ``chip_smoke.py``'s workload (``build_workload`` + ``run_steps``: GPT-2
small, B 16 x S 1024, bf16, 3 warmup and 10 timed steps) in turns, in one
process on one card:

- ``main``: in this process's main thread, as ``chip_smoke.py``'s main path;
- ``thread``: in a second thread of this process, as the Train session
  thread runs it in a worker;
- ``wakers``: in the main thread, with threads beside it that wake as the
  runtime's do in a worker (10 Hz like the ref flusher, 5 Hz like the result
  poll, 1 Hz like the heartbeat and the metrics flush) and take the GIL for a
  moment each time;
- ``trainer``: through ``ray_tpu_torch.init`` and ``TorchTrainer.fit()`` with
  one GPU worker, as ``chip_smoke.py``'s trainer phase (without its profiler
  window);
- ``subprocess``: in the main thread of a fresh Python process started for
  it, with no runtime, and ``CUDA_VISIBLE_DEVICES=0`` as the trainer's worker
  has it (``bench.py``'s clean-subprocess bare run);
- ``subprocess_thread``: the same in a second thread of that process.

Each run prints one JSON line: median step ms, tokens/s and the 10 timed
step ms. Then the card's name and power limit.

Run from the root of a checkout: ``python3 tools/port_trainer_overhead.py
[RUN ...]``; the runs default to main, thread, wakers, trainer, trainer,
wakers, thread, main.
"""

from __future__ import annotations

import json
import os
import sys
import subprocess
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

KEYS = ("step_ms_median", "items_per_s", "step_ms_timed")


def workload():
    import torch

    cfg, opt, state, batch = chip_smoke.build_workload()
    _, _, out = chip_smoke.run_steps(cfg, opt, state, batch)
    del state, batch
    torch.cuda.empty_cache()
    return {k: out[k] for k in KEYS}


def in_thread():
    box = {}
    t = threading.Thread(target=lambda: box.update(workload()), name="loop")
    t.start()
    t.join()
    return box


def with_wakers():
    stop = threading.Event()

    def waker(period):
        x = 0
        while not stop.wait(period):
            x = sum(range(100)) + x  # a moment of Python under the GIL

    threads = [threading.Thread(target=waker, args=(p,), daemon=True)
               for p in (0.1, 0.2, 1.0, 1.0)]
    for t in threads:
        t.start()
    try:
        return workload()
    finally:
        stop.set()
        for t in threads:
            t.join()


def trainer_loop(config):
    from ray_tpu_torch.air import session

    session.report(workload())


def through_trainer():
    import ray_tpu_torch
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    ray_tpu_torch.init(num_cpus=4)
    try:
        result = TorchTrainer(
            trainer_loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=True)
        ).fit()
    finally:
        ray_tpu_torch.shutdown()
    return result.metrics


def in_subprocess(thread=False):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", "thread" if thread else "main"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, text=True, check=True,
    )
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_trainer_overhead: no CUDA device")
    from ray_tpu_torch.ops import _build

    _build.build()
    smi = chip_smoke.nvidia_smi()
    runs = {"main": workload, "thread": in_thread, "wakers": with_wakers,
            "trainer": through_trainer, "subprocess": in_subprocess,
            "subprocess_thread": lambda: in_subprocess(thread=True)}
    order = sys.argv[1:] or ["main", "thread", "wakers", "trainer", "trainer", "wakers",
                             "thread", "main"]
    for name in order:
        out = runs[name]()
        print(json.dumps({"run": name, "card": smi, **out}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(in_thread() if sys.argv[2] == "thread" else workload()), flush=True)
    else:
        main()
