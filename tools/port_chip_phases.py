#!/usr/bin/env python3
"""Run chosen phases of ``chip_smoke.py`` on one NVIDIA GPU, from this
checkout or from another one (e.g. a parent commit unpacked with
``git archive``), to compare two trees on one card.

    python3 tools/port_chip_phases.py [--checkout DIR] PHASE [PHASE ...]

PHASE is ``resnet50`` (ResNet-50 at B 128), ``rl_learner_check`` (every RL
loss, card against CPU), ``rl`` (every RLlib phase: the learner check and the
mesh learner, then on one runtime PPO, DQN, two learners, A2C, PG, IMPALA and
APPO (``rl_onpolicy``), SAC and TD3 (``rl_continuous``), Ape-X DQN
(``rl_apex``), BC, MARWIL and CQL from JSON (``rl_offline``), and the
shutdown check), ``mesh`` (``collective_nccl``, then
``mesh_gang`` against the main path's first step, taken here) or
``pipe_ctx`` (``ring_check``, then ``pipe_ctx_gang`` against the same) or
``mesh_rest`` (``moe``, then ``expert_tp_gang`` against it,
``elastic_reshard`` and ``rl_mesh_learner``) or ``predictor`` (GPT-2 small from seed 0
through ``save_pytree``/``load_pytree`` and ``TorchPredictor``) or ``rl_multi_agent``
(multi-agent PPO, DQN and SAC on a runtime of their own, then its shutdown
check) or ``data`` (``batch_predictor`` and ``data_ingest`` on GPT-2 small
from seed 0, on a runtime of their own, then its shutdown check) or ``serve``
(GPT-2 small from seed 0 behind Serve on two 0.5-GPU replicas over HTTP and
a handle, then a multiplexed replica, on a runtime of its own, then its
shutdown check) or ``tune`` (a Trainer sweep of two 0.5-GPU trials of GPT-2
small from seed 0, then PBT on two 0.5-GPU function trials with an exploit,
on a runtime of its own, then its shutdown check) or ``cli_job`` (a head
started with ``python -m ray_tpu_torch start --head --num-gpus 1``, a
submitted job that trains GPT-2 small from seed 0 on one GPU worker, the
cluster's state through the CLI and the dashboard, then ``stop``). The
kernels are built first, as ``chip_smoke.py``'s build phase does, so that no
phase's first call waits on ``nvcc``. The phases run in this process, after the flags
``chip_smoke.py`` sets (no TF32); each prints its JSON line, and the card's
name and power limit come first. Run one checkout per process: both trees
name their package ``ray_tpu_torch``. For an A/B, alternate them:
parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = {"resnet50": "phase_resnet50", "rl_learner_check": "phase_rl_learner_check",
          "rl": "run_rl_phases", "mesh": "run_mesh_phases", "pipe_ctx": "run_pipe_ctx_phases",
          "mesh_rest": "run_mesh_rest_phases", "predictor": "phase_predictor",
          "rl_multi_agent": "run_rl_multi_agent", "data": "run_data_phases",
          "serve": "run_serve_phase", "tune": "run_tune_phase", "cli_job": "phase_cli_job"}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkout", default=ROOT, help="root of the tree to run")
    parser.add_argument("phases", nargs="+", choices=sorted(PHASES))
    args = parser.parse_args(argv)
    checkout = os.path.abspath(args.checkout)
    sys.path.insert(0, checkout)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_chip_phases: no CUDA device")
    import chip_smoke
    from ray_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    print(json.dumps({"checkout": checkout, "card": smi, "phases": args.phases,
                      "build_s": _build.build()}), flush=True)
    for phase in args.phases:
        getattr(chip_smoke, PHASES[phase])(smi)


if __name__ == "__main__":
    main()
