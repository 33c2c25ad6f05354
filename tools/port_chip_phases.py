#!/usr/bin/env python3
"""Run chosen phases of ``chip_smoke.py`` on one NVIDIA GPU, from this
checkout or from another one (e.g. a parent commit unpacked with
``git archive``), to compare two trees on one card.

    python3 tools/port_chip_phases.py [--checkout DIR] PHASE [PHASE ...]

PHASE is ``resnet50`` (ResNet-50 at B 128), ``rl_learner_check``, ``rl``
(every RLlib phase on one runtime), ``mesh`` (``collective_nccl``, then
``mesh_gang`` against the main path's first step, taken here) or
``pipe_ctx`` (``ring_check``, then ``pipe_ctx_gang`` against the same) or
``mesh_rest`` (``moe``, then ``expert_tp_gang`` against it,
``elastic_reshard`` and ``rl_mesh_learner``). The phases run in this process, after the
flags ``chip_smoke.py`` sets (no TF32); each prints its JSON line, and the
card's name and power limit come first. Run one checkout per process: both
trees name their package ``ray_tpu_torch``. For an A/B, alternate them:
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
          "mesh_rest": "run_mesh_rest_phases"}


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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    print(json.dumps({"checkout": checkout, "card": smi, "phases": args.phases}), flush=True)
    for phase in args.phases:
        getattr(chip_smoke, PHASES[phase])(smi)


if __name__ == "__main__":
    main()
