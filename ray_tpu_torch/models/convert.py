"""Carry a parameter tree across between numpy and the port's tensors.

The JAX package's params are nested dicts of arrays (``ray_tpu/models/gpt.py``:
per-layer leaves stacked on a leading ``(L, ...)`` dim under ``"blocks"``), with
lists of block dicts in ResNet's (``params["stage0"]``). The port keeps the
same leaf names and shapes, so a tree converts leaf by leaf: a JAX tree goes
through ``numpy.asarray`` on each leaf and then ``params_from_numpy``, and
both sides compute the same thing.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._private.accelerators.gpu import resolve_device
from ray_tpu_torch.models.training import tree_map


def params_from_numpy(tree: Dict[str, Any], device=None, requires_grad: bool = False):
    """Nested dicts and lists of arrays -> the same nesting of tensors on
    ``device`` (``None``: the GPU; raises when there is none), dtypes kept."""
    device = resolve_device(device)

    def conv(x):
        t = torch.from_numpy(np.array(x, copy=True)).to(device)
        return t.requires_grad_(requires_grad) if t.is_floating_point() else t

    return tree_map(conv, tree)


def params_to_numpy(params: Dict[str, Any]):
    """Nested dicts and lists of tensors -> the same nesting of numpy arrays on
    the host, copied (a CPU tensor's array would share its memory and follow
    later in-place updates). bf16 leaves, which numpy lacks, come back as
    float32."""

    def conv(x):
        t = x.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(conv, params)
