"""GPU detection: the counterpart of ``ray_tpu/_private/accelerators/tpu.py``.

Counting reads only the environment and the NVIDIA kernel module's entries
under ``/proc``, so it creates no CUDA context. ``default_device`` is where the
port's entry points put the tensors they create; it raises rather than fall
back to the CPU, which a caller must ask for by name (``device="cpu"``).
``torch`` is imported inside the functions that need it, so the runtime's
processes that never touch a tensor never load it.
"""

from __future__ import annotations

import glob
import os
from typing import List


def detect_num_gpus() -> int:
    """Count the GPUs this process may use, without initializing CUDA.

    Order: ``CUDA_VISIBLE_DEVICES`` -> the NVIDIA kernel module's GPU entries ->
    ``torch.cuda.device_count()``.
    """
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([d for d in visible.split(",") if d.strip()])
    entries = glob.glob("/proc/driver/nvidia/gpus/*")
    if entries:
        return len(entries)
    import torch

    return torch.cuda.device_count()


def visible_gpu_ids(n: int) -> List[str]:
    """The device ids of this process's first ``n`` GPUs, as a worker's
    ``CUDA_VISIBLE_DEVICES`` names them: the entries of this process's own
    ``CUDA_VISIBLE_DEVICES`` when it lists enough, else ``0..n-1``."""
    visible = [d.strip() for d in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")]
    visible = [d for d in visible if d]
    return visible[:n] if len(visible) >= n else [str(i) for i in range(n)]


def default_device():
    """The device the port's entry points create tensors on: the current CUDA
    device, as a ``torch.device``. Raises when there is none."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None):
    """``device`` as a ``torch.device``; ``None`` means ``default_device()``."""
    import torch

    return default_device() if device is None else torch.device(device)


def device_kind() -> str:
    """The first card's name, as ``torch.cuda.get_device_name`` gives it."""
    import torch

    return torch.cuda.get_device_name(0)
