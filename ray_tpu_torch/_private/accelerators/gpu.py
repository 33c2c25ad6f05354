"""GPU detection: the counterpart of ``ray_tpu/_private/accelerators/tpu.py``.

Counting reads only the environment and the NVIDIA kernel module's entries
under ``/proc``, so it creates no CUDA context. ``default_device`` is where the
port's entry points put the tensors they create; it raises rather than fall
back to the CPU, which a caller must ask for by name (``device="cpu"``).
"""

from __future__ import annotations

import glob
import os

import torch


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
    return torch.cuda.device_count()


def default_device() -> torch.device:
    """The device the port's entry points create tensors on: the current CUDA
    device. Raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``default_device()``."""
    return default_device() if device is None else torch.device(device)


def device_kind() -> str:
    """The first card's name, as ``torch.cuda.get_device_name`` gives it."""
    return torch.cuda.get_device_name(0)
