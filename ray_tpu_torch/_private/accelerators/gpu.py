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
import socket
from typing import Dict, List

# The environment key that names a node's NVLink domain, where the host's
# name does not (an NVL rack whose hosts share NVLink switches).
NVLINK_DOMAIN_ENV = "RAY_TPU_TORCH_GPU_NVLINK_DOMAIN"


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


def node_topology_labels(num_gpus: float) -> Dict[str, str]:
    """Labels of this host's place in the GPU interconnect, attached to the
    node at registration so that the GPU_SLICE placement policy
    (``util/gpu_topology_policy.py``) takes a gang from one NVLink domain:
    the counterpart of ``ray_tpu/_private/accelerators/tpu.py``'s labels of a
    host's place in its TPU slice.

    A node that holds GPUs gets ``gpu_nvlink_domain``: the value of
    ``RAY_TPU_TORCH_GPU_NVLINK_DOMAIN`` when it is set (as the TPU labels come
    from the TPU VM's ``TPU_*`` keys), else the host's name, since an HGX
    host's GPUs share one NVSwitch. Empty for a node without GPUs. Reads
    nothing from the driver or NVML."""
    if not num_gpus or num_gpus <= 0:
        return {}
    return {"gpu_nvlink_domain": os.environ.get(NVLINK_DOMAIN_ENV) or socket.gethostname()}


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
