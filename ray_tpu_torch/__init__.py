"""ray_tpu_torch: the PyTorch and CUDA port of ``ray_tpu``, for NVIDIA Hopper.

The port is a package of its own: it imports ``torch``, numpy and the standard
library, never ``jax`` and nothing of ``ray_tpu``. Its first slice is the
per-worker GPT-2 train step (``ray_tpu_torch.models``) with the flash-attention
kernels hand-written in CUDA (``ray_tpu_torch.ops``). Entry points that create
tensors put them on the GPU unless the caller passes ``device="cpu"``.
"""

from ray_tpu_torch._private.accelerators.gpu import (
    default_device,
    detect_num_gpus,
    device_kind,
)

__version__ = "0.1.0"

__all__ = ["__version__", "default_device", "detect_num_gpus", "device_kind"]
