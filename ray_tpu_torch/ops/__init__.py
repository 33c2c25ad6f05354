from ray_tpu_torch.ops.flash_attention import (
    blockwise_attention,
    flash_attention,
    launch_counts,
    reset_launch_counts,
    xla_attention,
)

__all__ = [
    "blockwise_attention",
    "flash_attention",
    "launch_counts",
    "reset_launch_counts",
    "xla_attention",
]
