"""The Backend plugin seam: per-framework gang setup/teardown hooks.

Reference: `python/ray/train/backend.py:53` (`Backend`) and `BackendConfig`.
A `BackendConfig` names its `Backend` class; the `BackendExecutor` invokes the
hooks around worker-group lifecycle. The torch.distributed backend lives in
`ray_tpu_torch/train/torch/config.py`.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class BackendConfig:
    @property
    def backend_cls(self):
        return Backend


class Backend:
    """Framework hooks; default implementation is a no-op gang."""

    share_cwd: bool = False

    def on_start(self, worker_group, backend_config: BackendConfig) -> None:
        """After the worker gang is up, before any training starts."""

    def on_training_start(self, worker_group, backend_config: BackendConfig) -> None:
        """Right before the user training function launches."""

    def on_shutdown(self, worker_group, backend_config: BackendConfig) -> None:
        """Before the worker gang is torn down."""
