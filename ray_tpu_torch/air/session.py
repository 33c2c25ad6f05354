"""The unified Train/Tune session: what user training code calls.

Reference: `python/ray/air/session.py` — `report:43`, `get_checkpoint:97`,
`get_world_rank` etc. One module-level accessor, bound to whichever session
implementation is active in this process/thread (a Train worker session or a
Tune function-trainable session). `session.report(metrics, checkpoint=...)`
streams metrics (and optionally a checkpoint) back to the driver.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint

_local = threading.local()


def _get_session():
    return getattr(_local, "session", None)


def _set_session(sess) -> None:
    _local.session = sess


def _require_session():
    sess = _get_session()
    if sess is None:
        raise RuntimeError(
            "ray_tpu_torch.air.session.* can only be called inside a training or "
            "tuning function launched by a Trainer/Tuner."
        )
    return sess


def report(metrics: Dict[str, Any], *, checkpoint: Optional[Checkpoint] = None) -> None:
    """Stream an intermediate result (and optional checkpoint) to the driver."""
    _require_session().report(metrics, checkpoint=checkpoint)


def mark_phase(phase: str) -> None:
    """Mark the step clock's phase seam from the training loop: one of
    data_wait | compile | step_exec | collective | report | checkpoint.
    Wall time accrues into the *current* phase until the next mark (steps are
    closed by `report`). No-op outside a Train worker session or with
    observability off, so loops can mark unconditionally."""
    sess = _require_session()
    marker = getattr(sess, "mark_phase", None)
    if marker is not None:
        marker(phase)


def stash_checkpoint(state: Any, *, rules=None, step: Optional[int] = None) -> None:
    """In-memory checkpoint for elastic recovery: snapshot this rank's state
    (torch tensors lowered to CPU tensors) into the worker's stash and mirror
    it to a peer worker, so a node loss never loses the newest step. Without
    `rules`, `state` is replicated across the gang; with them (``[(regex,
    spec)]``, `train/torch/resharding.py`), it is this rank's
    `shard_for_rank` cut, and a resize gathers the ranks' shards whole for
    `resharding.resume_state`. `step` defaults to the number of `report` calls completed so far. No-op
    outside a Train worker session, so loops can stash unconditionally."""
    sess = _require_session()
    stasher = getattr(sess, "stash_checkpoint", None)
    if stasher is not None:
        stasher(state, rules=rules, step=step)


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint to resume from (set on restart after failure), else None."""
    return _require_session().loaded_checkpoint


def get_world_size() -> int:
    return _require_session().world_size


def get_world_rank() -> int:
    return _require_session().world_rank


def get_local_rank() -> int:
    return _require_session().local_rank


def get_local_world_size() -> int:
    return _require_session().local_world_size


def get_node_rank() -> int:
    return _require_session().node_rank


def get_trial_name() -> str:
    return getattr(_require_session(), "trial_name", "")


def get_trial_id() -> str:
    return getattr(_require_session(), "trial_id", "")


def get_trial_dir() -> str:
    return getattr(_require_session(), "trial_dir", "")


def get_experiment_name() -> str:
    return getattr(_require_session(), "experiment_name", "")


def get_dataset_shard(dataset_name: str = "train"):
    """This worker's split of the Datasets passed to the Trainer (P18 ingest)."""
    sess = _require_session()
    shard = (getattr(sess, "dataset_shards", None) or {}).get(dataset_name)
    if shard is None:
        raise KeyError(f"no dataset shard named '{dataset_name}' for this worker")
    return shard


def get_mesh():
    """The ``DeviceMesh`` of this training run (``TorchTrainer``), built from
    ``ScalingConfig.mesh`` over the gang's process group the first time it is
    asked for. None inside a trainer or tuner that builds no mesh."""
    return getattr(_require_session(), "mesh", None)
