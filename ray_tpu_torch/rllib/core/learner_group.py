"""LearnerGroup: a local learner or a gang of remote learner actors.

The counterpart of ``ray_tpu/rllib/core/learner_group.py``. Remote mode
shards each update batch across learner actors; sync is weight averaging
after each round (equivalent to gradient averaging for equal shard sizes
under the same optimizer state trajectory: each learner applies the SAME
averaged update because weights are re-broadcast every round). Each learner
holds ``num_gpus_per_learner`` of the node's ``GPU`` resource, so the runtime
gives it a visible device id and its params go to that GPU; with 0 it sees
no GPU and runs on the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ray_tpu_torch.models.training import tree_map
from ray_tpu_torch.rllib.core.learner import TorchLearner
from ray_tpu_torch.rllib.core.rl_module import RLModule


def learner_device(num_gpus: float):
    """Where a learner that holds ``num_gpus`` GPUs puts its params: the GPU
    (raising when there is none) when it holds any, else the CPU."""
    return None if num_gpus > 0 else "cpu"


# What each remote learner actor holds of the CPU, and the threads it runs.
LEARNER_CPUS = 1


class _RemoteLearner:
    """Actor wrapping one TorchLearner."""

    def __init__(self, module, loss_fn, learning_rate: float, seed: int,
                 optimizer=None, extra_update_fn=None, num_gpus: float = 0.0):
        # As many threads as CPUs held: learners and runners on one host
        # would otherwise each start a thread per core and fight over them.
        torch.set_num_threads(LEARNER_CPUS)
        self.learner = TorchLearner(
            module, loss_fn, learning_rate=learning_rate, seed=seed,
            optimizer=optimizer, extra_update_fn=extra_update_fn,
            device=learner_device(num_gpus),
        )

    def placement(self) -> Dict[str, Any]:
        return self.learner.placement()

    def get_extra(self):
        return self.learner.get_extra()

    def update(self, batch):
        return self.learner.update(batch)

    def set_extra(self, extra):
        self.learner.set_extra(extra)

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, w):
        self.learner.set_weights(w)

    def state(self):
        return self.learner.state()

    def load_state(self, s):
        self.learner.load_state(s)


def _mean(*xs):
    return np.mean(np.stack([np.asarray(x) for x in xs]), axis=0)


class LearnerGroup:
    def __init__(
        self,
        module: RLModule,
        loss_fn: Callable,
        *,
        num_learners: int = 0,
        learning_rate: float = 3e-4,
        mesh=None,
        optimizer=None,
        seed: int = 0,
        extra_update_fn=None,
        num_gpus_per_learner: float = 1.0,
    ):
        self._num = num_learners
        self._has_extra_update = extra_update_fn is not None
        if num_learners == 0:
            self._local = TorchLearner(
                module,
                loss_fn,
                learning_rate=learning_rate,
                mesh=mesh,
                optimizer=optimizer,
                seed=seed,
                extra_update_fn=extra_update_fn,
                device=learner_device(num_gpus_per_learner),
            )
            self._remote: List = []
        else:
            import ray_tpu_torch

            self._local = None
            cls = ray_tpu_torch.remote(_RemoteLearner)
            self._remote = [
                cls.options(num_cpus=LEARNER_CPUS, num_gpus=num_gpus_per_learner).remote(
                    module, loss_fn, learning_rate, seed, optimizer, extra_update_fn,
                    num_gpus_per_learner,
                )
                for _ in range(num_learners)
            ]

    @property
    def is_local(self) -> bool:
        return self._local is not None

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        if self._local is not None:
            return self._local.update(batch)
        import ray_tpu_torch

        n = len(self._remote)
        size = len(next(iter(batch.values())))
        per = size // n
        shards = [
            {k: v[i * per:(i + 1) * per] for k, v in batch.items()} for i in range(n)
        ]
        metrics = ray_tpu_torch.get(
            [lr.update.remote(s) for lr, s in zip(self._remote, shards)]
        )
        # Weight-average sync: every learner ends the round with identical
        # weights (the DDP-equivalence described in the module docstring).
        weights = ray_tpu_torch.get([lr.get_weights.remote() for lr in self._remote])
        avg = tree_map(_mean, *weights)
        ray_tpu_torch.get([lr.set_weights.remote(avg) for lr in self._remote])
        if self._has_extra_update:
            # extra evolves inside each learner's step (e.g. SAC's polyak
            # targets blending toward that learner's pre-average shard
            # weights): resync it the same way as the weights, or the
            # per-learner copies drift apart round over round.
            extras = ray_tpu_torch.get([lr.get_extra.remote() for lr in self._remote])
            if extras[0] is not None:
                avg_extra = tree_map(_mean, *extras)
                ray_tpu_torch.get([lr.set_extra.remote(avg_extra) for lr in self._remote])
        out: Dict[str, Any] = {}
        for k in metrics[0]:
            if np.ndim(metrics[0][k]):
                # Vector aux (per-sample TD errors): shards sliced the batch
                # in order, so concatenation restores per-sample order
                # (covering the first n*per rows; the remainder was never
                # trained this round).
                out[k] = np.concatenate([np.asarray(m[k]) for m in metrics])
            else:
                out[k] = float(np.mean([m[k] for m in metrics]))
        return out

    def placement(self) -> List[Dict[str, Any]]:
        """Each learner's process, visible GPU ids and params' device."""
        if self._local is not None:
            return [self._local.placement()]
        import ray_tpu_torch

        return ray_tpu_torch.get([lr.placement.remote() for lr in self._remote])

    def set_extra(self, extra) -> None:
        """Push auxiliary loss state (e.g. DQN target params) to every
        learner; it never rides the (sliced) batch."""
        if self._local is not None:
            self._local.set_extra(extra)
        else:
            import ray_tpu_torch

            ray_tpu_torch.get([lr.set_extra.remote(extra) for lr in self._remote])

    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        import ray_tpu_torch

        return ray_tpu_torch.get(self._remote[0].get_weights.remote())

    def get_extra(self):
        """Current auxiliary state (after extra_update_fn blends), as numpy."""
        if self._local is not None:
            return self._local.get_extra()
        import ray_tpu_torch

        return ray_tpu_torch.get(self._remote[0].get_extra.remote())

    def set_weights(self, w) -> None:
        if self._local is not None:
            self._local.set_weights(w)
        else:
            import ray_tpu_torch

            ray_tpu_torch.get([lr.set_weights.remote(w) for lr in self._remote])

    def state(self):
        if self._local is not None:
            return self._local.state()
        import ray_tpu_torch

        return ray_tpu_torch.get(self._remote[0].state.remote())

    def load_state(self, s) -> None:
        if self._local is not None:
            self._local.load_state(s)
        else:
            import ray_tpu_torch

            ray_tpu_torch.get([lr.load_state.remote(s) for lr in self._remote])

    def stop(self) -> None:
        """Kill the remote learners."""
        import ray_tpu_torch

        for lr in self._remote:
            ray_tpu_torch.kill(lr)
        self._remote = []
