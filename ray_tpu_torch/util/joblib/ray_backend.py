"""The joblib backend class: MultiprocessingBackend over ray_tpu_torch's Pool.

Reference: `python/ray/util/joblib/ray_backend.py` (`RayBackend`). joblib
drives the pool exclusively through `apply_async(batch, callback)` where
`batch` is a picklable zero-arg callable (`BatchedCalls`), so the whole
integration is: build our actor Pool instead of a local process pool.
"""

from __future__ import annotations

from joblib._parallel_backends import (
    FallbackToBackend,
    MultiprocessingBackend,
    SequentialBackend,
)

import ray_tpu_torch
from ray_tpu_torch.util.multiprocessing.pool import Pool


class RayBackend(MultiprocessingBackend):
    supports_timeout = True

    def __init__(self, *args, ray_remote_args=None, **kwargs):
        self._ray_remote_args = ray_remote_args
        super().__init__(*args, **kwargs)

    def configure(self, n_jobs=1, parallel=None, prefer=None, require=None,
                  **memmapping_pool_kwargs):
        n_jobs = self.effective_n_jobs(n_jobs)
        if n_jobs == 1:
            raise FallbackToBackend(
                SequentialBackend(nesting_level=self.nesting_level)
            )
        self.parallel = parallel
        self._pool = Pool(processes=n_jobs, ray_remote_args=self._ray_remote_args)
        return n_jobs

    def effective_n_jobs(self, n_jobs):
        """-1 (or None) means "the whole cluster" — CPU total from the
        cluster's resource view, not the local host."""
        if n_jobs is None:
            n_jobs = -1
        if n_jobs < 0:
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            return max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)))
        return n_jobs

    def terminate(self):
        if getattr(self, "_pool", None) is not None:
            self._pool.terminate()
            self._pool = None
