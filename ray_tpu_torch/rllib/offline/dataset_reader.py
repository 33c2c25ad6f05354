"""DatasetReader: serve offline batches from a `ray_tpu_torch.data.Dataset`.

The counterpart of ``ray_tpu/rllib/offline/dataset_reader.py``.

Reference: `rllib/offline/dataset_reader.py` — the Ray-Data-backed input
path (`get_dataset_and_shards` + per-worker iteration). Rows are transitions
with at least `obs` and `actions` columns; iteration cycles the dataset with
a fresh shuffle-free pass per epoch (shuffle upstream via `ds.random_shuffle`
if desired).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from ray_tpu_torch.rllib.offline.input_reader import InputReader


class DatasetReader(InputReader):
    def __init__(self, dataset, batch_size: int = 256):
        self.dataset = dataset
        self.batch_size = batch_size
        self._it: Optional[Iterator] = None

    def _iter(self):
        if self._it is None:
            # drop_last keeps every served batch exactly batch_size rows so
            # the learner update always sees the same shapes, not a short tail.
            self._it = iter(
                self.dataset.iter_batches(
                    batch_size=self.batch_size,
                    batch_format="numpy",
                    drop_last=True,
                )
            )
        return self._it

    def next(self) -> Dict[str, np.ndarray]:
        try:
            batch = next(self._iter())
        except StopIteration:
            self._it = None
            try:
                batch = next(self._iter())
            except StopIteration:
                raise ValueError(
                    f"dataset holds fewer than batch_size={self.batch_size} "
                    "rows; lower the batch size or add data"
                ) from None
        out = {k: np.asarray(v) for k, v in batch.items()}
        # Terminal flags: transitions from a Dataset are treated as i.i.d.
        # rows; a missing `dones` column means no episode structure (BC-style
        # losses don't need one; MARWIL's return computation requires it).
        return out
