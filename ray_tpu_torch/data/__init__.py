"""ray_tpu_torch.data: block-based distributed datasets executed as tasks.

Reference: `python/ray/data/` (P18 in SURVEY.md §2) — `Datastream`
(`dataset.py:169`), lazy logical plan (`_internal/logical/`, `planner/`),
block-parallel execution (`_internal/execution/`), shuffle
(`push_based_shuffle.py`), and the read API (`read_api.py`).

The native block format is columnar dict-of-numpy (contiguous host arrays
that `torch.as_tensor` wraps without a copy and `iter_torch_batches` moves to
the GPU), with pandas/pyarrow conversion at the edges; pyarrow and pandas are
imported only where a block or call needs them. `iter_batches` streams
with a sliding prefetch window; `split` feeds per-host Train ingest
(`ray_tpu_torch.air.session.get_dataset_shard`).
"""

from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.datasource import Datasource, ReadTask
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.read_api import (
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,  # noqa: A001 - parity with the reference API
    range_tensor,
    read_binary_files,
    read_csv,
    read_datasource,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
    read_tfrecords,
)

Datastream = Dataset  # the reference's short-lived rename (`dataset.py:169`)

__all__ = [
    "DataContext",
    "DataIterator",
    "Dataset",
    "Datastream",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "read_binary_files",
    "read_csv",
    "read_datasource",
    "read_json",
    "read_numpy",
    "read_parquet",
    "read_text",
    "read_tfrecords",
    "Datasource",
    "ReadTask",
]
