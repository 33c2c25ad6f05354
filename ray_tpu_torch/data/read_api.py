"""Dataset creation: in-memory sources and file readers.

Reference: `python/ray/data/read_api.py` (`range`, `from_items`,
`read_parquet:523`, `read_csv`, `read_json`, `read_text`). Reads are
task-parallel: the file list (or index range) is partitioned into
`parallelism` read tasks, each producing one block.
"""

from __future__ import annotations

import builtins
import glob as glob_mod
import os
from typing import Any, Dict, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data._internal.streaming_executor import BlockMeta, ReadSource, RefBundle
from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data.dataset import Dataset


# ------------------------------------------------------------------ helpers
def _split_even(n: int, k: int) -> List[range]:
    per, rem = divmod(n, k)
    out, start = [], 0
    for i in builtins.range(k):
        size = per + (1 if i < rem else 0)
        out.append(builtins.range(start, start + size))
        start += size
    return [r for r in out if len(r)]


def _expand_paths(paths: Union[str, List[str]], suffix: Optional[str] = None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, names in os.walk(p):
                files.extend(os.path.join(root, x) for x in sorted(names))
        elif any(c in p for c in "*?["):
            files.extend(sorted(glob_mod.glob(p)))
        else:
            files.append(p)
    if suffix:
        files = [f for f in files if f.endswith(suffix)] or files
    if not files:
        raise FileNotFoundError(f"no files matched {paths}")
    return files


# ------------------------------------------------------------- block producers
def _make_range_block(start: int, stop: int) -> Dict[str, np.ndarray]:
    return {"id": np.arange(start, stop, dtype=np.int64)}


def _make_tensor_block(start: int, stop: int, shape: tuple) -> Dict[str, np.ndarray]:
    n = stop - start
    base = np.arange(start, stop, dtype=np.float64).reshape((n,) + (1,) * len(shape))
    return {"data": np.broadcast_to(base, (n,) + shape).copy()}


def _read_csv_files(files: List[str], kwargs: dict) -> Dict[str, np.ndarray]:
    import pandas as pd

    dfs = [pd.read_csv(f, **kwargs) for f in files]
    return BlockAccessor.from_pandas(pd.concat(dfs, ignore_index=True))


def _read_json_files(files: List[str], kwargs: dict) -> Dict[str, np.ndarray]:
    import pandas as pd

    dfs = [pd.read_json(f, lines=kwargs.pop("lines", True), **kwargs) for f in files]
    return BlockAccessor.from_pandas(pd.concat(dfs, ignore_index=True))


def _read_parquet_files(files: List[str], kwargs: dict) -> Dict[str, np.ndarray]:
    import pyarrow.parquet as pq

    import pyarrow as pa

    tables = [pq.read_table(f, **kwargs) for f in files]
    return BlockAccessor.from_arrow(pa.concat_tables(tables))


def _read_text_files(files: List[str], encoding: str) -> Dict[str, np.ndarray]:
    lines: List[str] = []
    for f in files:
        with open(f, "r", encoding=encoding) as fh:
            lines.extend(line.rstrip("\n") for line in fh)
    return BlockAccessor.from_rows([{"text": ln} for ln in lines])


# ----------------------------------------------------------------- public API
def _put_block(block) -> RefBundle:
    acc = BlockAccessor(block)
    return RefBundle(
        ray_tpu_torch.put(block), BlockMeta(acc.num_rows(), acc.size_bytes())
    )


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    parallelism = _auto_parallelism(parallelism, n)
    return Dataset(ReadSource(
        [(_make_range_block, (r.start, r.stop)) for r in _split_even(n, parallelism)],
        name="ReadRange",
    ))


def range_tensor(n: int, *, shape: tuple = (1,), parallelism: int = -1) -> Dataset:
    parallelism = _auto_parallelism(parallelism, n)
    return Dataset(ReadSource(
        [
            (_make_tensor_block, (r.start, r.stop, tuple(shape)))
            for r in _split_even(n, parallelism)
        ],
        name="ReadRangeTensor",
    ))


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    from ray_tpu_torch._private import usage

    usage.record_library_usage("data")
    parallelism = _auto_parallelism(parallelism, len(items))
    return Dataset([
        _put_block(BlockAccessor.from_rows([items[i] for i in rng]))
        for rng in _split_even(len(items), parallelism)
    ])


def from_numpy(arrays: Union[np.ndarray, Dict[str, np.ndarray]]) -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = {"data": arrays}
    return Dataset([_put_block({k: np.asarray(v) for k, v in arrays.items()})])


def from_pandas(dfs: Union[Any, List[Any]]) -> Dataset:
    if not isinstance(dfs, list):
        dfs = [dfs]
    return Dataset([_put_block(BlockAccessor.from_pandas(df)) for df in dfs])


def from_arrow(tables: Union[Any, List[Any]]) -> Dataset:
    """One block per pyarrow Table (reference: `read_api.py from_arrow`)."""
    if not isinstance(tables, list):
        tables = [tables]
    return Dataset([_put_block(BlockAccessor.from_arrow(t)) for t in tables])


def _file_reader(files, parallelism, task_fn, payload) -> Dataset:
    parallelism = min(_auto_parallelism(parallelism, len(files)), len(files))
    return Dataset(ReadSource(
        [
            (task_fn, ([files[i] for i in rng], payload))
            for rng in _split_even(len(files), parallelism)
        ],
        name=f"Read[{task_fn.__name__.strip('_')}]",
    ))


def read_csv(paths: Union[str, List[str]], *, parallelism: int = -1, **kwargs) -> Dataset:
    return _file_reader(_expand_paths(paths, ".csv"), parallelism, _read_csv_files, kwargs)


def read_json(paths: Union[str, List[str]], *, parallelism: int = -1, **kwargs) -> Dataset:
    return _file_reader(_expand_paths(paths, ".json"), parallelism, _read_json_files, kwargs)


def read_parquet(paths: Union[str, List[str]], *, parallelism: int = -1, **kwargs) -> Dataset:
    return _file_reader(
        _expand_paths(paths, ".parquet"), parallelism, _read_parquet_files, kwargs
    )


def read_text(paths: Union[str, List[str]], *, parallelism: int = -1,
              encoding: str = "utf-8") -> Dataset:
    return _file_reader(_expand_paths(paths), parallelism, _read_text_files, encoding)


def read_numpy(paths: Union[str, List[str]], *, parallelism: int = -1) -> Dataset:
    """.npy files -> blocks with a "data" column (reference:
    `data/datasource/numpy_datasource.py`)."""
    from ray_tpu_torch.data.datasource import _read_npy_files

    return _file_reader(_expand_paths(paths, ".npy"), parallelism, _read_npy_files, None)


def read_tfrecords(paths: Union[str, List[str]], *, parallelism: int = -1) -> Dataset:
    """TFRecord files of tf.train.Example protos, parsed without tensorflow
    (reference: `data/datasource/tfrecords_datasource.py`)."""
    from ray_tpu_torch.data.datasource import _read_tfrecord_files

    return _file_reader(
        _expand_paths(paths), parallelism, _read_tfrecord_files, None
    )


def read_binary_files(paths: Union[str, List[str]], *, parallelism: int = -1,
                      include_paths: bool = False) -> Dataset:
    """Whole files as a "bytes" column (+"path"), reference:
    `data/datasource/binary_datasource.py`."""
    from ray_tpu_torch.data.datasource import _read_binary_files

    return _file_reader(
        _expand_paths(paths), parallelism, _read_binary_files, include_paths
    )


def read_datasource(datasource, *, parallelism: int = -1) -> Dataset:
    """Run a custom `Datasource` plugin through the streaming read path
    (reference: `read_api.py read_datasource`): its ReadTasks become
    generator read entries, inheriting backpressure + read->map fusion."""
    from ray_tpu_torch.data.datasource import _run_read_task

    tasks = datasource.get_read_tasks(_auto_parallelism(parallelism, 1 << 30))
    if not tasks:
        return Dataset([])
    return Dataset(ReadSource(
        [(_run_read_task, (t,)) for t in tasks],
        name=f"Read[{datasource.name}]",
    ))


def _auto_parallelism(parallelism: int, n: int) -> int:
    if parallelism and parallelism > 0:
        return max(1, min(parallelism, max(n, 1)))
    try:
        cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 4))
    except Exception:
        cpus = 4
    return max(1, min(cpus * 2, max(n, 1), 64))
