"""Block: the unit of distributed data — dict-of-numpy OR a pyarrow Table.

Reference: `python/ray/data/block.py` (`BlockAccessor`) +
`_internal/arrow_block.py:138` (`ArrowBlockAccessor`). Two first-class block
layouts, dispatched by `BlockAccessor`:

- dict of numpy arrays — the native layout: batches are contiguous host
  arrays that `torch.as_tensor` wraps and `iter_torch_batches` moves to the GPU.
- `pyarrow.Table` — the columnar layout for string/ragged data: slices and
  takes stay zero-copy Arrow end to end (parquet reads, `from_arrow`, and
  any `map_batches(batch_format="pyarrow")` stage), so string-heavy
  pipelines never pay numpy object-dtype boxing.

Pandas / row dicts convert at the boundary.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

Block = Union[Dict[str, np.ndarray], "pyarrow.Table"]  # noqa: F821


def _to_numpy_column(values: Sequence[Any]) -> np.ndarray:
    arr = np.asarray(values)
    if arr.dtype.kind == "U":
        arr = np.asarray(values, dtype=object)
    return arr


def _loaded(name: str):
    """The module ``name`` if this process has imported it, else None: an
    object of its types can exist only then, so type checks import nothing
    (the GPU machines have neither pyarrow nor pandas)."""
    return sys.modules.get(name)


def _is_arrow(block: Any) -> bool:
    if block is None or isinstance(block, dict):
        return False
    pa = _loaded("pyarrow")
    return pa is not None and isinstance(block, pa.Table)


def _arrow_col_to_numpy(col) -> np.ndarray:
    """One Arrow column -> numpy; strings/nested fall back to object."""
    try:
        return col.to_numpy(zero_copy_only=False)
    except Exception:
        return _to_numpy_column(col.to_pylist())


class BlockAccessor:
    """Polymorphic accessor over both block layouts (reference:
    `BlockAccessor.for_block` choosing Arrow/pandas/simple accessors)."""

    def __init__(self, block: Block):
        self._b = block
        self._arrow = _is_arrow(block)

    @property
    def is_arrow(self) -> bool:
        return self._arrow

    # ---------------------------------------------------------- constructors
    @staticmethod
    def from_rows(rows: List[Any]) -> Block:
        """Rows: dicts (columnar-ized) or scalars (an 'item' column)."""
        if not rows:
            return {}
        if isinstance(rows[0], dict):
            cols = {k: [] for k in rows[0]}
            for r in rows:
                if set(r.keys()) != set(cols.keys()):
                    raise ValueError(f"inconsistent row schema: {set(r)} vs {set(cols)}")
                for k, v in r.items():
                    cols[k].append(v)
            return {k: _to_numpy_column(v) for k, v in cols.items()}
        return {"item": _to_numpy_column(rows)}

    @staticmethod
    def from_pandas(df) -> Block:
        return {str(c): _to_numpy_column(df[c].to_list()) for c in df.columns}

    @staticmethod
    def from_arrow(table) -> Block:
        """Arrow tables ARE blocks: no conversion, columns stay columnar."""
        return table

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        blocks = [b for b in blocks if b is not None and BlockAccessor(b).num_rows()]
        if not blocks:
            return {}
        if all(_is_arrow(b) for b in blocks):
            import pyarrow as pa

            if len(blocks) == 1:
                return blocks[0]
            return pa.concat_tables(blocks, promote_options="default")
        if any(_is_arrow(b) for b in blocks):
            # Mixed layouts (e.g. an Arrow read unioned with numpy blocks):
            # settle on numpy.
            blocks = [BlockAccessor(b).to_numpy() for b in blocks]
        if len(blocks) == 1:
            # Single block: no copy — iter_batches hits this on every block
            # when batch_size=None, and np.concatenate copied each block once
            # for nothing (~40% of consumer-side ingest time). The views are
            # marked READ-ONLY: they may alias shared-memory store segments,
            # and an in-place consumer mutation would corrupt the sealed
            # object for every other reader (the reference's ray.get returns
            # read-only arrays for exactly this reason).
            out = {}
            for k, v in blocks[0].items():
                if isinstance(v, np.ndarray) and v.flags.writeable:
                    v = v.view()
                    v.flags.writeable = False
                out[k] = v
            return out
        keys = blocks[0].keys()
        out = {}
        for k in keys:
            arr = np.concatenate([b[k] for b in blocks])
            # Same contract as the single-block path: batches are read-only
            # regardless of block layout, so consumer mutation fails
            # deterministically instead of only when a batch spans blocks.
            arr.flags.writeable = False
            out[k] = arr
        return out

    # ----------------------------------------------------------------- queries
    def num_rows(self) -> int:
        if self._arrow:
            return self._b.num_rows
        if not self._b:
            return 0
        return len(next(iter(self._b.values())))

    def size_bytes(self) -> int:
        if self._arrow:
            return self._b.nbytes
        return sum(a.nbytes for a in self._b.values())

    def schema(self) -> Dict[str, Any]:
        if self._arrow:
            return {f.name: f.type for f in self._b.schema}
        return {k: v.dtype for k, v in self._b.items()}

    def column_names(self) -> List[str]:
        if self._arrow:
            return list(self._b.column_names)
        return list(self._b.keys())

    def column(self, name: str) -> np.ndarray:
        """One column as numpy (key columns for sort/groupby/zip math).
        Arrow string keys surface as object arrays HERE ONLY — the block's
        payload columns never convert."""
        if self._arrow:
            return _arrow_col_to_numpy(self._b[name])
        return self._b[name]

    def slice(self, start: int, end: int) -> Block:
        if self._arrow:
            # Zero-copy view over the parent table's buffers.
            return self._b.slice(start, end - start)
        return {k: v[start:end] for k, v in self._b.items()}

    def take_indices(self, idx: np.ndarray) -> Block:
        if self._arrow:
            import pyarrow as pa

            return self._b.take(pa.array(np.asarray(idx, np.int64)))
        return {k: v[idx] for k, v in self._b.items()}

    # ------------------------------------------------------------- conversions
    def to_numpy(self) -> Dict[str, np.ndarray]:
        if self._arrow:
            return {
                name: _arrow_col_to_numpy(col)
                for name, col in zip(self._b.column_names, self._b.columns)
            }
        return self._b

    def to_pandas(self):
        if self._arrow:
            return self._b.to_pandas()
        import pandas as pd

        return pd.DataFrame({k: list(v) if v.dtype == object else v
                             for k, v in self._b.items()})

    def to_arrow(self):
        if self._arrow:
            return self._b
        import pyarrow as pa

        return pa.table({k: pa.array(list(v)) for k, v in self._b.items()})

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        if self._arrow:
            for row in self._b.to_pylist():
                yield row
            return
        n = self.num_rows()
        keys = list(self._b.keys())
        for i in range(n):
            yield {k: self._b[k][i] for k in keys}

    def to_batch(self, batch_format: str = "numpy"):
        if batch_format == "numpy":
            return self.to_numpy()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format == "pyarrow":
            return self.to_arrow()
        raise ValueError(f"unknown batch_format {batch_format}")

    @staticmethod
    def from_batch(batch) -> Block:
        if _is_arrow(batch):
            return batch
        if isinstance(batch, dict):
            return {k: np.asarray(v) if not isinstance(v, np.ndarray) else v
                    for k, v in batch.items()}
        pd = _loaded("pandas")
        if pd is not None and isinstance(batch, pd.DataFrame):
            return BlockAccessor.from_pandas(batch)
        if isinstance(batch, list):
            return BlockAccessor.from_rows(batch)
        raise TypeError(f"cannot convert batch of type {type(batch)} to a block")
