"""Dataset: lazy, block-parallel distributed data.

Reference: `python/ray/data/dataset.py:169` (`Datastream`) with the lazy
logical plan + operator fusion of `_internal/logical/` and
`_internal/planner/`: consecutive per-block transforms (map/map_batches/
filter/flat_map) FUSE into one MapOperator stage, actor stages become
ActorPoolMapOperators, and consumption runs the whole plan on the
backpressured streaming executor (`_internal/streaming_executor.py` here;
`_internal/execution/streaming_executor.py:45` in the reference) — reads and
transforms overlap consumption under a global memory budget. Global ops
(repartition/random_shuffle/sort/zip/groupby) are barriers built from
scatter/gather tasks — `random_shuffle` is the 2-stage push-based pattern of
`push_based_shuffle.py`.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor

# --------------------------------------------------------------------- remote ops
PerBlockOp = Tuple[str, Any]  # ("map_batches", (fn, batch_size, fmt)), ...


def _apply_chain(block: Block, chain: List[PerBlockOp]) -> Block:
    """Run a fused chain of per-block ops over one block (one task)."""
    acc = BlockAccessor(block)
    for kind, payload in chain:
        if kind == "map_batches":
            fn, batch_size, fmt = payload
            n = acc.num_rows()
            outs = []
            step = batch_size or max(n, 1)
            for s in range(0, max(n, 1), step):
                if n == 0:
                    break
                batch = BlockAccessor(acc.slice(s, min(s + step, n))).to_batch(fmt)
                outs.append(BlockAccessor.from_batch(fn(batch)))
            acc = BlockAccessor(BlockAccessor.concat(outs))
        elif kind == "map":
            fn = payload
            acc = BlockAccessor(
                BlockAccessor.from_rows([fn(r) for r in acc.iter_rows()])
            )
        elif kind == "flat_map":
            fn = payload
            rows: List[Any] = []
            for r in acc.iter_rows():
                rows.extend(fn(r))
            acc = BlockAccessor(BlockAccessor.from_rows(rows))
        elif kind == "filter":
            fn = payload
            keep = np.array([bool(fn(r)) for r in acc.iter_rows()], dtype=bool)
            acc = BlockAccessor(acc.take_indices(np.nonzero(keep)[0]))
        elif kind == "add_column":
            name, fn = payload
            col = np.asarray(fn(acc.to_batch("numpy")))
            if acc.is_arrow and col.ndim == 1:
                import pyarrow as pa

                table = acc.to_arrow()
                if name in table.column_names:
                    table = table.set_column(
                        table.column_names.index(name), name, pa.array(col)
                    )
                else:
                    table = table.append_column(name, pa.array(col))
                acc = BlockAccessor(table)
            else:
                # Multi-dimensional columns (embeddings) don't fit a 1-D
                # Arrow array: settle the block on the numpy layout, which
                # stores them natively.
                b = dict(acc.to_numpy())
                b[name] = col
                acc = BlockAccessor(b)
        elif kind == "drop_columns":
            cols = set(payload)
            if acc.is_arrow:
                table = acc.to_arrow()
                acc = BlockAccessor(
                    table.drop_columns(
                        [c for c in table.column_names if c in cols]
                    )
                )
            else:
                acc = BlockAccessor(
                    {k: v for k, v in acc.to_numpy().items() if k not in cols}
                )
        elif kind == "select_columns":
            cols = list(payload)
            if acc.is_arrow:
                acc = BlockAccessor(acc.to_arrow().select(cols))
            else:
                acc = BlockAccessor({k: acc.to_numpy()[k] for k in cols})
        else:
            raise ValueError(f"unknown per-block op {kind}")
    # Whatever layout the chain ended in IS the output block — an Arrow
    # chain stays Arrow (strings never box into numpy object arrays).
    return acc._b


def _num_rows(block: Block) -> int:
    return BlockAccessor(block).num_rows()


def _slice_block(block: Block, start: int, end: int) -> Block:
    return BlockAccessor(block).slice(start, end)


def _concat_blocks(*blocks: Block) -> Block:
    return BlockAccessor.concat(list(blocks))


def _shuffle_scatter(block: Block, n_out: int, seed: int) -> List[Block]:
    """Stage 1 of push-based shuffle: randomly bucket this block's rows."""
    acc = BlockAccessor(block)
    n = acc.num_rows()
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, n_out, n)
    return [acc.take_indices(np.nonzero(assign == j)[0]) for j in range(n_out)]


def _shuffle_reduce(seed: int, *pieces: Block) -> Block:
    """Stage 2: concat this partition's pieces and shuffle locally."""
    merged = BlockAccessor.concat(list(pieces))
    acc = BlockAccessor(merged)
    n = acc.num_rows()
    rng = np.random.default_rng(seed)
    return acc.take_indices(rng.permutation(n))


def _sort_keys(block: Block, key: str) -> np.ndarray:
    acc = BlockAccessor(block)
    return np.asarray(acc.column(key)) if acc.num_rows() else np.array([])


def _sort_scatter(block: Block, key: str, bounds: np.ndarray, descending: bool) -> List[Block]:
    """Range-partition rows by key against the sampled boundaries."""
    acc = BlockAccessor(block)
    if acc.num_rows() == 0:
        return [acc.slice(0, 0) for _ in range(len(bounds) + 1)]
    keys = np.asarray(acc.column(key))
    part = np.searchsorted(bounds, keys, side="right")
    out = [acc.take_indices(np.nonzero(part == j)[0]) for j in range(len(bounds) + 1)]
    return out[::-1] if descending else out


def _sort_reduce(key: str, descending: bool, *pieces: Block) -> Block:
    merged = BlockAccessor.concat(list(pieces))
    macc = BlockAccessor(merged)
    if not macc.num_rows():
        return merged
    order = np.argsort(macc.column(key), kind="stable")
    if descending:
        order = order[::-1]
    return macc.take_indices(order)


def _stable_hash(v: Any) -> int:
    """Process-independent hash (Python's str hash is per-process salted, and
    scatter tasks for one groupby run in different worker processes)."""
    import hashlib

    return int.from_bytes(
        hashlib.md5(repr(v).encode()).digest()[:8], "little"
    )


def _groupby_scatter(block: Block, key: str, n_out: int) -> List[Block]:
    """Hash-partition by key. Only the KEY column is examined row-wise; the
    payload moves via take_indices, which keeps Arrow blocks Arrow — string
    payload columns never convert to numpy object arrays."""
    acc = BlockAccessor(block)
    if acc.num_rows() == 0:
        return [acc.slice(0, 0) for _ in range(n_out)]
    hashes = np.array([_stable_hash(v) % n_out for v in acc.column(key)])
    return [acc.take_indices(np.nonzero(hashes == j)[0]) for j in range(n_out)]


def _groupby_agg_arrow(table, key: str, aggs: List[Tuple[str, str, str]]):
    """Arrow-native aggregation: pyarrow's hash group_by does the whole
    reduction columnar — string keys stay Arrow strings throughout
    (reference: `_internal/arrow_block.py` ArrowBlockAccessor._aggregate)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    spec = []
    renames = {key: key}
    for op, col, out_name in aggs:
        if op == "count":
            spec.append(([], "count_all", None))
            renames["count_all"] = out_name
        elif op == "std":
            spec.append((col, "stddev", pc.VarianceOptions(ddof=1)))
            renames[f"{col}_stddev"] = out_name
        else:
            if op not in ("sum", "mean", "min", "max"):
                raise ValueError(f"unknown aggregation {op}")
            spec.append((col, op, None))
            renames[f"{col}_{op}"] = out_name
    out = table.group_by(key).aggregate(spec)
    out = out.rename_columns([renames.get(c, c) for c in out.column_names])
    # Deterministic output order (the numpy path sorts unique keys).
    order = pc.sort_indices(out, sort_keys=[(key, "ascending")])
    out = out.take(order)
    # Single-group std of one row is null under ddof=1; the numpy path
    # reports 0.0 — align.
    for op, _col, out_name in aggs:
        if op == "std":
            i = out.column_names.index(out_name)
            out = out.set_column(
                i, out_name, pc.fill_null(out[out_name], 0.0)
            )
    return out


def _groupby_agg(key: str, aggs: List[Tuple[str, str, str]], *pieces: Block) -> Block:
    """aggs: [(op, col, out_name)]; op in count/sum/mean/min/max/std."""
    merged = BlockAccessor.concat(list(pieces))
    macc = BlockAccessor(merged)
    if not macc.num_rows():
        return {}
    if macc.is_arrow:
        return _groupby_agg_arrow(merged, key, aggs)
    keys = merged[key]
    uniq = sorted(set(keys.tolist()))
    out: Dict[str, List[Any]] = {key: []}
    for _, _, out_name in aggs:
        out[out_name] = []
    for u in uniq:
        mask = keys == u
        out[key].append(u)
        for op, col, out_name in aggs:
            vals = merged[col][mask] if col else None
            if op == "count":
                out[out_name].append(int(mask.sum()))
            elif op == "sum":
                out[out_name].append(vals.sum())
            elif op == "mean":
                out[out_name].append(vals.mean())
            elif op == "min":
                out[out_name].append(vals.min())
            elif op == "max":
                out[out_name].append(vals.max())
            elif op == "std":
                out[out_name].append(vals.std(ddof=1) if len(vals) > 1 else 0.0)
            else:
                raise ValueError(f"unknown aggregation {op}")
    return {k: np.asarray(v) for k, v in out.items()}


def _write_block(block: Block, path: str, fmt: str, kwargs: dict) -> Optional[str]:
    acc = BlockAccessor(block)
    if not acc.num_rows():
        return None
    if fmt == "parquet":
        import pyarrow.parquet as pq

        pq.write_table(acc.to_arrow(), path, **kwargs)
    elif fmt == "csv":
        acc.to_pandas().to_csv(path, index=False, **kwargs)
    elif fmt == "json":
        acc.to_pandas().to_json(path, orient="records", lines=True, **kwargs)
    else:
        raise ValueError(f"unknown write format {fmt}")
    return path


def _zip_blocks(a: Block, b: Block) -> Block:
    aa, ab = BlockAccessor(a), BlockAccessor(b)
    if aa.is_arrow and ab.is_arrow:
        out = a
        for name in ab.column_names():
            new = name if name not in out.column_names else f"{name}_1"
            out = out.append_column(new, b[name])
        return out
    da = dict(aa.to_numpy())
    for k, v in ab.to_numpy().items():
        da[k if k not in da else f"{k}_1"] = v
    return da


_remote_cache: Dict[Any, Any] = {}


def _remote(fn, **opts):
    """Memoized `ray_tpu_torch.remote` wrapper: one RemoteFunction (one pickled
    blob / function-table entry) per (fn, options) across the data layer."""
    key = (fn.__name__, tuple(sorted(opts.items())))
    if key not in _remote_cache:
        _remote_cache[key] = ray_tpu_torch.remote(**opts)(fn) if opts else ray_tpu_torch.remote(fn)
    return _remote_cache[key]


# ------------------------------------------------------------------------ Dataset
class Dataset:
    """A lazy logical plan: a source (pre-existing block refs, or streaming
    read tasks) + a chain of per-block ops, compiled to physical operators
    and run by the streaming executor on consumption."""

    def __init__(self, source, ops: Optional[List[PerBlockOp]] = None):
        from ray_tpu_torch.data._internal.streaming_executor import ReadSource, RefBundle

        if isinstance(source, ReadSource):
            self._source = source
        else:
            self._source = [
                b if isinstance(b, RefBundle) else RefBundle(b, None)
                for b in source
            ]
        self._ops = list(ops or [])
        self._materialized: Optional[List[Any]] = (
            None
            if self._ops or isinstance(self._source, ReadSource)
            else [b.block_ref for b in self._source]
        )

    # ------------------------------------------------------------- construction
    def _derive(self, op: PerBlockOp) -> "Dataset":
        return Dataset(self._source, self._ops + [op])

    def _build_pipeline(self):
        """Compile source + logical ops to physical operators."""
        from ray_tpu_torch.data._internal.streaming_executor import (
            InputOperator,
            ReadOperator,
            ReadSource,
            build_pipeline,
        )

        if self._materialized is not None:
            from ray_tpu_torch.data._internal.streaming_executor import RefBundle

            src = InputOperator([RefBundle(r, None) for r in self._materialized])
            return build_pipeline(src, [])
        if isinstance(self._source, ReadSource):
            src = ReadOperator(self._source.entries, name=self._source.name)
        else:
            src = InputOperator(list(self._source))
        return build_pipeline(src, self._ops)

    # ------------------------------------------------------------ transformations
    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        compute: str = "tasks",
        num_actors: int = 2,
        fn_constructor_args: Tuple = (),
        num_gpus: float = 0,
    ) -> "Dataset":
        """Transform batches. With ``compute="actors"`` (required for CLASS
        fns — the reference's ActorPoolStrategy + callable-class pattern),
        blocks run through a pool of ``num_actors`` actors that construct `fn`
        ONCE each: the vehicle for expensive per-worker state like loaded
        model weights (reference: batch inference, `_internal/execution`
        actor pools).

        ``batch_size=None`` (default) feeds the WHOLE block to `fn` in one
        call — the accelerator-right shape (one contiguous batch per block, no
        slice/re-concat copies; sub-batching a 16MB block measured ~9x
        slower through allocator churn + the final concat). The reference
        defaults to 4096-row sub-batches (`dataset.py map_batches`); pass an
        explicit ``batch_size`` to bound UDF peak memory the same way.

        ``num_gpus`` (``compute="actors"`` only; upstream Ray's name for this
        remote argument) is each pool actor's share of ``GPU``: an actor that
        holds none sees no GPU (``CUDA_VISIBLE_DEVICES=""``), and fractional
        shares pack onto one device id. The pool raises ``ValueError`` when
        it starts if ``num_actors * num_gpus`` exceeds the cluster's ``GPU``.
        The default 0 is the reference's pool, which asks for no accelerator."""
        if compute not in ("tasks", "actors"):
            raise ValueError(
                f"compute must be 'tasks' or 'actors', got {compute!r}"
            )
        if isinstance(fn, type):
            if compute == "tasks":
                raise TypeError(
                    "class UDFs run on actor pools (construct-once state); "
                    "pass compute='actors' (or a plain function for tasks)"
                )
            compute = "actors"
        if compute == "actors":
            return self._derive(
                (
                    "map_batches_actors",
                    (fn, fn_constructor_args, batch_size, batch_format, num_actors,
                     num_gpus),
                )
            )
        if num_gpus:
            raise ValueError("num_gpus applies to compute='actors' only")
        return self._derive(("map_batches", (fn, batch_size, batch_format)))

    def map(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]]) -> "Dataset":
        return self._derive(("map", fn))

    def flat_map(self, fn: Callable[[Dict[str, Any]], List[Dict[str, Any]]]) -> "Dataset":
        return self._derive(("flat_map", fn))

    def filter(self, fn: Callable[[Dict[str, Any]], bool]) -> "Dataset":
        return self._derive(("filter", fn))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        return self._derive(("add_column", (name, fn)))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self._derive(("drop_columns", cols))

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self._derive(("select_columns", cols))

    def randomize_block_order(self, *, seed: Optional[int] = None) -> "Dataset":
        """Shuffle BLOCK order without touching rows (reference:
        `Datastream.randomize_block_order` + the ReorderRandomizeBlocks
        optimizer rule): the optimizer lifts this out of the op chain into a
        source permutation so it never splits an otherwise-fusable map
        chain."""
        return self._derive(("randomize_block_order", seed))

    # ------------------------------------------------------------- execution
    def _stream_bundles(self, output_buffer_blocks: int = 2):
        """Run the plan on the streaming executor, yielding RefBundles as
        blocks complete (production overlaps consumption under the
        DataContext budgets). Sets `self._last_executor` for stats."""
        from ray_tpu_torch.data._internal.streaming_executor import StreamingExecutor

        executor = StreamingExecutor(
            self._build_pipeline(), output_buffer_blocks=output_buffer_blocks
        )
        self._last_executor = executor
        return executor.execute()

    def _execute(self) -> List[Any]:
        """Materialize: run the streaming executor to completion."""
        if self._materialized is not None:
            return self._materialized
        self._materialized = [b.block_ref for b in self._stream_bundles(
            output_buffer_blocks=1_000_000  # collecting all: no output pacing
        )]
        return self._materialized

    def materialize(self) -> "Dataset":
        refs = self._execute()
        return Dataset(refs)

    def num_blocks(self) -> int:
        from ray_tpu_torch.data._internal.streaming_executor import ReadSource

        if self._materialized is not None:
            return len(self._materialized)
        if isinstance(self._source, ReadSource):
            return len(self._source.entries)
        return len(self._source)

    # ------------------------------------------------------------- global ops
    def repartition(self, num_blocks: int, *, _sizes: Optional[List[int]] = None) -> "Dataset":
        refs = self._execute()
        sizes = _sizes if _sizes is not None else ray_tpu_torch.get(
            [_remote(_num_rows).remote(r) for r in refs]
        )
        total = sum(sizes)
        target = [total // num_blocks + (1 if i < total % num_blocks else 0)
                  for i in range(num_blocks)]
        # Build slices: walk input blocks, carve off target-sized output blocks.
        out_refs = []
        cur_block, cur_off = 0, 0
        slice_remote, concat_remote = _remote(_slice_block), _remote(_concat_blocks)
        for tgt in target:
            pieces = []
            need = tgt
            while need > 0 and cur_block < len(refs):
                avail = sizes[cur_block] - cur_off
                take = min(avail, need)
                if take > 0:
                    pieces.append(
                        slice_remote.remote(refs[cur_block], cur_off, cur_off + take)
                    )
                cur_off += take
                need -= take
                if cur_off >= sizes[cur_block]:
                    cur_block += 1
                    cur_off = 0
            out_refs.append(
                pieces[0] if len(pieces) == 1 else concat_remote.remote(*pieces)
            )
        return Dataset(out_refs)

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        refs = self._execute()
        n = len(refs)
        if n == 0:
            return Dataset([])
        base = seed if seed is not None else np.random.randint(0, 2**31)
        scatter = _remote(_shuffle_scatter, num_returns=n)
        pieces = []  # pieces[i][j] = piece of input i destined for output j
        for i, r in enumerate(refs):
            got = scatter.options(num_returns=n).remote(r, n, base + i)
            pieces.append(got if isinstance(got, list) else [got])
        reduce_remote = _remote(_shuffle_reduce)
        out = [
            reduce_remote.remote(base + 7919 + j, *[pieces[i][j] for i in range(n)])
            for j in range(n)
        ]
        return Dataset(out)

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        refs = self._execute()
        n = len(refs)
        if n == 0:
            return Dataset([])
        # Sample keys to pick n-1 range boundaries (sample sort).
        keys = ray_tpu_torch.get([_remote(_sort_keys).remote(r, key) for r in refs])
        allk = np.sort(np.concatenate([k for k in keys if len(k)]))
        if len(allk) == 0:
            return Dataset(refs)
        # Clamp to >=0: with fewer rows than blocks the raw index is -1, which
        # would pick the max key as the FIRST boundary (non-monotonic bounds).
        bounds = (
            allk[[max(0, int(len(allk) * (i + 1) / n) - 1) for i in range(n - 1)]]
            if n > 1
            else np.array([])
        )
        scatter = _remote(_sort_scatter, num_returns=n)
        pieces = [
            scatter.options(num_returns=n).remote(r, key, bounds, descending)
            if n > 1 else [r]
            for r in refs
        ]
        if n == 1:
            return Dataset([_remote(_sort_reduce).remote(key, descending, refs[0])])
        reduce_remote = _remote(_sort_reduce)
        out = [
            reduce_remote.remote(key, descending, *[pieces[i][j] for i in range(n)])
            for j in range(n)
        ]
        return Dataset(out)

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def union(self, *others: "Dataset") -> "Dataset":
        refs = self._execute()
        for o in others:
            refs = refs + o._execute()
        return Dataset(refs)

    def zip(self, other: "Dataset") -> "Dataset":
        # One size-fetch round per side: validate totals, then reuse the same
        # sizes for the repartition (avoids re-fetching identical counts).
        sizes_self = ray_tpu_torch.get(
            [_remote(_num_rows).remote(r) for r in self._execute()]
        )
        sizes_other = ray_tpu_torch.get(
            [_remote(_num_rows).remote(r) for r in other._execute()]
        )
        if sum(sizes_self) != sum(sizes_other):
            raise ValueError(
                f"zip requires equal row counts: {sum(sizes_self)} vs "
                f"{sum(sizes_other)}"
            )
        a = self.repartition(self.num_blocks(), _sizes=sizes_self)._execute()
        b = other.repartition(self.num_blocks(), _sizes=sizes_other)._execute()
        z = _remote(_zip_blocks)
        return Dataset([z.remote(x, y) for x, y in zip(a, b)])

    def limit(self, n: int) -> "Dataset":
        refs = self._execute()
        sizes = ray_tpu_torch.get([_remote(_num_rows).remote(r) for r in refs])
        out, got = [], 0
        slice_remote = _remote(_slice_block)
        for r, s in zip(refs, sizes):
            if got >= n:
                break
            take = min(s, n - got)
            out.append(r if take == s else slice_remote.remote(r, 0, take))
            got += take
        return Dataset(out)

    def streaming_split(
        self,
        n: int,
        *,
        equal: bool = False,
        locality_hints: Optional[List[Any]] = None,
    ) -> List["DataIterator"]:
        """n pipelined iterators over ONE executing stream (reference:
        `python/ray/data/dataset.py:1134 streaming_split`): blocks are
        assigned to consumers on demand AS PRODUCED, so training overlaps
        ingest and peak resident blocks stays bounded by the executor's
        backpressure budgets — unlike `split`, nothing materializes up
        front. Each iterator supports one `iter_batches()` pass per epoch;
        epochs re-execute the plan behind an all-consumer barrier."""
        from ray_tpu_torch.data.iterator import make_streaming_split

        return make_streaming_split(
            self, n, equal=equal, locality_hints=locality_hints
        )

    def split(self, n: int, *, equal: bool = False) -> List["Dataset"]:
        if equal:
            total = self.count()
            per = total // n  # equal split truncates the remainder (reference)
            # Repartition to n even blocks, then trim each to exactly `per` rows.
            parts = self.repartition(n)._execute()
            slice_remote = _remote(_slice_block)
            return [
                Dataset([slice_remote.remote(parts[i], 0, per)]) for i in range(n)
            ]
        refs = self._execute()
        out: List[List[Any]] = [[] for _ in range(n)]
        for i, r in enumerate(refs):
            out[i % n].append(r)
        return [Dataset(rs) for rs in out]

    # ------------------------------------------------------------- consumption
    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        prefetch_blocks: int = 2,
        drop_last: bool = False,
    ) -> Iterator[Any]:
        """Streaming iteration through the executor: block production (reads,
        map tasks, actor pools) overlaps consumption under the DataContext
        memory budgets; leftover rows carry across block boundaries."""
        carry: List[Block] = []
        carry_rows = 0
        for bundle in self._stream_bundles(
            output_buffer_blocks=max(prefetch_blocks, 1)
        ):
            block = ray_tpu_torch.get(bundle.block_ref)
            carry.append(block)
            carry_rows += BlockAccessor(block).num_rows()
            step = batch_size or carry_rows
            while step and carry_rows >= step:
                merged = BlockAccessor.concat(carry)
                acc = BlockAccessor(merged)
                yield BlockAccessor(acc.slice(0, step)).to_batch(batch_format)
                rest = acc.slice(step, acc.num_rows())
                carry = [rest]
                carry_rows = BlockAccessor(rest).num_rows()
        if carry_rows and not drop_last:
            merged = BlockAccessor.concat(carry)
            if BlockAccessor(merged).num_rows():
                yield BlockAccessor(merged).to_batch(batch_format)

    def iter_torch_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        dtypes=None,
        device: Optional[str] = None,
        prefetch_blocks: int = 2,
        drop_last: bool = False,
    ) -> Iterator[Dict[str, Any]]:
        """Batches as torch tensors (reference: `iterator.py iter_torch_batches`)
        on ``device``: ``None`` is the GPU (``default_device()``, raising
        without one), where the reference gives CPU tensors; pass
        ``device="cpu"`` for those. Object columns pass through unconverted."""
        from ray_tpu_torch.data.iterator import to_torch_batches

        return to_torch_batches(
            self.iter_batches(
                batch_size=batch_size,
                batch_format="numpy",
                prefetch_blocks=prefetch_blocks,
                drop_last=drop_last,
            ),
            dtypes,
            device,
        )

    def random_split(
        self, fractions: List[float], *, seed: Optional[int] = None
    ) -> List["Dataset"]:
        """Split rows randomly by fractions (reference: `dataset.py
        random_split`). Fractions must sum to <= 1; remainder rows go to the
        last split when they sum to exactly 1."""
        if not fractions or any(f <= 0 for f in fractions):
            raise ValueError("fractions must be positive")
        if sum(fractions) > 1.0 + 1e-9:
            raise ValueError("fractions sum to > 1")
        shuffled = self.random_shuffle(seed=seed)
        refs = shuffled._execute()
        sizes = ray_tpu_torch.get([_remote(_num_rows).remote(r) for r in refs])
        total = sum(sizes)
        counts = [int(total * f) for f in fractions]
        if abs(sum(fractions) - 1.0) < 1e-9:
            counts[-1] = total - sum(counts[:-1])
        slice_remote = _remote(_slice_block)
        splits: List[Dataset] = []
        ref_i, offset = 0, 0
        for want in counts:
            parts: List[Any] = []
            while want > 0 and ref_i < len(refs):
                avail = sizes[ref_i] - offset
                take = min(avail, want)
                if take == sizes[ref_i]:
                    parts.append(refs[ref_i])
                elif take > 0:
                    parts.append(slice_remote.remote(refs[ref_i], offset, offset + take))
                want -= take
                offset += take
                if offset >= sizes[ref_i]:
                    ref_i += 1
                    offset = 0
            splits.append(Dataset(parts))
        return splits

    # ------------------------------------------------------------------ writes
    def _write_files(self, path: str, fmt: str, **kwargs) -> List[str]:
        """One output file per block: path/part-00000.<ext> ... (reference:
        `write_parquet/write_csv/write_json` — task-parallel file writes)."""
        import os

        os.makedirs(path, exist_ok=True)
        refs = self._execute()
        w = _remote(_write_block)
        outs = [
            w.remote(r, os.path.join(path, f"part-{i:05d}.{fmt}"), fmt, kwargs)
            for i, r in enumerate(refs)
        ]
        return [p for p in ray_tpu_torch.get(outs) if p is not None]

    def write_parquet(self, path: str, **kwargs) -> List[str]:
        return self._write_files(path, "parquet", **kwargs)

    def write_csv(self, path: str, **kwargs) -> List[str]:
        return self._write_files(path, "csv", **kwargs)

    def write_json(self, path: str, **kwargs) -> List[str]:
        return self._write_files(path, "json", **kwargs)

    def to_arrow(self) -> List[Any]:
        """One pyarrow Table per block."""
        return [
            BlockAccessor(b).to_arrow()
            for b in ray_tpu_torch.get(self._execute())
            if BlockAccessor(b).num_rows()
        ]

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for batch in self.iter_batches(batch_size=None):
            yield from BlockAccessor(batch).iter_rows()

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        return list(itertools.islice(self.iter_rows(), n))

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def count(self) -> int:
        refs = self._execute()
        return sum(ray_tpu_torch.get([_remote(_num_rows).remote(r) for r in refs]))

    def schema(self) -> Optional[Dict[str, Any]]:
        for r in self._execute():
            b = ray_tpu_torch.get(r)
            if b:
                return BlockAccessor(b).schema()
        return None

    def columns(self) -> Optional[List[str]]:
        s = self.schema()
        return list(s.keys()) if s else None

    def to_pandas(self):
        import pandas as pd

        dfs = [
            BlockAccessor(b).to_pandas()
            for b in ray_tpu_torch.get(self._execute())
            if BlockAccessor(b).num_rows()
        ]
        return pd.concat(dfs, ignore_index=True) if dfs else pd.DataFrame()

    def sum(self, on: str) -> float:
        tot = 0.0
        for batch in self.iter_batches(batch_size=None):
            if on in batch:
                tot += batch[on].sum()
        return tot

    def min(self, on: str):
        return min(b[on].min() for b in self.iter_batches(batch_size=None) if on in b)

    def max(self, on: str):
        return max(b[on].max() for b in self.iter_batches(batch_size=None) if on in b)

    def mean(self, on: str) -> float:
        n = self.count()
        return self.sum(on) / n if n else float("nan")

    def __repr__(self):
        ops = " -> ".join(k for k, _ in self._ops) or "materialized"
        return f"Dataset(blocks={self.num_blocks()}, plan={ops})"


class GroupedData:
    """Hash-partitioned groupby (reference: `data/grouped_data.py`)."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _aggregate(self, aggs: List[Tuple[str, str, str]]) -> Dataset:
        refs = self._ds._execute()
        n = max(len(refs), 1)
        scatter = _remote(_groupby_scatter, num_returns=n)
        pieces = [
            scatter.options(num_returns=n).remote(r, self._key, n) if n > 1 else [r]
            for r in refs
        ]
        agg_remote = _remote(_groupby_agg)
        out = [
            agg_remote.remote(self._key, aggs, *[pieces[i][j] for i in range(len(refs))])
            for j in range(n)
        ]
        return Dataset(out)

    def count(self) -> Dataset:
        return self._aggregate([("count", None, "count()")])

    def sum(self, on: str) -> Dataset:
        return self._aggregate([("sum", on, f"sum({on})")])

    def mean(self, on: str) -> Dataset:
        return self._aggregate([("mean", on, f"mean({on})")])

    def min(self, on: str) -> Dataset:
        return self._aggregate([("min", on, f"min({on})")])

    def max(self, on: str) -> Dataset:
        return self._aggregate([("max", on, f"max({on})")])

    def std(self, on: str) -> Dataset:
        return self._aggregate([("std", on, f"std({on})")])
