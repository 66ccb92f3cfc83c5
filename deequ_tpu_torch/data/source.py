"""Streamed data sources: out-of-core input for every pass, on the
pyarrow route.

A source answers the part of the `Table` interface the engine reads:
``num_rows``, ``column_names``, ``schema``, ``has_column``,
``column(name)`` (a zero-row column for the preconditions),
``batches(n)`` (the row stream) and ``is_streaming = True``, which turns
the group-by and histogram folds into batch merges. Host memory stays
O(batch + groups), never O(rows).

`ParquetSource` reads row group by row group, with string columns as
Arrow dictionaries (their codes are the analyzers' `dict_encode`), on a
prefetch thread; with `DEEQU_TPU_PIPELINE=0` on the caller's thread,
which gives the same batches.

The JAX counterpart is deequ_tpu/data/source.py.
"""

from __future__ import annotations

import hashlib
import os
import queue
import struct
import threading
from collections import OrderedDict
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deequ_tpu_torch.data.table import NUMPY_BACKING, Column, ColumnType, Table
from deequ_tpu_torch.ops import runtime

_SENTINEL = object()

#: how long `batches()` waits for its decode thread at shutdown (the
#: thread is a daemon; it can only still be alive if one row group's
#: decode takes longer than this)
JOIN_TIMEOUT_S = 10.0


def _arrow_ctype(t) -> ColumnType:
    import pyarrow as pa

    if pa.types.is_dictionary(t):
        t = t.value_type
    if pa.types.is_boolean(t):
        return ColumnType.BOOLEAN
    if pa.types.is_integer(t):
        return ColumnType.LONG
    if pa.types.is_floating(t):
        return ColumnType.DOUBLE
    if pa.types.is_decimal(t):
        return ColumnType.DECIMAL
    if pa.types.is_timestamp(t):
        return ColumnType.TIMESTAMP
    return ColumnType.STRING


def _empty_column(name: str, ctype: ColumnType) -> Column:
    return Column(
        name, ctype, np.empty(0, dtype=NUMPY_BACKING[ctype]), np.empty(0, dtype=np.bool_)
    )


class DataSource:
    """Base for streamed sources. Subclasses implement `_schema()`,
    `num_rows` and `_iter_tables(batch_size)`."""

    is_streaming = True
    batch_rows = 1 << 22

    def _schema(self) -> List[Tuple[str, ColumnType]]:
        raise NotImplementedError

    @property
    def schema(self) -> List[Tuple[str, ColumnType]]:
        return self._schema()

    @property
    def column_names(self) -> List[str]:
        return [name for name, _ in self._schema()]

    def has_column(self, name: str) -> bool:
        return any(n == name for n, _ in self._schema())

    def column(self, name: str) -> Column:
        """A zero-row column of the schema's type: enough for the
        preconditions (has_column, is_numeric, is_string)."""
        for n, ctype in self._schema():
            if n == name:
                return _empty_column(n, ctype)
        from deequ_tpu_torch.core.exceptions import NoSuchColumnException

        raise NoSuchColumnException(f"Input data does not include column {name}!")

    def __getitem__(self, name: str) -> Column:
        return self.column(name)

    @property
    def num_rows(self) -> int:
        raise NotImplementedError

    def __len__(self) -> int:
        return self.num_rows

    def _iter_tables(self, batch_size: int) -> Iterator[Table]:
        raise NotImplementedError

    def _empty_batch(self) -> Table:
        return Table([_empty_column(n, t) for n, t in self._schema()])

    def batches(self, batch_size: int) -> Iterator[Table]:
        """Decoded Tables from a bounded prefetch thread: the next batch's
        decode overlaps the consumer's work.

        If the consumer drops the generator early (an error mid-pass, a
        cancel), the finally block signals the thread, drains the queue
        so its blocked put wakes, and joins it within JOIN_TIMEOUT_S. The
        thread closes its `_iter_tables` iterator on its own thread before
        it exits, so open files close then, not at garbage collection.

        `DEEQU_TPU_PIPELINE=0` decodes on the caller's thread instead
        (`_batches_serial`): the same batches in the same order. A source
        with no rows yields one empty batch, so every analyzer sees the
        schema and gives its empty-state verdict."""
        if not runtime.pipeline_enabled():
            yield from self._batches_serial(batch_size)
            return
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()
        error: List[BaseException] = []

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            it = self._iter_tables(batch_size)
            try:
                for table in it:
                    if stop.is_set() or not _put(table):
                        return
            except BaseException as e:  # noqa: BLE001 - raised again in the consumer
                error.append(e)
            finally:
                try:
                    it.close()
                except BaseException as e:  # noqa: BLE001
                    if not error:
                        error.append(e)
                _put(_SENTINEL)

        thread = threading.Thread(target=producer, daemon=True, name="deequ-decode")
        thread.start()
        produced_any = False
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                produced_any = True
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=JOIN_TIMEOUT_S)
        if error:
            raise error[0]
        if not produced_any:
            yield self._empty_batch()

    def _batches_serial(self, batch_size: int) -> Iterator[Table]:
        """The DEEQU_TPU_PIPELINE=0 decode: the same iterator and the same
        empty-batch rule, on the calling thread."""
        produced_any = False
        it = self._iter_tables(batch_size)
        try:
            for table in it:
                produced_any = True
                yield table
        finally:
            it.close()
        if not produced_any:
            yield self._empty_batch()


class ParquetSource(DataSource):
    """A Parquet file streamed in batches of at most `batch_rows` rows,
    restricted to `columns` when given."""

    def __init__(
        self, path: str, columns: Optional[List[str]] = None, batch_rows: int = 1 << 22
    ):
        import pyarrow.parquet as pq

        self.path = path
        self.columns = columns
        self.batch_rows = batch_rows
        with pq.ParquetFile(path) as pf:
            self._num_rows = pf.metadata.num_rows
            arrow_schema = pf.schema_arrow
        names = columns if columns is not None else arrow_schema.names
        self._schema_cache = [
            (name, _arrow_ctype(arrow_schema.field(name).type)) for name in names
        ]

    def _schema(self) -> List[Tuple[str, ColumnType]]:
        return self._schema_cache

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def with_columns(self, names) -> "ParquetSource":
        """A view that decodes only `names` (the fused pass asks for the
        union of its inputs' columns)."""
        wanted = set(names)
        keep = [n for n, _ in self._schema_cache if n in wanted]
        if keep == [n for n, _ in self._schema_cache] or not keep:
            return self
        return ParquetSource(self.path, columns=keep, batch_rows=self.batch_rows)

    def _string_columns(self) -> Optional[List[str]]:
        return [n for n, t in self._schema_cache if t == ColumnType.STRING] or None

    def _iter_tables(self, batch_size: int) -> Iterator[Table]:
        """Row group by row group: `read_row_group` frees each group
        (pyarrow's batch iterators keep every decoded batch for the
        reader's life), so memory is O(row group + batch). String columns
        read as DictionaryArrays, whose codes are the analyzers'
        dictionary encode. A group is sliced into batches of `size`;
        groups under size/4 rows coalesce first (incremental writers make
        many tiny groups), while larger groups pass through whole, since
        concatenating string dictionaries costs more than the batch
        machinery it saves."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        size = min(batch_size, self.batch_rows)
        tiny = max(1, size // 4)
        pending: list = []
        pending_rows = 0

        def flush():
            merged = pending[0] if len(pending) == 1 else pa.concat_tables(pending)
            pending.clear()
            return merged

        with pq.ParquetFile(self.path, read_dictionary=self._string_columns()) as pf:
            for g in range(pf.metadata.num_row_groups):
                group = pf.read_row_group(g, columns=self.columns)
                if group.num_rows < tiny:
                    pending.append(group)
                    pending_rows += group.num_rows
                    if pending_rows < size:
                        continue
                    group = flush()
                    pending_rows = 0
                elif pending:
                    head = flush()
                    pending_rows = 0
                    for start in range(0, head.num_rows, size):
                        yield Table.from_arrow(head.slice(start, size))
                for start in range(0, group.num_rows, size):
                    yield Table.from_arrow(group.slice(start, size))
                del group
            if pending:
                tail = flush()
                for start in range(0, tail.num_rows, size):
                    yield Table.from_arrow(tail.slice(start, size))

    def __repr__(self) -> str:
        return f"ParquetSource({self.path!r}, rows={self._num_rows})"


class MappedSource(DataSource):
    """A lazy per-batch transform over another source, such as the
    profiler's cast of inferred-numeric string columns. `fn_columns` is
    the set of columns `fn` reads: only a declared set lets column
    pruning pass through to the base."""

    def __init__(
        self,
        base,
        fn: Callable[[Table], Table],
        schema_overrides: Optional[List[Tuple[str, ColumnType]]] = None,
        fn_columns: Optional[Sequence[str]] = None,
    ):
        self.base = base
        self.fn = fn
        self.fn_columns = None if fn_columns is None else tuple(fn_columns)
        self._overrides = list(schema_overrides or [])
        overrides = dict(self._overrides)
        self._schema_cache = [(name, overrides.get(name, ctype)) for name, ctype in base.schema]
        self.batch_rows = getattr(base, "batch_rows", DataSource.batch_rows)

    def with_columns(self, names) -> "MappedSource":
        base_wc = getattr(self.base, "with_columns", None)
        if base_wc is None or self.fn_columns is None:
            # an undeclared fn may derive one column from another: pruning
            # the base could starve it
            return self
        base_needs = sorted(set(names) | set(self.fn_columns))
        return MappedSource(
            base_wc(base_needs),
            self.fn,
            [(n, t) for n, t in self._overrides if n in set(base_needs)],
            fn_columns=self.fn_columns,
        )

    def _schema(self) -> List[Tuple[str, ColumnType]]:
        return self._schema_cache

    @property
    def num_rows(self) -> int:
        return self.base.num_rows

    def batches(self, batch_size: int) -> Iterator[Table]:
        # the base source prefetches already; fn applies inline
        for batch in self.base.batches(batch_size):
            yield self.fn(batch)


# -- partitioned datasets ------------------------------------------------------

# footer fingerprints memoized by (device, inode, size, mtime_ns): any
# rewrite of the file changes size or mtime (and usually inode), so a
# stat hit can only ever return the digest of the bytes currently on
# disk. Bounded FIFO so a long-lived service scanning many datasets
# can't grow it without limit.
_FP_CACHE: "OrderedDict[str, Tuple[Tuple[int, int, int, int], str]]" = (
    OrderedDict()
)
_FP_CACHE_LOCK = threading.Lock()
_FP_CACHE_MAX = 8192


def partition_fingerprint(path: str) -> str:
    """Content fingerprint of one parquet partition file: sha256 over
    the file's NAME within the dataset, its byte size, and the parquet
    footer's row-group metadata (per-group row counts and byte sizes,
    per-chunk column paths, compressed sizes and min/max/null-count
    statistics). Any rewrite of the file — appended rows, mutated
    values, recompression — changes the footer and therefore the
    fingerprint, so a cached state for the old content can never be
    reused (the state-cache invalidation contract,
    repository/states.py). The directory part of the path is
    deliberately excluded: relocating a dataset wholesale keeps its
    cache warm, since entries are already namespaced by dataset.

    Fingerprints are memoized per stat signature: a preempted run that
    resumes over an N-partition dataset re-fingerprints nothing that
    hasn't changed on disk, so time-to-first-resume-boundary stays flat
    in N instead of costing one footer read per partition per attempt."""
    import pyarrow.parquet as pq

    fstat = os.stat(path)
    stat_sig = (fstat.st_dev, fstat.st_ino, fstat.st_size, fstat.st_mtime_ns)
    with _FP_CACHE_LOCK:
        hit = _FP_CACHE.get(path)
        if hit is not None and hit[0] == stat_sig:
            _FP_CACHE.move_to_end(path)
            return hit[1]

    h = hashlib.sha256()
    h.update(os.path.basename(path).encode("utf-8") + b"\x00")
    h.update(struct.pack(">q", fstat.st_size))
    pf = pq.ParquetFile(path)
    try:
        meta = pf.metadata
        h.update(struct.pack(">qq", meta.num_rows, meta.num_row_groups))
        for g in range(meta.num_row_groups):
            rg = meta.row_group(g)
            h.update(struct.pack(">qq", rg.num_rows, rg.total_byte_size))
            for j in range(rg.num_columns):
                chunk = rg.column(j)
                h.update(chunk.path_in_schema.encode("utf-8") + b"\x00")
                h.update(struct.pack(">q", chunk.total_compressed_size))
                st = chunk.statistics
                if st is not None and bool(getattr(st, "has_min_max", False)):
                    h.update(repr(st.min).encode("utf-8") + b"\x00")
                    h.update(repr(st.max).encode("utf-8") + b"\x00")
                if st is not None and bool(getattr(st, "has_null_count", False)):
                    h.update(struct.pack(">q", int(st.null_count)))
    finally:
        pf.close()
    digest = h.hexdigest()
    with _FP_CACHE_LOCK:
        _FP_CACHE[path] = (stat_sig, digest)
        _FP_CACHE.move_to_end(path)
        while len(_FP_CACHE) > _FP_CACHE_MAX:
            _FP_CACHE.popitem(last=False)
    return digest


class Partition:
    """One partition of a `PartitionedParquetSource`: a Parquet file, its
    name within the dataset, and its content fingerprint (computed
    lazily; a fingerprint reads footer metadata, never a row)."""

    def __init__(self, path: str, columns: Optional[List[str]], batch_rows: int):
        self.path = path
        self.name = os.path.basename(path)
        self._columns = columns
        self._batch_rows = batch_rows
        self._fingerprint: Optional[str] = None

    @property
    def fingerprint(self) -> str:
        if self._fingerprint is None:
            self._fingerprint = partition_fingerprint(self.path)
        return self._fingerprint

    def source(self) -> ParquetSource:
        """A fresh single-file source over this partition alone."""
        return ParquetSource(self.path, columns=self._columns, batch_rows=self._batch_rows)

    def __repr__(self) -> str:
        return f"Partition({self.name!r})"


class PartitionedParquetSource(DataSource):
    """A dataset of Parquet files scanned one partition at a time, in the
    files' name order. The fused pass folds each partition to analyzer
    states and merges them through `State.merge` in that order, so the
    result does not depend on directory listing order."""

    def __init__(self, paths, columns: Optional[List[str]] = None, batch_rows: int = 1 << 22):
        import pyarrow.parquet as pq

        if isinstance(paths, str):
            if os.path.isdir(paths):
                resolved = [
                    os.path.join(paths, n)
                    for n in os.listdir(paths)
                    if n.endswith(".parquet") and not n.startswith(".")
                ]
            else:
                resolved = [paths]
        else:
            resolved = [str(p) for p in paths]
        if not resolved:
            raise ValueError("PartitionedParquetSource needs at least one parquet file")
        self.paths = sorted(resolved, key=os.path.basename)
        self.columns = columns
        self.batch_rows = batch_rows
        self._schema_cache = ParquetSource(
            self.paths[0], columns=columns, batch_rows=batch_rows
        ).schema
        total = 0
        for p in self.paths:
            with pq.ParquetFile(p) as pf:
                total += pf.metadata.num_rows
        self._num_rows = total

    def _schema(self) -> List[Tuple[str, ColumnType]]:
        return self._schema_cache

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def partitions(self) -> List[Partition]:
        """The per-file partitions in name order: `FusedScanPass.run`
        folds each on its own."""
        return [Partition(p, self.columns, self.batch_rows) for p in self.paths]

    def with_columns(self, names) -> "PartitionedParquetSource":
        wanted = set(names)
        keep = [n for n, _ in self._schema_cache if n in wanted]
        if keep == [n for n, _ in self._schema_cache] or not keep:
            return self
        return PartitionedParquetSource(self.paths, columns=keep, batch_rows=self.batch_rows)

    def _iter_tables(self, batch_size: int) -> Iterator[Table]:
        # the whole dataset as one stream (the group-by and profiler
        # passes), partitions chained in the order the merge uses
        for part in self.partitions():
            yield from part.source()._iter_tables(batch_size)

    def __repr__(self) -> str:
        return f"PartitionedParquetSource({len(self.paths)} files, rows={self._num_rows})"
