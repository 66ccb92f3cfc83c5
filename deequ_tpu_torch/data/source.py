"""Streamed data sources: out-of-core input for every pass.

A source answers the part of the `Table` interface the engine reads:
``num_rows``, ``column_names``, ``schema``, ``has_column``,
``column(name)`` (a zero-row column for the preconditions),
``batches(n)`` (the row stream) and ``is_streaming = True``, which turns
the group-by and histogram folds into batch merges. Host memory stays
O(batch + groups), never O(rows).

`ParquetSource` reads row group by row group, with string columns as
Arrow dictionaries (their codes are the analyzers' `dict_encode`), on a
prefetch thread (with `DEEQU_TPU_PIPELINE=0` on the caller's thread),
which fans the row groups out to `DEEQU_TPU_DECODE_WORKERS` host
threads and merges their batches back in file order; the C reader's
route adds read-ahead slots that pread the next units' chunks while the
current ones decode. `DEEQU_TPU_SOURCE_STALL_MS` models a remote
store's latency per read. Every worker count gives the same batches.
Numeric and boolean columns the planner approves skip pyarrow's read (the C reader, data/native_reader.py) or
its conversion to numpy (the C Arrow-buffer decode,
data/arrow_decode.py); of those, a column the device program alone
reads may decode straight to its wire rows (the batch's `wire_rows`),
and a dictionary-coded one whose readers the memos serve may decode to
run streams, folded per batch into a value multiset (the batch's
`encfold`, data/encfold.py). Every route gives the same batches bit for
bit.

The JAX counterpart is deequ_tpu/data/source.py.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import os
import queue
import struct
import threading
import time
from collections import OrderedDict, deque
from typing import TYPE_CHECKING, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deequ_tpu_torch.data.table import NUMPY_BACKING, Column, ColumnType, Table
from deequ_tpu_torch.observe import heartbeat
from deequ_tpu_torch.observe import spans as _spans
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.testing import faults

if TYPE_CHECKING:
    from deequ_tpu_torch.data.native_reader import ChunkMeta

_SENTINEL = object()

#: how long `batches()` waits for its decode thread at shutdown (the
#: thread is a daemon; it can only still be alive if one row group's
#: decode takes longer than this)
JOIN_TIMEOUT_S = 10.0

#: what one decode unit's C-reader fetches count for its records: retries
#: taken, chunks recovered by one, chunks whose budget ran dry, faults seen
_READ_TALLY = ("retries", "recovered", "exhausted", "observed")


#: ranged GETs a C-reader read-ahead slot keeps in flight under the
#: `DEEQU_TPU_SOURCE_STALL_MS` latency model, the usual range-request
#: concurrency of an object-store client. Only the model reads it: local
#: preads are issued back to back either way.
READER_INFLIGHT_GETS = 8


class _FetchFailed(Exception):
    """A chunk's fetch failed with an error no retry covers: its decode
    unit reads through pyarrow."""


def _resolve_quietly_fallback(fut) -> None:
    """Resolve a read-ahead future to None (its unit reads through
    pyarrow), where a slot may resolve it at the same moment: losing that
    race is the success case."""
    try:
        fut.set_result(None)
    except Exception:  # noqa: BLE001 - the racing slot resolved it first
        pass


def _close_all_fallback(handles) -> None:
    """Close every reader handle at a scan's end, best effort: a failed
    close during an unwind must not hide the error that caused it."""
    for handle in handles:
        try:
            handle.close()
        except Exception:  # noqa: BLE001 - teardown is best effort
            pass


class _ThreadFiles:
    """One ParquetFile per decode thread (a handle is not thread-safe),
    opened at the thread's first unit; `close` closes them all."""

    def __init__(self, path: str, string_columns: Optional[List[str]]):
        self.path = path
        self.string_columns = string_columns
        self._local = threading.local()
        self._lock = threading.Lock()
        self._open: List = []

    def get(self):
        pf = getattr(self._local, "pf", None)
        if pf is None:
            import pyarrow.parquet as pq

            pf = self._local.pf = pq.ParquetFile(self.path, read_dictionary=self.string_columns)
            with self._lock:
                self._open.append(pf)
        return pf

    def close(self) -> None:
        with self._lock:
            handles, self._open = self._open, []
        _close_all_fallback(handles)


class _WorkerContext:
    """The creating thread's `monitored()` blocks and trace context
    (tracer and innermost span), for the scan's worker threads to adopt
    (`with context():`). A block the adopting thread counts into already
    is not attached twice: an inline redo runs on the scan's own thread."""

    def __init__(self):
        self.sinks = runtime.current_sinks()
        self.tracer = _spans.current_tracer()
        self.parent = _spans.current_span()

    @contextlib.contextmanager
    def __call__(self) -> Iterator[None]:
        have = runtime.current_sinks()
        sinks = [s for s in self.sinks if not any(s is h for h in have)]
        with runtime.attached_sinks(sinks), _spans.attached(self.tracer, self.parent):
            yield


def _stall_groups(unit, stall_s: float) -> None:
    """The modelled latency of a remote store on the pyarrow routes: one
    GET of `stall_s` before each row group's read, on the decoding
    thread, where a range GET would block."""
    if stall_s > 0.0:
        for _ in unit:
            time.sleep(stall_s)


def _ordered_decode(count: int, workers: int, decode, release=None) -> Iterator[Table]:
    """The batches of `decode(i)` for units 0..count-1, decoded on
    `workers` host threads (`deequ-decode-worker`) with at most workers +
    1 units in flight, yielded in unit order. A unit whose worker died
    decodes once more inline on the calling thread (a unit is a pure
    function of the file, so the redo gives the same bits), counted as a
    contained fault and a recovered retry; a second failure propagates.
    On close, `release` runs before the pool is joined."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="deequ-decode-worker")
    pending: "deque" = deque()
    next_unit = 0
    try:
        while next_unit < count or pending:
            while next_unit < count and len(pending) < workers + 1:
                pending.append((next_unit, pool.submit(decode, next_unit)))
                next_unit += 1
            i, fut = pending.popleft()
            try:
                tables = fut.result()
            except Exception:  # noqa: BLE001 - contained: one inline redo
                runtime.record_fault(injected=1)
                tables = decode(i)
                runtime.record_retry(1, 1, 0)
            yield from tables
    finally:
        for _, fut in pending:
            fut.cancel()
        if release is not None:
            release()
        pool.shutdown(wait=True)


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


def _decode_table(arrow_table, fastpath, wire=None) -> Table:
    """Arrow batch -> Table under an `arrow_decode` span, which parts the
    buffer-to-Column work from the Parquet read around it; `wire_fuse`
    counts the columns this batch decoded straight to wire rows."""
    sp = _spans.span("arrow_decode", cat="decode")
    with sp:
        table = Table.from_arrow(arrow_table, fastpath, wire)
        if sp:
            wire_rows = getattr(table, "wire_rows", None) or {}
            sp.set(
                rows=int(table.num_rows),
                fast=bool(fastpath),
                wire_fuse=len({k.split(":", 1)[1] for k in wire_rows}),
            )
    return table


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

        sinks = runtime.current_sinks()
        tracer = _spans.current_tracer()
        parent = _spans.current_span()

        def producer() -> None:
            with runtime.attached_sinks(sinks), _spans.attached(tracer, parent):
                _produce()

        def _produce() -> None:
            it = self._iter_tables(batch_size)
            try:
                with _spans.span("pipe_stage", cat="pipeline", stage="decode") as stage_sp:
                    items = 0
                    while not stop.is_set():
                        sp = _spans.span("pipe_item", cat="pipeline", stage="decode")
                        with sp:
                            table = next(it, _SENTINEL)
                            if sp:
                                # the exhausted iterator still runs its tail
                                # (close): decode time, but no item
                                if table is _SENTINEL:
                                    sp.set(eos=True)
                                else:
                                    sp.set(rows=int(table.num_rows))
                        if table is _SENTINEL or not _put(table):
                            break
                        items += 1
                    if stage_sp:
                        stage_sp.set(items=items)
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
    restricted to `columns` when given.

    `decode_fastpath` names the columns the planner sends through the C
    library's Arrow-buffer decode (data/arrow_decode.py) and
    `native_reader` those whose chunks the C reader reads from the file's
    bytes (data/native_reader.py); `wire_fusion` (runtime.WireFusionPlan)
    the columns decoded straight to the wire, and `encoded_fold`
    (column -> data/encfold.py's EncFoldColSpec) those decoded to run
    streams. All are normally attached by the fused pass
    (ops/fused.py:apply_decode_plan). Every route gives the same batches
    bit for bit. `prune_groups` holds the row groups the scan skips
    unread (`with_prune`, attached by ops/fused.py:apply_prune_plan).
    The footer is read once, here; every view shares it."""

    def __init__(
        self,
        path: str,
        columns: Optional[List[str]] = None,
        batch_rows: int = 1 << 22,
        decode_fastpath: Optional[Sequence[str]] = None,
        native_reader: Optional[Sequence[str]] = None,
    ):
        import pyarrow.parquet as pq

        self.path = path
        self.columns = columns
        self.batch_rows = batch_rows
        self.decode_fastpath = frozenset(decode_fastpath) if decode_fastpath else None
        self.native_reader = frozenset(native_reader) if native_reader else None
        self.wire_fusion = None
        self.encoded_fold = None
        self.prune_groups: Optional[frozenset] = None
        self._reader_chunks: Optional[Dict[Tuple[int, str], "ChunkMeta"]] = None
        with pq.ParquetFile(path) as pf:
            self._meta = pf.metadata
            self._arrow_schema = pf.schema_arrow
        self._num_rows = self._meta.num_rows
        names = columns if columns is not None else self._arrow_schema.names
        self._schema_cache = [
            (name, _arrow_ctype(self._arrow_schema.field(name).type)) for name in names
        ]

    def _schema(self) -> List[Tuple[str, ColumnType]]:
        return self._schema_cache

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def _view(self, **changes) -> "ParquetSource":
        view = copy.copy(self)
        view.__dict__.update(changes)
        if "columns" in changes:
            keep = set(view.columns)
            view._schema_cache = [(n, t) for n, t in self._schema_cache if n in keep]
        if "prune_groups" in changes:
            view._num_rows = sum(
                self._meta.row_group(g).num_rows
                for g in range(self._meta.num_row_groups)
                if g not in view.prune_groups
            )
        return view

    def with_columns(self, names) -> "ParquetSource":
        """A view that decodes only `names` (the fused pass asks for the
        union of its inputs' columns)."""
        wanted = set(names)
        keep = [n for n, _ in self._schema_cache if n in wanted]
        if keep == [n for n, _ in self._schema_cache] or not keep:
            return self
        return self._view(columns=keep)

    def with_prune(self, skip) -> "ParquetSource":
        """A view that skips the row groups in `skip` (indices the pushdown
        interpreter proved all-false for every fused member's where),
        together with those it skipped already; every other view carries
        the set forward."""
        skip = frozenset(int(g) for g in skip)
        if not skip:
            return self
        return self._view(prune_groups=skip | (self.prune_groups or frozenset()))

    def with_decode_fastpath(self, names) -> "ParquetSource":
        """A view whose `names` decode through the C Arrow-buffer kernels."""
        names = frozenset(names)
        if not names or names == (self.decode_fastpath or frozenset()):
            return self
        return self._view(decode_fastpath=names)

    def with_native_reader(self, names, chunks=None) -> "ParquetSource":
        """A view whose `names` the C reader reads from the file's bytes.
        `chunks` are their recipes from `_reader_chunk_meta`, when the
        planner has them already; else the view finds them at its scan."""
        names = frozenset(names)
        if not names or names == (self.native_reader or frozenset()):
            return self
        if chunks is not None:
            chunks = {key: meta for key, meta in chunks.items() if key[1] in names}
        return self._view(native_reader=names, _reader_chunks=chunks)

    def with_wire_fusion(self, plan) -> "ParquetSource":
        """A view whose plan columns decode straight to the wire."""
        if plan is None or not plan.columns:
            return self
        return self._view(wire_fusion=plan)

    def with_encoded_fold(self, specs) -> "ParquetSource":
        """A view whose `specs` columns (a subset of the reader's) decode
        to run streams and fold per batch from them."""
        specs = dict(specs) if specs else None
        if not specs or specs == self.encoded_fold:
            return self
        return self._view(encoded_fold=specs)

    def row_group_stats(self):
        """Per row group, each scanned column chunk's footer statistics as
        lint/pushdown.py records: min, max and null count, and the chunk
        layout (physical type, codec, page encodings, byte range, nesting,
        page placement). A field the footer cannot give is None."""
        from deequ_tpu_torch.lint.pushdown import ColumnStats, RowGroupStats

        names = {name for name, _ in self._schema_cache}
        meta, schema = self._meta, self._meta.schema
        out = []
        for g in range(meta.num_row_groups):
            rg = meta.row_group(g)
            cols = {}
            for j in range(rg.num_columns):
                chunk = rg.column(j)
                name = chunk.path_in_schema
                if name not in names:
                    continue
                try:
                    se = schema.column(j)
                    dpo = int(chunk.data_page_offset)
                    dictpo = (
                        int(chunk.dictionary_page_offset)
                        if chunk.has_dictionary_page and chunk.dictionary_page_offset is not None
                        else None
                    )
                    layout = dict(
                        physical_type=str(chunk.physical_type),
                        codec=str(chunk.compression),
                        encodings=tuple(str(e) for e in chunk.encodings),
                        chunk_offset=dpo if dictpo is None else min(dpo, dictpo),
                        chunk_bytes=int(chunk.total_compressed_size),
                        num_values=int(chunk.num_values),
                        max_def_level=int(se.max_definition_level),
                        max_rep_level=int(se.max_repetition_level),
                        data_page_offset=dpo,
                        dictionary_page_offset=dictpo,
                    )
                except (AttributeError, TypeError, ValueError):
                    layout = {}  # a layout the footer cannot give
                st = chunk.statistics
                if st is None:
                    cols[name] = ColumnStats(**layout)
                    continue
                has_mm = bool(getattr(st, "has_min_max", False))
                nc = st.null_count if bool(getattr(st, "has_null_count", True)) else None
                cols[name] = ColumnStats(
                    min_value=st.min if has_mm else None,
                    max_value=st.max if has_mm else None,
                    null_count=int(nc) if nc is not None else None,
                    **layout,
                )
            out.append(RowGroupStats(index=g, num_rows=int(rg.num_rows), columns=cols))
        return out

    def decode_column_types(self) -> Dict[str, str]:
        """Arrow type tokens per scanned column as the scan decodes them
        (string columns arrive as dictionaries with int32 indices): the
        vocabulary of the decode planner (ops/fused.py:
        classify_decode_columns), keyed against native.DECODE_PRIMITIVES."""
        import pyarrow as pa

        out = {}
        for name, _ in self._schema_cache:
            t = self._arrow_schema.field(name).type
            if pa.types.is_string(t) or pa.types.is_large_string(t):
                out[name] = "dictionary<string,int32>"  # read_dictionary
            elif (
                pa.types.is_dictionary(t)
                and (pa.types.is_string(t.value_type) or pa.types.is_large_string(t.value_type))
                and t.index_type == pa.int32()
            ):
                out[name] = "dictionary<string,int32>"
            else:
                out[name] = str(t)
        return out

    def _reader_chunk_meta(self, names, reasons=None) -> Dict[Tuple[int, str], "ChunkMeta"]:
        """The C reader's (row group, column) decode recipes for those of
        `names` it can read, proved from the footer alone: a numeric or
        boolean Arrow type it decodes (a DECIMAL-annotated float64 keeps
        its type only through pyarrow), and in every chunk the scan reads
        (pruned groups are not read) a physical type that backs it, a
        codec this host can load, page encodings it decodes (no
        dictionary-encoded booleans), no nesting and one value per row.
        One chunk that fails leaves the whole column to pyarrow; a dict
        `reasons` gets each such column's first reason (EXPLAIN's DQ315),
        in the JAX package's words."""
        from deequ_tpu_torch.data.native_reader import ChunkMeta
        from deequ_tpu_torch.data.table import _arrow_logical_decimal
        from deequ_tpu_torch.ops import native

        codec_mask = native.reader_codecs()
        meta, schema = self._meta, self._meta.schema
        reasons = {} if reasons is None else reasons
        skip = self.prune_groups or frozenset()
        tokens = {}
        for name in names:
            try:
                tok = str(self._arrow_schema.field(name).type)
            except KeyError:
                continue
            if tok in native.READER_TOKENS and not _arrow_logical_decimal(self._arrow_schema, name):
                tokens[name] = tok
            else:
                # named by its decode token, as the JAX package names it
                decode_tok = self.decode_column_types().get(name, tok)
                reasons[name] = f"no native page decoder for {decode_tok}"
        recipes: Dict[str, List[Tuple[int, ChunkMeta]]] = {name: [] for name in tokens}
        if len(skip) == meta.num_row_groups:
            for name in tokens:
                reasons[name] = "every row group is pruned"
            return {}
        for g in range(meta.num_row_groups):
            if g in skip:
                continue
            rg = meta.row_group(g)
            for j in range(rg.num_columns):
                chunk = rg.column(j)
                name = chunk.path_in_schema
                if recipes.get(name) is None:
                    continue
                tok = tokens[name]
                allowed_phys, dtype = native.READER_TOKENS[tok]
                try:
                    se = schema.column(j)
                    phys = str(chunk.physical_type)
                    codec = str(chunk.compression)
                    encodings = {str(e) for e in chunk.encodings}
                    reason = _reader_chunk_reason(
                        tok, allowed_phys, phys, codec, encodings, codec_mask, se,
                        int(chunk.num_values), int(rg.num_rows),
                    )
                    eligible = reason is None
                    if eligible:
                        recipe = ChunkMeta(
                            column=name,
                            token=tok,
                            dtype=dtype,
                            phys=native.READER_PHYS_ENUM[phys],
                            codec=native.READER_CODEC_ENUM[codec],
                            offset=_chunk_offset(chunk),
                            nbytes=int(chunk.total_compressed_size),
                            num_values=int(chunk.num_values),
                            max_def=int(se.max_definition_level),
                        )
                except (AttributeError, TypeError, ValueError):
                    eligible = False  # a layout the footer cannot give
                    reason = f"row group {g} carries no chunk layout metadata"
                if eligible:
                    recipes[name].append((g, recipe))
                else:
                    recipes[name] = None
                    reasons[name] = reason
        return {
            (g, name): recipe
            for name, chunks in recipes.items()
            if chunks
            for g, recipe in chunks
        }

    def _decode_fastpath_set(self) -> Optional[frozenset]:
        """The planner's fast-decode set, or None when
        `DEEQU_TPU_DECODE_FASTPATH=0` sends every column to the host."""
        if self.decode_fastpath and runtime.decode_fastpath_enabled():
            return self.decode_fastpath
        return None

    def _native_reader_active(self) -> Optional[frozenset]:
        """The planner's reader set when every gate allows it: the
        `DEEQU_TPU_NATIVE_READER` switch, the decode fast path it
        assembles through, and the C library itself."""
        from deequ_tpu_torch.ops import native

        if (
            self.native_reader
            and runtime.native_reader_enabled()
            and runtime.decode_fastpath_enabled()
            and native.available()
        ):
            return self.native_reader
        return None

    def _wire_fusion_active(self):
        """The attached wire plan when `DEEQU_TPU_WIRE_FUSED` and the
        decode fast path it rides on are both on."""
        if (
            self.wire_fusion is not None
            and self.wire_fusion.columns
            and runtime.wire_fused_enabled()
            and runtime.decode_fastpath_enabled()
        ):
            return self.wire_fusion
        return None

    def _encoded_fold_active(self, native_cols) -> Optional[Dict[str, object]]:
        """The encoded-fold specs of the active reader columns, or None
        when `DEEQU_TPU_ENCODED_FOLD` (or a reader gate) is off."""
        if self.encoded_fold and native_cols and runtime.encoded_fold_enabled():
            specs = {n: spec for n, spec in self.encoded_fold.items() if n in native_cols}
            return specs or None
        return None

    def _string_columns(self) -> Optional[List[str]]:
        return [n for n, t in self._schema_cache if t == ColumnType.STRING] or None

    def _plan_decode_units(self, size: int) -> List[Tuple[int, ...]]:
        """The row groups of each decode unit, whose concatenation is cut
        into batches of `size` rows. A group of at least size/4 rows is a
        unit of its own; smaller groups (incremental writers make many
        tiny ones) coalesce into a unit once they hold `size` rows, or
        when a larger group or the file's end comes. Concatenating string
        dictionaries costs more than the batch machinery it would save,
        so large groups never coalesce."""
        meta = self._meta
        rows = [meta.row_group(g).num_rows for g in range(meta.num_row_groups)]
        skip = self.prune_groups or frozenset()
        tiny = max(1, size // 4)
        units: List[Tuple[int, ...]] = []
        pending: List[int] = []
        pending_rows = 0
        for g, num in enumerate(rows):
            if g in skip:
                continue  # proven to hold no row any member reads
            if num < tiny:
                pending.append(g)
                pending_rows += num
                if pending_rows < size:
                    continue
                units.append(tuple(pending))
                pending, pending_rows = [], 0
            else:
                if pending:
                    units.append(tuple(pending))
                    pending, pending_rows = [], 0
                units.append((g,))
        if pending:
            units.append(tuple(pending))
        return units

    def _iter_tables(self, batch_size: int) -> Iterator[Table]:
        """Decode unit by decode unit (`_plan_decode_units`) on one of
        three routes, each giving the serial route's batches bit for bit
        at any worker count (`runtime.decode_workers()`):

        - the C reader's (`_iter_tables_native`) when a column has reader
          recipes: read-ahead slots pread the units' chunks, decode
          workers decode them and read the other columns through pyarrow;
        - the worker pool's (`_iter_tables_parallel`) when more than one
          worker is asked for: whole units read by pyarrow on host
          threads, merged back in file order;
        - the serial route (`_iter_tables_serial`) otherwise.

        Row groups are read with `read_row_group`, which frees each group
        (pyarrow's batch iterators keep every decoded batch for the
        reader's life), so memory is O(units in flight + batch). String
        columns read as DictionaryArrays, whose codes are the analyzers'
        dictionary encode. The workers are host threads: none touches the
        device."""
        workers = runtime.decode_workers()
        native_cols = self._native_reader_active()
        metas = {}
        if native_cols:
            metas = self._reader_chunks
            if metas is None:
                metas = self._reader_chunk_meta(native_cols)
        if metas:
            yield from self._iter_tables_native(batch_size, workers, metas)
        else:
            yield from self._iter_tables_arrow(batch_size, workers)

    def _iter_tables_arrow(self, batch_size: int, workers: int) -> Iterator[Table]:
        """The pyarrow routes: the worker pool's, or with one worker the
        serial one."""
        if workers > 1:
            return self._iter_tables_parallel(batch_size, workers)
        return self._iter_tables_serial(batch_size)

    def _iter_tables_serial(self, batch_size: int) -> Iterator[Table]:
        import pyarrow.parquet as pq

        size = min(batch_size, self.batch_rows)
        fastpath = self._decode_fastpath_set()
        wire = self._wire_fusion_active()
        stall_s = runtime.source_stall_s()
        with pq.ParquetFile(self.path, read_dictionary=self._string_columns()) as pf:
            for unit in self._plan_decode_units(size):
                _stall_groups(unit, stall_s)
                yield from self._decode_fetched(pf, unit, [], None, size, fastpath, wire, {}, None)

    def _iter_tables_parallel(self, batch_size: int, workers: int) -> Iterator[Table]:
        """The units decoded by `workers` host threads (`_ordered_decode`),
        each thread with a ParquetFile of its own (a handle is not
        thread-safe), one `decode_unit` span each."""
        size = min(batch_size, self.batch_rows)
        units = self._plan_decode_units(size)
        if not units:
            return
        fastpath = self._decode_fastpath_set()
        wire = self._wire_fusion_active()
        stall_s = runtime.source_stall_s()
        files = _ThreadFiles(self.path, self._string_columns())
        context = _WorkerContext()

        def decode_unit(i: int) -> List[Table]:
            faults.fault_point("decode.worker")
            unit = units[i]
            with context(), _spans.span("decode_unit", cat="decode", groups=len(unit)) as sp:
                _stall_groups(unit, stall_s)
                tables = self._decode_fetched(files.get(), unit, [], None, size, fastpath, wire, {}, None)
                if sp:
                    sp.set(rows=sum(int(t.num_rows) for t in tables))
                return tables

        try:
            yield from _ordered_decode(len(units), workers, decode_unit)
        finally:
            files.close()

    def _iter_tables_native(self, batch_size: int, workers: int, metas) -> Iterator[Table]:
        """The C reader's route. A pool of read-ahead slots preads the
        units' reader chunks (`_fetch_unit`), `min(units, max(2,
        workers))` units at once, and `workers` decode threads decode
        them and read the units' other columns through pyarrow
        (`_decode_fetched`); the batches merge back in file order
        (`_ordered_decode`).

        A slot starts unit i only once fewer than workers + 2 units lie
        between i and the decode cursor. The gate is by unit index, not a
        counting semaphore: with a semaphore a slot starting unit i+3 can
        take the permit a waiting slot for unit i was woken for, and once
        the window is full of units ahead of the cursor the scan
        deadlocks (decode waits for unit i, unit i waits for decode). The
        index test cannot starve: decode waiting on unit i means every
        unit before i was consumed, so i passes the gate."""
        from concurrent.futures import Future, ThreadPoolExecutor

        size = min(batch_size, self.batch_rows)
        units = self._plan_decode_units(size)
        if not units:
            return
        try:
            fd = os.open(self.path, os.O_RDONLY)
        except OSError:
            yield from self._iter_tables_arrow(batch_size, workers)
            return
        fastpath = self._decode_fastpath_set()
        wire = self._wire_fusion_active()
        enc_specs = self._encoded_fold_active(self._native_reader_active()) or {}
        stall_s = runtime.source_stall_s()
        scanned = [n for n, _ in self._schema_cache]
        unit_chunks = [
            [(g, name, metas[(g, name)]) for g in unit for name in scanned if (g, name) in metas]
            for unit in units
        ]
        fetched: List[Future] = [Future() for _ in units]
        stop = threading.Event()
        window = threading.Condition()
        consumed = [0]
        context = _WorkerContext()
        files = _ThreadFiles(self.path, self._string_columns())

        def fetch_unit(i: int) -> None:
            try:
                with window:
                    while i >= consumed[0] + workers + 2 and not stop.is_set():
                        window.wait(1.0)
                if not stop.is_set():
                    with context():
                        fetched[i].set_result(
                            self._fetch_unit(fd, units[i], unit_chunks[i], stall_s)
                        )
            except Exception:  # noqa: BLE001 - contained: the unit reads through pyarrow
                # a failed slot is contained, never silent: the fault
                # telemetry counts the unit it sent to pyarrow. A slot the
                # close overtook (its future resolved by `release`) failed
                # at nothing, and sent no unit anywhere
                if not stop.is_set():
                    with context():
                        runtime.record_fault(injected=1, fallback_units=1)
            finally:
                if not fetched[i].done():
                    _resolve_quietly_fallback(fetched[i])

        def decode_unit(i: int) -> List[Table]:
            faults.fault_point("decode.worker")
            hit = fetched[i].done()
            heartbeat.current().note_readahead(hit)
            raw = fetched[i].result()
            with window:
                consumed[0] += 1
                window.notify_all()
            unit = units[i]
            with context(), _spans.span("page_decode", cat="decode", groups=len(unit)) as sp:
                tables = self._decode_fetched(
                    files.get(), unit, unit_chunks[i], raw, size, fastpath, wire, enc_specs, sp
                )
                if sp:
                    sp.set(readahead_hit=bool(hit))
                return tables

        # object stores serve overlapping range requests, so a few slots
        # hide one unit's GET behind another's decode; the window still
        # bounds the fetched but undecoded units at workers + 2
        fetch_pool = ThreadPoolExecutor(
            max_workers=min(len(units), max(2, workers)), thread_name_prefix="deequ-read-ahead"
        )

        def release() -> None:
            # wake every slot, drop the units not started, and resolve the
            # rest, so that no decode worker waits on a fetch that never
            # comes (it reads its unit through pyarrow)
            stop.set()
            with window:
                window.notify_all()
            fetch_pool.shutdown(wait=False, cancel_futures=True)
            for fut in fetched:
                if not fut.done():
                    _resolve_quietly_fallback(fut)

        try:
            for i in range(len(units)):
                fetch_pool.submit(fetch_unit, i)
            yield from _ordered_decode(len(units), workers, decode_unit, release)
        finally:
            release()
            fetch_pool.shutdown(wait=True)  # no slot outlives the descriptor
            os.close(fd)
            files.close()

    def _fetch_native(self, fd: int, meta: "ChunkMeta", key: str, tally: Dict[str, int]):
        """One chunk's bytes through the C reader's pread, with bounded
        retries and exponential backoff (`retry_call`): a failed or short
        read is issued again up to `runtime.retry_budget()` times; a
        budget run dry gives None, and the column reads through pyarrow.
        A corrupt read is cut to half its bytes, so the decode refuses it
        (a flipped byte could decode to wrong values). `tally` sums the
        retries and the faults seen for the unit's records; an error no
        retry covers raises `_FetchFailed`."""
        from deequ_tpu_torch.core.controller import retry_call
        from deequ_tpu_torch.data import native_reader

        def fetch():
            faults.fault_point("read.pread")
            data = native_reader.fetch_chunk(fd, meta)
            if data is not None and faults.fault_point("read.short") == "short":
                return None  # truncated: retried
            return data

        try:
            raw, retries, recovered = retry_call(
                fetch, attempts=runtime.retry_budget(), base_s=runtime.retry_base_s(), key=key
            )
        except Exception as e:  # noqa: BLE001 - the unit degrades (`_fetch_unit`)
            raise _FetchFailed(meta.column) from e
        tally["retries"] += retries
        tally["observed"] += retries
        if recovered:
            tally["recovered"] += 1
        elif raw is None:
            tally["exhausted"] += 1
            tally["observed"] += 1
        if raw is not None and faults.fault_point("read.corrupt") == "corrupt":
            tally["observed"] += 1
            raw = raw[: max(1, len(raw) // 2)]
        return raw

    def _fetch_unit(self, fd: int, unit, chunks, stall_s: float):
        """One unit's reader chunks, pread under a `page_read` span on a
        read-ahead slot: {(group, column): bytes, or None where the
        retries ran dry}, or None when a fetch failed with an error no
        retry covers (the whole unit then reads through pyarrow, counted
        as a fallback unit). The chunks' ranges are hinted to the kernel
        first (posix_fadvise), so its page cache fills during the
        modelled latency: `stall_s` per round of READER_INFLIGHT_GETS
        concurrent GETs, one GET a row group."""
        from deequ_tpu_torch.data import native_reader

        for _, _, meta in chunks:
            native_reader.fadvise_chunk(fd, meta)
        raw: Dict[Tuple[int, str], Optional[np.ndarray]] = {}
        tally = dict.fromkeys(_READ_TALLY, 0)
        lost = False
        sp = _spans.span("page_read", cat="read")
        with sp, heartbeat.current().timed("read"):
            faults.fault_point("read.latency")
            if stall_s > 0.0:
                time.sleep(stall_s * -(-len(unit) // READER_INFLIGHT_GETS))
            try:
                for g, name, meta in chunks:
                    raw[(g, name)] = self._fetch_native(fd, meta, f"{self.path}:{unit[0]}:{name}", tally)
            except _FetchFailed:
                lost = True
            if sp:
                sp.set(
                    groups=len(unit),
                    chunks=len(chunks),
                    bytes_read=sum(len(data) for data in raw.values() if data is not None),
                )
        if tally["retries"] or tally["exhausted"]:
            runtime.record_retry(tally["retries"], tally["recovered"], tally["exhausted"])
        if tally["observed"]:
            runtime.record_fault(injected=tally["observed"])
        if lost:
            runtime.record_fault(injected=1, fallback_units=1)
            return None
        return raw

    def _decode_fetched(self, pf, unit, chunks, raw, size, fastpath, wire, enc_specs, sp) -> List[Table]:
        """One unit's batches from its fetched chunks (`_fetch_unit`; no
        chunks, or None, reads every column through pyarrow, as the serial
        and pool routes do): each chunk decoded by the C reader, as run
        streams for an encoded-fold column, the columns not covered read
        through pyarrow, and each batch assembled from both. `sp` (the
        unit's `page_decode` span) gets its counts."""
        import pyarrow as pa

        from deequ_tpu_torch.data import encfold, native_reader

        scanned = [n for n, _ in self._schema_cache]
        ctypes = dict(self._schema_cache)
        segments: Dict[str, list] = {}
        failed = set()
        enc_off = set()  # columns a chunk of which refused the runs mode
        enc_fallback = 0
        tokens = {}
        for g, name, meta in chunks:
            tokens[name] = meta.token
            data = raw.get((g, name)) if raw is not None else None
            decoded = None
            if data is not None:
                runs = name in enc_specs and name not in enc_off
                if runs:
                    decoded = native_reader.decode_chunk_runs(data, meta)
                if decoded is None:
                    decoded = native_reader.decode_chunk(data, meta)
                    if runs and decoded is not None:
                        # a chunk the runs mode refused decodes at row
                        # width: it fails closed, never to wrong values
                        enc_off.add(name)
                        enc_fallback += 1
            if decoded is None:
                failed.add(name)
            else:
                segments.setdefault(name, []).append(decoded)
        # a column is the reader's in this unit only when every group's
        # chunk decoded; the rest of the unit reads through pyarrow
        covered = {n for n, segs in segments.items() if n not in failed and len(segs) == len(unit)}
        # a column folds over runs only when every chunk decoded to runs;
        # a mixed column expands its run chunks to rows
        run_cols = set()
        for name in sorted(covered):
            segs = segments[name]
            is_run = [isinstance(seg, native_reader.RunChunk) for seg in segs]
            if all(is_run):
                run_cols.add(name)
            elif any(is_run):
                expanded = [
                    native_reader.expand_runs(seg) if isinstance(seg, native_reader.RunChunk) else seg
                    for seg in segs
                ]
                if all(seg is not None for seg in expanded):
                    segments[name] = expanded
                else:
                    covered.discard(name)
        enc_runs = enc_values = enc_saved = enc_codes = 0
        for name in run_cols:
            for rc in segments[name]:
                enc_runs += len(rc.run_len)
                enc_values += rc.num_values
                # the row route builds an 8-byte value and a mask byte per
                # row; the runs keep 12 bytes per run and the dictionary
                enc_saved += max(
                    0, 9 * rc.num_values - 12 * len(rc.run_len) - rc.dict_values.nbytes
                )
        merged = None
        if not covered or len(covered) < len(scanned):
            columns = self.columns if not covered else [n for n in scanned if n not in covered]
            parts = [pf.read_row_group(g, columns=columns) for g in unit]
            merged = parts[0] if len(parts) == 1 else pa.concat_tables(parts)
            del parts
            total = merged.num_rows
        else:
            total = sum(seg.num_values for seg in segments[scanned[0]])
        wire_cols = wire.columns if wire is not None else {}
        tables = []
        for start in range(0, total, size):
            rest = (
                _decode_table(merged.slice(start, size), fastpath, wire)
                if merged is not None
                else None
            )
            if not covered:
                tables.append(rest)
                continue
            stop = min(start + size, total)
            shared: Dict[str, np.ndarray] = {}
            wire_rows = dict((rest.wire_rows if rest is not None else None) or {})
            payloads = {}
            cols = []
            for name in scanned:
                if name not in covered:
                    cols.append(rest.column(name))
                elif name in run_cols:
                    cols.append(encfold.EncFoldStub(
                        name, ctypes[name], tokens[name], segments[name], start, stop
                    ))
                    payload = encfold.build_payload(enc_specs[name], segments[name], start, stop)
                    if payload is not None:
                        payloads[name] = payload
                        enc_codes += payload.codes_folded
                else:
                    fused = None
                    if name in wire_cols:
                        fused = native_reader.assemble_wire_column(
                            name, tokens[name], segments[name], start, stop, wire_cols[name]
                        )
                    if fused is not None:
                        col, rows = fused
                        wire_rows.update(rows)
                    else:
                        col = native_reader.assemble_column(
                            name, tokens[name], segments[name], start, stop, shared
                        )
                    cols.append(col)
            table = Table(cols)
            if wire_rows:
                table.wire_rows = wire_rows
            if payloads:
                table.encfold = payloads
            tables.append(table)
        if sp:
            chunks_native = len(unit) * len(covered)
            sp.set(
                rows=int(total),
                chunks_native=chunks_native,
                chunks_fallback=len(unit) * len(scanned) - chunks_native,
                runs_native=int(enc_runs),
                chunks_runs=len(unit) * len(run_cols),
            )
        if enc_specs and (run_cols or enc_fallback):
            runtime.record_encfold(
                chunks=len(unit) * len(run_cols),
                fallback=enc_fallback,
                runs=enc_runs,
                values=enc_values,
                codes=enc_codes,
                bytes_saved=enc_saved,
            )
        return tables

    def __repr__(self) -> str:
        return f"ParquetSource({self.path!r}, rows={self._num_rows})"


def _reader_chunk_reason(
    tok, allowed_phys, phys, codec, encodings, codec_mask, se, num_values, num_rows
) -> Optional[str]:
    """Why the C reader cannot read one column chunk, or None when it can."""
    from deequ_tpu_torch.ops import native

    if phys not in allowed_phys:
        return f"physical type {phys} cannot back {tok}"
    bit = native.READER_CODEC_MASK.get(codec)
    if bit is None or codec not in native.READER_CODEC_ENUM:
        return f"codec {codec} has no native decompressor"
    if not codec_mask & bit:
        return f"codec {codec} library is not loadable here"
    extra = sorted(encodings - native.READER_ENCODINGS)
    if extra:
        return f"page encoding {extra[0]} has no native decoder"
    if tok == "bool" and encodings & {"PLAIN_DICTIONARY", "RLE_DICTIONARY"}:
        return "dictionary-encoded boolean pages decode via arrow"
    if se.max_repetition_level != 0 or se.max_definition_level > 1:
        return "nested or repeated values need the arrow reader"
    if num_values != num_rows:
        return "chunk value count disagrees with the row group"
    return None


def _chunk_offset(chunk) -> int:
    """A column chunk's first page byte: its dictionary page's when it
    has one."""
    offset = int(chunk.data_page_offset)
    if chunk.has_dictionary_page and chunk.dictionary_page_offset is not None:
        offset = min(offset, int(chunk.dictionary_page_offset))
    return offset


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

    def subset(self, paths) -> "PartitionedParquetSource":
        """The dataset restricted to `paths` (a shard's slice,
        parallel/shard.py), with the same columns, batch rows and name
        order, so a shard folds its partitions in the order a solo run
        visits them. A path not in the dataset raises: it is a fault of
        the plan, and scanning less would hide it."""
        keep = {str(p) for p in paths}
        unknown = keep - set(self.paths)
        if unknown:
            raise ValueError(f"subset paths not in this dataset: {sorted(unknown)}")
        picked = [p for p in self.paths if p in keep]
        if not picked:
            raise ValueError("subset would leave no partitions")
        return PartitionedParquetSource(picked, columns=self.columns, batch_rows=self.batch_rows)

    def decode_column_types(self) -> Dict[str, str]:
        """The decode vocabulary of the dataset (every partition has one
        schema): the first partition's."""
        return ParquetSource(
            self.paths[0], columns=self.columns, batch_rows=self.batch_rows
        ).decode_column_types()

    def _iter_tables(self, batch_size: int) -> Iterator[Table]:
        # the whole dataset as one stream (the group-by and profiler
        # passes), partitions chained in the order the merge uses
        for part in self.partitions():
            yield from part.source()._iter_tables(batch_size)

    def __repr__(self) -> str:
        return f"PartitionedParquetSource({len(self.paths)} files, rows={self._num_rows})"
