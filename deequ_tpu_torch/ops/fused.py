"""The fused scan: every scan-shareable analyzer over one shared set of
device inputs per batch.

Per batch the host builds each deduplicated input once, packs them into
the wire format (`pack_batch_inputs`: bit-packed masks, narrowed ints,
all-true masks not sent at all), and copies the packed buffers to the
device. The batch's plan (`get_fused_fn`, cached per plan shape) unpacks
the wire on the device, runs each analyzer's `device_reduce`, and packs
every partial into ONE float64 buffer, so a batch costs one
device-to-host copy. `PipelinedAggFold` starts that copy into pinned
memory and folds batch N-1 on the host while the device runs batch N.

Device-assisted members (the quantile sketches) ride the same program:
their `device_batch` output (the batch's decimated sample, selected on
the device) joins the packed buffer, and the fold consumes it into the
member's sketch (`host_finish_batch`, then `host_consume`).

Host-only members (the profiler's exact value counts and its speculative
numeric statistics of string columns) work on strings and dictionary
codes, which never ship: they fold each batch on the host
(`fold_host_batch`) from the same lazily built inputs, and a failed
input fails only the members that read it.

The placement (runtime.placement_mode, `plan_scan_members`) may move more
members to the host: under "host-discrete" the mask- and code-only ones
(`discrete_inputs`), under "host-all" every one, and then no device
program runs at all. A host merge member folds the batch's host arrays
(`host_reduce`) into its device partial's layout; a host-folded quantile
sketch (`host_batch`) first gets its (column, where) family computed by
one C traversal that also gives the family's moments and, for a
host-folded ApproxCountDistinct, its registers
(`_precompute_family_kernels`), or derived from counts for a column with
few distinct values (`_counts_family_shortcut`), or from the encoded
fold's run streams (data/encfold.py).

A streamed source (data/source.py) runs the same per-batch steps over
its decoded batches, with only the columns its inputs read. A Parquet
source first skips the row groups whose footer statistics prove that no
member's where filter holds on any of their rows, and swaps a where
proven to hold on every row of the rest for a constant mask
(`plan_row_group_prune`, `apply_prune_plan`, lint/pushdown.py); a Parquet
source's numeric and boolean columns (and its dictionary strings that
are read packed only) decode through the C library's kernels, and those
whose every chunk the footer proves readable skip pyarrow for the C
reader (`plan_decode_fastpath`), with the same bits as pyarrow's route;
a column that only the device program's merge members read decodes
straight to its wire rows (`classify_wire_columns`), and a
dictionary-coded column whose every reader is host-folded and served by
the family memos decodes to run streams (`classify_encfold_columns`). With the
pipeline on, each batch's prep (device input builds, wire packing and
the host-to-device copy, issued on a CUDA copy stream of its own) runs on
a stage thread ahead of the consumer (ops/pipeline.py), which launches
the program on its own stream once the copy's event has fired and folds
every batch in order: the same bits as the serial loop. A partitioned
source folds each partition on its own, or loads its states from an
attached state repository (repository/states.py), and merges the states
in partition order.

reference: runners/AnalysisRunner.scala:279-326 (all scan-shareable
analyzers in one `df.agg(...)`); the JAX counterpart is
deequ_tpu/ops/fused.py.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from deequ_tpu_torch import observe
from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
from deequ_tpu_torch.analyzers.states import State
from deequ_tpu_torch.core.controller import StallWatchdog
from deequ_tpu_torch.data.table import ColumnType, Table, large_arrow_dictionary
from deequ_tpu_torch.observe import counters
from deequ_tpu_torch.observe.spans import _NOOP as _NO_SPAN
from deequ_tpu_torch.ops import counts_family, cuda_kernels, pipeline, runtime

DEFAULT_BATCH_SIZE = 1 << 22  # 4,194,304 rows, as the JAX package

_WIRE_DTYPES = {
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float64": torch.float64,
}

_PLAN_CACHE: Dict[Any, "FusedProgram"] = {}
_PLAN_CACHE_MAX = 256  # insertion-order eviction bounds a long-lived process
_PLAN_CACHE_LOCK = threading.Lock()


class AnalyzerRunResult:
    """Outcome of one analyzer in a pass: a state (None = empty) or an error."""

    def __init__(
        self,
        analyzer: ScanShareableAnalyzer,
        state: Optional[State] = None,
        error: Optional[BaseException] = None,
    ):
        self.analyzer = analyzer
        self.state = state
        self.error = error

    def state_or_raise(self) -> Optional[State]:
        if self.error is not None:
            raise self.error
        return self.state


def _merge_partition_results(a: AnalyzerRunResult, b: AnalyzerRunResult) -> AnalyzerRunResult:
    """One analyzer's outcome over two partitions: an error wins, a None
    state (an empty partition) is the identity, and a failing merge is
    that analyzer's error, never the pass's."""
    if a.error is not None:
        return a
    if b.error is not None:
        return b
    if a.state is None:
        return AnalyzerRunResult(a.analyzer, state=b.state)
    if b.state is None:
        return a
    try:
        return AnalyzerRunResult(a.analyzer, state=a.state.merge(b.state))
    except Exception as e:  # noqa: BLE001
        return AnalyzerRunResult(a.analyzer, error=e)


def prune_table_columns(table, specs: Dict[str, Any]):
    """A streamed source restricted to the union of the columns its input
    specs read, so it decodes only what the pass consumes. An in-memory
    Table has no `with_columns` and is returned as is; a spec that does
    not declare its columns turns pruning off."""
    with_columns = getattr(table, "with_columns", None)
    if with_columns is None:
        return table
    needed: set = set()
    for spec in specs.values():
        if spec.columns is None:
            return table
        needed.update(spec.columns)
    if not needed:
        # a Size()-only pass counts rows: the first column will do
        names = table.column_names
        if not names:
            return table
        needed = {names[0]}
    return with_columns(sorted(needed))


def plan_row_group_prune(table, members):
    """The row-group prune plan of a Parquet-backed scan
    (lint/pushdown.py's three-valued interpreter over the file's
    row-group statistics and the live members' where filters), or None
    when `DEEQU_TPU_PUSHDOWN=0`, the source has no statistics, or anything
    goes wrong: pruning only ever skips work, it never fails a run. The
    source is the only statistics reader."""
    if not runtime.pushdown_enabled():
        return None
    stats_fn = getattr(table, "row_group_stats", None)
    if stats_fn is None or getattr(table, "with_prune", None) is None:
        return None
    from deequ_tpu_torch.lint.pushdown import build_prune_plan

    try:
        groups = stats_fn()
        if not groups:
            return None
        return build_prune_plan(
            [getattr(m, "where", None) for m in members], groups, dict(table.schema)
        )
    except Exception:  # noqa: BLE001
        return None


def elide_where_specs(specs: Dict[str, Any], wheres) -> int:
    """Swap the mask spec of each where text in `wheres` (proven all-true
    on every decoded row group) for a constant all-true spec that reads
    no column, in place -> the number swapped. Its filter columns then
    drop out of column pruning, and the all-true mask ships as a
    constant."""
    from deequ_tpu_torch.analyzers.base import InputSpec, where_key

    elided = 0
    for text in wheres:
        key = where_key(text)
        if key in specs:
            specs[key] = InputSpec(
                key=key, build=lambda t: np.ones(t.num_rows, dtype=np.bool_), columns=()
            )
            elided += 1
    return elided


def apply_prune_plan(table, prune, specs: Dict[str, Any]):
    """Act on a PrunePlan: elide the proven-all-true wheres' mask specs
    (`elide_where_specs`), record the decision (a `prune` span, the
    tracer's rg_* counters and `runtime.monitored()`'s rg_* counts), and
    view the source without its proven-all-false row groups."""
    elided = elide_where_specs(specs, prune.elided_wheres())
    with observe.span(
        "prune",
        cat="plan",
        groups_total=prune.total_groups,
        groups_skipped=prune.skipped_groups,
        rows_skipped=prune.skipped_rows,
        wheres_elided=elided,
    ):
        pass
    counters.record_pruned_groups(
        prune.skipped_groups, prune.total_groups, prune.skipped_rows, elided
    )
    if prune.skip:
        table = table.with_prune(prune.skip)
    return table


#: spec-key prefixes whose builds read only the packed form of a
#: dictionary-string column (codes, mask, the dictionary's digest), never
#: its per-row strings: such columns may take the C dictionary decode. A
#: column with a consumer of another prefix stays on the host chain
#: (conservative, never wrong). Numeric and boolean columns need no such
#: proof: both routes materialize them whole.
PACKED_SAFE_PREFIXES = frozenset(
    {
        "num", "valid", "where", "pred", "prednn", "match", "dtclass",
        "hll", "lcc_codes", "lcc_uniq", "optnum", "optnumv",
    }
)


@dataclass(frozen=True)
class DecodePlan:
    """The decode routing of one Parquet-backed scan: the columns that
    take the C Arrow-buffer decode (`fast`; the rest take the host
    chain), and of those the chunks the C reader reads (`reader_chunks`:
    (row group, column) -> ChunkMeta, from the source's
    `_reader_chunk_meta`). Layered on top: the decode-to-wire columns
    (`wire_specs`, column -> runtime.ColumnWireSpec, with the other
    candidates' (column, reason, key) in `wire_falloffs`) and the
    encoded-fold columns (`enc_specs`, column -> data/encfold.py's
    EncFoldColSpec, with the others' (column, reason) in `enc_falloffs`).
    `fallbacks` and `reader_falloffs` give why the other columns stay on
    the host chain or on pyarrow (EXPLAIN's DQ312 and DQ315). Only
    decode time depends on it: every route gives the same bits."""

    fast: Tuple[str, ...]
    fallbacks: Tuple[Tuple[str, str], ...] = ()  # (column, reason) off the C decode
    reader_chunks: Dict[Tuple[int, str], Any] = field(default_factory=dict)
    reader_planned: bool = False
    reader_falloffs: Tuple[Tuple[str, str], ...] = ()  # (column, reason) off the C reader
    total: int = 0
    wire_planned: bool = False
    wire_specs: Dict[str, Any] = field(default_factory=dict)
    wire_falloffs: Tuple[Tuple[str, str, str], ...] = ()
    enc_planned: bool = False
    enc_specs: Dict[str, Any] = field(default_factory=dict)
    enc_falloffs: Tuple[Tuple[str, str], ...] = ()

    @property
    def reader_cols(self) -> Tuple[str, ...]:
        return tuple(sorted({name for _, name in self.reader_chunks}))


def classify_decode_columns(
    col_types: Dict[str, str], specs: Dict[str, Any]
) -> Tuple[List[str], List[Tuple[str, str]]]:
    """-> (the scan's columns that take the C decode, the others with the
    reason each takes the host chain). `col_types` is the source's
    `decode_column_types()`; `specs` the live input specs, whose key
    prefixes prove which dictionary-string columns are read packed only
    (plain strings, timestamps and decimals always take the host chain).
    The reasons are the JAX package's."""
    from deequ_tpu_torch.ops import native

    consumers: Dict[str, set] = {}
    for spec in specs.values():
        prefix = spec.key.split(":", 1)[0]
        for col in spec.columns or ():
            consumers.setdefault(col, set()).add(prefix)
    fast: List[str] = []
    fallbacks: List[Tuple[str, str]] = []
    for name in sorted(col_types):
        token = col_types[name]
        if token in native.DECODE_PRIMITIVES or token == "bool":
            fast.append(name)
        elif token == "dictionary<string,int32>":
            unsafe = sorted(consumers.get(name, set()) - PACKED_SAFE_PREFIXES)
            if unsafe:
                fallbacks.append(
                    (name, "host string values may be required by " + ", ".join(unsafe))
                )
            else:
                fast.append(name)
        elif token in ("string", "large_string"):
            fallbacks.append((name, "plain string values are host objects"))
        elif token.startswith("timestamp"):
            fallbacks.append((name, "timestamp decode needs an arrow cast"))
        elif token.startswith("decimal"):
            fallbacks.append((name, "decimal values decode host-side"))
        else:
            fallbacks.append((name, f"no native kernel for {token}"))
    return fast, fallbacks


#: integer Arrow tokens the wire kernels take, with their value bounds
#: (uint64 is absent: the Column route's int64 wrap is not the kernels')
_WIRE_INT_TOKEN_BOUNDS = {
    "int8": (-(1 << 7), (1 << 7) - 1),
    "int16": (-(1 << 15), (1 << 15) - 1),
    "int32": (-(1 << 31), (1 << 31) - 1),
    "int64": (-(1 << 63), (1 << 63) - 1),
    "uint8": (0, (1 << 8) - 1),
    "uint16": (0, (1 << 16) - 1),
    "uint32": (0, (1 << 32) - 1),
}

#: narrow wire dtypes an int column may pin to, narrowest first
_WIRE_NARROW_LADDER = (
    ("int8", -(1 << 7), (1 << 7) - 1),
    ("int16", -(1 << 15), (1 << 15) - 1),
    ("int32", -(1 << 31), (1 << 31) - 1),
)


def _pin_int_wire_width(token: str, bounds) -> Optional[str]:
    """The narrowest exact wire dtype of an int column, pinned for the
    whole pass from the file's min/max statistics when every row group
    has them, else from the Arrow type's bounds; the range always takes
    in 0 (the kernels' null fill). None when no dtype up to int32 holds
    it: the column then ships a float64 value row, as its Column would."""
    lo, hi = _WIRE_INT_TOKEN_BOUNDS[token]
    if bounds is not None:
        lo, hi = bounds
    lo, hi = min(int(lo), 0), max(int(hi), 0)
    for name, dlo, dhi in _WIRE_NARROW_LADDER:
        if dlo <= lo and hi <= dhi:
            return name
    return None


def classify_wire_columns(
    col_types: Dict[str, str],
    specs: Dict[str, Any],
    packed_only_keys: Set[str],
    int_bounds: Optional[Dict[str, Any]] = None,
):
    """Which fast-decode columns decode straight to the wire. A column
    fuses when its every consumer key is `num:{col}` or `valid:{col}` and
    in `packed_only_keys` (read by the device program's merge members
    only), its token has a wire kernel, and its value layout is known
    before the scan; `int_bounds` maps columns to the file's (min, max).
    Returns (column -> runtime.ColumnWireSpec, [(column, reason, key)])
    with the JAX package's reasons."""
    from deequ_tpu_torch.ops import native

    wire_specs: Dict[str, runtime.ColumnWireSpec] = {}
    falloffs: List[Tuple[str, str, str]] = []
    int_bounds = int_bounds or {}
    candidates = [
        name
        for name in sorted(col_types)
        if col_types[name] in ("double", "float", "bool", "uint64")
        or col_types[name] in _WIRE_INT_TOKEN_BOUNDS
    ]
    if not candidates:
        return wire_specs, falloffs
    unknown_reads = any(spec.columns is None for spec in specs.values())
    consumers: Dict[str, set] = {}
    for spec in specs.values():
        for col in spec.columns or ():
            consumers.setdefault(col, set()).add(spec.key)
    for name in candidates:
        token = col_types[name]
        if unknown_reads:
            falloffs.append((name, "an input spec reads unknown columns", ""))
            continue
        if token == "uint64":
            falloffs.append((name, "uint64 int64-wrap semantics stay on the Column path", ""))
            continue
        keys = consumers.get(name, set())
        if not keys:
            falloffs.append((name, "no live consumer reads this column", ""))
            continue
        bad = sorted(keys - {f"num:{name}", f"valid:{name}"})
        if bad:
            falloffs.append((name, f"consumer {bad[0]} needs the host Column", bad[0]))
            continue
        off_wire = sorted(keys - packed_only_keys)
        if off_wire:
            falloffs.append(
                (name, f"{off_wire[0]} is re-read off-wire by a host/assisted member", off_wire[0])
            )
            continue
        want_value = f"num:{name}" in keys
        value_kind = value_dtype = ""
        desc = "bits"
        if want_value:
            if token == "bool":
                falloffs.append(
                    (name, "bool numeric values build host-side (astype)", f"num:{name}")
                )
                continue
            narrow = None
            if token not in ("double", "float"):
                narrow = _pin_int_wire_width(token, int_bounds.get(name))
            if narrow is None:
                value_kind, value_dtype, desc = "val", "float64", "f64"
            else:
                value_kind, value_dtype, desc = "ival", narrow, narrow.replace("int", "i")
            if not native.wire_supported(token, value_dtype):
                falloffs.append((name, f"no wire kernel for {token}->{value_dtype}", ""))
                continue
        wire_specs[name] = runtime.ColumnWireSpec(
            column=name,
            token=token,
            want_value=want_value,
            want_valid=f"valid:{name}" in keys,
            value_kind=value_kind,
            value_dtype=value_dtype,
            desc=desc,
        )
    return wire_specs, falloffs


def wire_int_bounds(table, columns) -> Dict[str, Any]:
    """(min, max) per column from the source's row-group statistics, for
    the wire planner's narrow-int pinning (see
    `wire_int_bounds_from_groups`)."""
    stats_fn = getattr(table, "row_group_stats", None)
    if stats_fn is None or not columns:
        return {}
    return wire_int_bounds_from_groups(stats_fn(), columns)


def wire_int_bounds_from_groups(groups, columns) -> Dict[str, Any]:
    """(min, max) per column over the row groups' statistics; a column
    appears only when every group has a usable integer min and max (one
    missing statistic leaves it to its type's bounds: wider, never
    wrong)."""
    bounds: Dict[str, Any] = {}
    for name in columns:
        lo = hi = None
        for rg in groups or ():
            st = rg.columns.get(name)
            if st is None or st.min_value is None or st.max_value is None:
                lo = None
                break
            try:
                g_lo, g_hi = int(st.min_value), int(st.max_value)
            except (TypeError, ValueError):
                lo = None
                break
            lo = g_lo if lo is None else min(lo, g_lo)
            hi = g_hi if hi is None else max(hi, g_hi)
        if lo is not None and hi is not None:
            bounds[name] = (lo, hi)
    return bounds


#: analyzers the encoded fold can serve from its family memos; any other
#: consumer of a column needs row-width values
_ENCFOLD_ANALYZERS = frozenset(
    {
        "Mean", "Sum", "Minimum", "Maximum", "StandardDeviation",
        "Completeness", "ApproxQuantile", "ApproxQuantiles",
        "ApproxCountDistinct",
    }
)

#: members whose family job publishes the full sketch memos
_ENCFOLD_SKETCH = frozenset({"ApproxQuantile", "ApproxQuantiles", "ApproxCountDistinct"})

#: input-spec key prefixes the memos can stand in for
_ENCFOLD_KEY_PREFIXES = frozenset({"num", "valid", "hll"})


def classify_encfold_columns(
    col_types: Dict[str, str],
    analyzers,
    specs: Dict[str, Any],
    device_keys,
    groups,
    int_bounds=None,
):
    """Which C-reader columns fold over run streams instead of rows,
    proved before the scan. `col_types` maps the reader's columns to
    their tokens; `analyzers` are the pass's live members; `specs` its
    input specs; `device_keys` the keys the device program reads (a
    device-packed column would expand every batch: excluded); `groups`
    the source's `row_group_stats()`; `int_bounds` the footer (min, max)
    per column. A column qualifies only when every chunk is provably
    all-dictionary-coded and every consumer can be served from the
    memos. Returns (column -> EncFoldColSpec, [(column, reason)]) with
    the JAX package's reasons."""
    from deequ_tpu_torch.data import native_reader as nr
    from deequ_tpu_torch.data.encfold import EncFoldColSpec

    live = list(groups)
    if not live:
        return {}, [(n, "codec: every row group is pruned") for n in sorted(col_types)]
    int_bounds = int_bounds or {}
    prefixes: Dict[str, set] = {}
    keys_by_col: Dict[str, set] = {}
    for spec in specs.values():
        prefix = spec.key.split(":", 1)[0]
        for col in spec.columns or ():
            prefixes.setdefault(col, set()).add(prefix)
            keys_by_col.setdefault(col, set()).add(spec.key)
    names: Dict[str, set] = {}
    wheres: Dict[str, set] = {}
    for a in analyzers:
        try:
            a_cols = set()
            for s in a.input_specs():
                # a spec of unknown reads may touch any column
                a_cols.update(s.columns if s.columns is not None else col_types)
        except Exception:  # noqa: BLE001 - unknowable reads: every column
            a_cols = set(col_types)
        for col in a_cols:
            names.setdefault(col, set()).add(a.name)
            if getattr(a, "where", None) is not None:
                wheres.setdefault(col, set()).add(a.name)
    enc: Dict[str, Any] = {}
    falloffs: List[Tuple[str, str]] = []
    for name in sorted(col_types):
        token = col_types[name]
        if token not in nr.ENCFOLD_TOKENS:
            falloffs.append((name, f"dtype: no run-fold kernel for {token}"))
            continue
        consumers = names.get(name, set())
        bad = sorted(consumers - _ENCFOLD_ANALYZERS)
        if bad:
            falloffs.append((name, f"analyzer: {bad[0]} needs row-width values"))
            continue
        filtered = sorted(wheres.get(name, ()))
        if filtered:
            falloffs.append(
                (name, f"analyzer: {filtered[0]} carries a where filter "
                       "(family memos publish unfiltered only)")
            )
            continue
        extra = sorted(prefixes.get(name, set()) - _ENCFOLD_KEY_PREFIXES)
        if extra:
            falloffs.append((name, f"analyzer: consumer {extra[0]}: needs row values"))
            continue
        if keys_by_col.get(name, set()) & set(device_keys):
            falloffs.append((name, "analyzer: consumed by a device-placed member"))
            continue
        has_sketch = bool(consumers & _ENCFOLD_SKETCH)
        kind = "f64" if token in ("double", "float") else "i64"
        bounds = int_bounds.get(name)
        publish_moments = (
            kind == "i64"
            and "StandardDeviation" not in consumers
            and bounds is not None
            and -(1 << 31) < int(bounds[0])
            and int(bounds[1]) < (1 << 31)
        )
        if "StandardDeviation" in consumers and not has_sketch:
            falloffs.append(
                (name, "analyzer: StandardDeviation without a sketch "
                       "family needs the kernel's m2 stream")
            )
            continue
        if not (has_sketch or publish_moments or prefixes.get(name, set()) <= {"valid"}):
            falloffs.append(
                (name, "dict-size: no memo-servable consumer (moments "
                       "bounds unproven and no sketch family)")
            )
            continue
        reason = None
        for rg in live:
            st = rg.columns.get(name)
            if st is None:
                reason = f"codec: row group {rg.index} carries no chunk layout metadata"
                break
            if (
                st.dictionary_page_offset is None
                or st.data_page_offset is None
                or st.dictionary_page_offset >= st.data_page_offset
            ):
                reason = f"codec: chunk in row group {rg.index} has no leading dictionary page"
                break
            encs = set(st.encodings or ())
            if "RLE_DICTIONARY" in encs:
                # v2 footers list PLAIN for the dictionary page itself: a
                # real PLAIN data page fails its chunk at decode instead
                continue
            if "PLAIN_DICTIONARY" not in encs:
                reason = f"codec: chunk in row group {rg.index} is not dictionary-coded"
                break
            if "PLAIN" in encs:
                # v1 footers list PLAIN only when the writer fell back
                reason = (
                    f"codec: chunk in row group {rg.index} fell back "
                    "to PLAIN data pages (dict-size overflow at write)"
                )
                break
        if reason is not None:
            falloffs.append((name, reason))
            continue
        enc[name] = EncFoldColSpec(
            column=name, token=token, kind=kind, publish_moments=publish_moments
        )
    return enc, falloffs


def plan_decode_fastpath(
    table, specs: Dict[str, Any], member_plan=None, analyzers=None
) -> Optional[DecodePlan]:
    """The DecodePlan of a Parquet-backed scan, after column pruning, or
    None when `DEEQU_TPU_DECODE_FASTPATH=0`, the source cannot be
    planned (an in-memory table) or the C library is off. With
    `DEEQU_TPU_NATIVE_READER` on, the plan also holds the reader's
    chunks. With the pass's `member_plan`, the decode-to-wire verdict
    (`DEEQU_TPU_WIRE_FUSED`) and, with its live `analyzers` too, the
    encoded-fold verdict over the reader's columns
    (`DEEQU_TPU_ENCODED_FOLD`)."""
    if not runtime.decode_fastpath_enabled():
        return None
    types_fn = getattr(table, "decode_column_types", None)
    if types_fn is None or getattr(table, "with_decode_fastpath", None) is None:
        return None
    from deequ_tpu_torch.ops import native

    if not native.available():
        return None
    col_types = types_fn()
    if not col_types:
        return None
    fast, fallbacks = classify_decode_columns(col_types, specs)
    fast_types = {c: col_types[c] for c in fast}
    wire_specs: Dict[str, Any] = {}
    wire_falloffs: List[Tuple[str, str, str]] = []
    # with a member plan the verdict is recorded even when the switch is
    # off (it then fuses nothing), as the JAX package records it
    wire_planned = member_plan is not None
    if wire_planned and runtime.wire_fused_enabled():
        wire_specs, wire_falloffs = classify_wire_columns(
            fast_types,
            specs,
            member_plan.packed_only_keys,
            int_bounds=wire_int_bounds(table, sorted(fast_types)),
        )
    reader_chunks = {}
    reasons: Dict[str, str] = {}
    enc_specs: Dict[str, Any] = {}
    enc_falloffs: List[Tuple[str, str]] = []
    enc_planned = False
    reader_planned = runtime.native_reader_enabled()
    if reader_planned:
        reader_chunks = table._reader_chunk_meta(fast, reasons)
        reader_cols = sorted({name for _, name in reader_chunks})
        if (
            reader_cols
            and analyzers is not None
            and member_plan is not None
            and runtime.encoded_fold_enabled()
        ):
            groups = table.row_group_stats()
            skip = getattr(table, "prune_groups", None) or frozenset()
            enc_specs, enc_falloffs = classify_encfold_columns(
                {c: col_types[c] for c in reader_cols},
                analyzers,
                specs,
                member_plan.device_keys,
                # only the chunks the scan reads are judged
                [rg for rg in groups if rg.index not in skip],
                int_bounds=wire_int_bounds_from_groups(groups, reader_cols),
            )
            enc_planned = True
    return DecodePlan(
        fast=tuple(fast),
        fallbacks=tuple(fallbacks),
        reader_chunks=reader_chunks,
        reader_planned=reader_planned,
        reader_falloffs=tuple(sorted(reasons.items())),
        total=len(col_types),
        wire_planned=wire_planned,
        wire_specs=wire_specs,
        wire_falloffs=tuple(wire_falloffs),
        enc_planned=enc_planned,
        enc_specs=enc_specs,
        enc_falloffs=tuple(enc_falloffs),
    )


def apply_decode_plan(table, plan: DecodePlan):
    """The source with the plan's fast set, wire columns, reader chunks
    and encoded-fold columns attached. The plan is recorded: a
    `decode_fastpath` span and the tracer's decode and reader counters
    with `runtime.decode_workers()` workers, and the wire and
    encoded-fold verdicts (`runtime.monitored()` and the tracer) even
    when they take no column."""
    reader_groups = len({g for g, _ in plan.reader_chunks})
    workers = runtime.decode_workers()
    with observe.span(
        "decode_fastpath",
        cat="plan",
        cols_total=plan.total,
        cols_fast=len(plan.fast),
        cols_fallback=len(plan.fallbacks),
        cols_wire_fused=len(plan.wire_specs),
        cols_reader=len(plan.reader_cols),
        reader_groups=reader_groups,
        cols_encfold=len(plan.enc_specs),
        workers=workers,
    ):
        pass
    counters.record_decode_fastpath(len(plan.fast), plan.total, workers)
    if plan.reader_planned:
        # chunks are static: the scanned columns of every row group the
        # scan reads
        skip = getattr(table, "prune_groups", None) or frozenset()
        stats_fn = getattr(table, "row_group_stats", None)
        groups = (
            sum(1 for g in stats_fn() if g.index not in skip) if stats_fn is not None else 0
        )
        native_chunks = len(plan.reader_chunks)
        total_chunks = max(plan.total * groups, native_chunks)
        counters.record_reader_chunks(native_chunks, total_chunks - native_chunks, total_chunks)
    if plan.wire_planned:
        counters.record_wire_fused(sorted(plan.wire_specs), plan.total, plan.wire_falloffs)
    if plan.enc_planned:
        counters.record_encfold_plan(sorted(plan.enc_specs), plan.total, plan.enc_falloffs)
    if plan.fast:
        table = table.with_decode_fastpath(plan.fast)
    if plan.wire_specs:
        table = table.with_wire_fusion(runtime.WireFusionPlan(plan.wire_specs))
    if plan.reader_chunks:
        table = table.with_native_reader(plan.reader_cols, plan.reader_chunks)
    if plan.enc_specs:
        table = table.with_encoded_fold(plan.enc_specs)
    return table


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@dataclass
class ScanMemberPlan:
    """A pass's members by placement, and their deduplicated input specs.
    Each analyzer index is in exactly one of the four lists or in
    `spec_errors` (its spec construction failed: it fails alone).
    `merge_idx` members fold in the device program and merge partials
    with `merge_agg`; `assisted_idx` members (device-assisted) ride the
    program and finish on the host with `host_consume`; `host_idx`
    members fold their partials on the host (`host_reduce`);
    `host_assisted_idx` members fold each batch on the host (`host_batch`,
    then `host_consume`). `device_keys` are the inputs the device program
    reads, `assisted_keys` those of them an assisted member reads (kept
    off the straight-to-wire decode, as in the JAX package's plan, whose
    assisted members finish against them on the host), `host_keys` each
    host member's inputs."""

    mode: str = "device"
    merge_idx: List[int] = field(default_factory=list)
    assisted_idx: List[int] = field(default_factory=list)
    host_idx: List[int] = field(default_factory=list)
    host_assisted_idx: List[int] = field(default_factory=list)
    specs: Dict[str, Any] = field(default_factory=dict)
    device_keys: Set[str] = field(default_factory=set)
    assisted_keys: Set[str] = field(default_factory=set)
    host_keys: Dict[int, List[str]] = field(default_factory=dict)
    spec_errors: Dict[int, BaseException] = field(default_factory=dict)

    @property
    def packed_only_keys(self) -> Set[str]:
        """The device keys whose only readers are the merge members in the
        device program: the keys that live on the wire alone, so a column
        whose every key is here may decode straight to the wire."""
        host = set()
        for keys in self.host_keys.values():
            host.update(keys)
        return self.device_keys - self.assisted_keys - host


def plan_scan_members(analyzers: Sequence[Any], mode: str = "device") -> ScanMemberPlan:
    """Partition a scan's members by placement — pure and data-free.
    Under ``host-discrete`` the `discrete_inputs` members fold on the
    host; under ``host-all`` every member does (the device-assisted ones
    too), and the device program is skipped. The `host_only` members
    (strings, dictionary codes) fold on the host under every placement."""
    if mode not in runtime.PLACEMENT_MODES:
        raise ValueError(f"unknown placement {mode!r}")
    plan = ScanMemberPlan(mode=mode)
    host_all = mode == "host-all"
    host_discrete = host_all or mode == "host-discrete"
    for i, analyzer in enumerate(analyzers):
        try:
            analyzer_specs = analyzer.input_specs()
        except NotImplementedError:
            raise  # an unported feature is not a data failure
        except Exception as e:  # noqa: BLE001
            plan.spec_errors[i] = e
            continue
        keys = [spec.key for spec in analyzer_specs]
        if getattr(analyzer, "device_assisted", False):
            if host_all or getattr(analyzer, "host_only", False):
                plan.host_assisted_idx.append(i)
                plan.host_keys[i] = keys
            else:
                plan.assisted_idx.append(i)
                plan.device_keys.update(keys)
                plan.assisted_keys.update(keys)
        elif host_all or (host_discrete and getattr(analyzer, "discrete_inputs", False)):
            plan.host_idx.append(i)
            plan.host_keys[i] = keys
        else:
            plan.merge_idx.append(i)
            plan.device_keys.update(keys)
        for spec in analyzer_specs:
            plan.specs.setdefault(spec.key, spec)
    return plan


def build_union_plan(
    plans: Sequence[Sequence[Any]],
) -> Tuple[List[Any], List[List[int]]]:
    """The union plan of a shared scan (service/sharing.py): several
    suites' analyzer lists merged into one superset, pure and data-free.

    Analyzers dedupe by engine identity (the equality the runner and the
    plan signature use), in first-appearance order, so the union's pass
    order follows the submission order. Returns ``(union, memberships)``:
    ``memberships[i]`` indexes plan i's deduplicated analyzers, in its own
    order, into ``union``. Each analyzer's fold state does not depend on
    which other members ride the pass, so selecting a plan's rows of the
    union's results gives its solo run's bits. Where clauses spelled
    differently stay separate members, so the fan-out stays exact."""
    union: List[Any] = []
    index: Dict[Any, int] = {}
    memberships: List[List[int]] = []
    for plan in plans:
        rows: List[int] = []
        seen: set = set()
        for analyzer in plan:
            if analyzer in seen:
                continue
            seen.add(analyzer)
            pos = index.get(analyzer)
            if pos is None:
                pos = index[analyzer] = len(union)
                union.append(analyzer)
            rows.append(pos)
        memberships.append(rows)
    return union, memberships


@dataclass(frozen=True)
class FamilyJobPlan:
    """One family-kernel job: the (column, where) family whose moments,
    decimated quantile sample and (when a host-folded ApproxCountDistinct
    on the same family reads them) HLL registers come out of one C
    traversal. Its identity is the memo key `qkey`."""

    column: str
    where: Optional[str]
    wkey: str
    cap: int
    want_regs: bool

    @property
    def qkey(self) -> str:
        return f"__qsample:{self.column}:{self.wkey}:{self.cap}"

    @property
    def mkey(self) -> str:
        return f"__moments:{self.column}:{self.wkey}"

    @property
    def rkey(self) -> str:
        return f"__hllregs:{self.column}:{self.wkey}"


def family_group_key(wkey: str, cap: int) -> Tuple[str, int]:
    """The jobs one multi-column traversal may take: one where mask, one
    sample cap (the jobs of a batch share its row count)."""
    return (wkey, cap)


def plan_family_jobs(host_assisted_members: Sequence[Any], host_members: Sequence[Any] = ()) -> List[FamilyJobPlan]:
    """The family jobs of a host fold — pure and data-free: one per
    distinct (column, where, cap) of the host-folded quantile sketches;
    `want_regs` marks a family whose registers a host-folded
    ApproxCountDistinct on the same (column, where) reads."""
    from deequ_tpu_torch.analyzers.base import where_key

    acd_families = {
        (getattr(member, "column", None), where_key(getattr(member, "where", None)))
        for member in host_members
        if getattr(member, "name", "") == "ApproxCountDistinct"
    }
    jobs: List[FamilyJobPlan] = []
    seen: set = set()
    for member in host_assisted_members:
        sample_size = getattr(member, "_sample_size", None)
        column = getattr(member, "column", None)
        if sample_size is None or column is None:
            continue
        where = getattr(member, "where", None)
        wkey = where_key(where)
        job = FamilyJobPlan(
            column=column,
            where=where,
            wkey=wkey,
            cap=int(sample_size()),
            want_regs=(column, wkey) in acd_families,
        )
        if job.qkey not in seen:
            seen.add(job.qkey)
            jobs.append(job)
    return jobs


def group_family_jobs(jobs: Sequence[FamilyJobPlan]) -> List[Tuple[Tuple[str, int], List[FamilyJobPlan]]]:
    """Planned jobs by `family_group_key`, in first appearance: each group
    is one (multi-column when it holds more than one) C traversal."""
    groups: Dict[Tuple[str, int], List[FamilyJobPlan]] = {}
    for job in jobs:
        groups.setdefault(family_group_key(job.wkey, job.cap), []).append(job)
    return list(groups.items())


class HostInputs(dict):
    """One batch's inputs by key. A key builds on its first access, so a
    member that answers from another's memo never pays for the inputs
    it skipped. A build failure is remembered and raised again on every
    access: it fails exactly the members that read the key. Traced, a
    build adds its seconds to the innermost open span's `build_s` and
    `build_s:<key>` attributes."""

    def __init__(self, specs: Dict[str, Any], batch: Table):
        super().__init__()
        self._specs = specs
        self.batch = batch
        self.build_errors: Dict[str, BaseException] = {}

    def __missing__(self, key):
        err = self.build_errors.get(key)
        if err is not None:
            raise err
        spec = self._specs.get(key)
        if spec is None:
            raise KeyError(key)
        sp = observe.current_span()
        try:
            t0 = 0.0 if sp is None else time.perf_counter()
            value = np.asarray(spec.build(self.batch))
            if sp is not None:
                # the build's seconds by key, on the span open around it
                seconds = time.perf_counter() - t0
                sp.add("build_s", seconds).add(f"build_s:{key}", seconds)
        except Exception as e:  # noqa: BLE001
            self.build_errors[key] = e
            raise
        self[key] = value
        return value

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            if key in self.build_errors:
                raise
            return default


def fold_host_batch(
    built: HostInputs,
    host_members: Sequence[Tuple[int, Any]],
    host_assisted: Sequence[Tuple[int, Any]],
    host_keys: Dict[int, List[str]],
    host_aggs: Dict[int, Dict[str, np.ndarray]],
    host_states: Dict[int, Optional[State]],
    errors: Dict[int, BaseException],
    streaming: bool = False,
    family_memo: Optional[Dict] = None,
    precomputed: bool = False,
) -> None:
    """One batch's host fold. First the family kernels of the host-folded
    sketches (`_precompute_family_kernels`; `precomputed` when the
    pipeline's prep stage ran them already), then the host-assisted
    members in pass order (`host_batch`, then `host_consume`): one may
    publish per-batch memos into `built` that a later one, or a merge
    member, reads (`_LowCardCounts`' dictionary counts serve
    `_OptimisticNumericStats` and DataType). Then the host merge members
    (`host_reduce`, merged through `merge_agg`). A member whose input or
    fold fails records its error and skips the rest of the pass; inputs
    build when a member first reads them, so one that answers from a
    memo never builds the inputs it skipped. `family_memo` lives for the
    whole scan (the columns that missed the counts route)."""
    if not precomputed:
        _precompute_family_kernels(
            built, host_assisted, host_members, errors, streaming=streaming, family_memo=family_memo
        )
    for i, member in host_assisted:
        if i in errors:
            continue
        try:
            _raise_build_errors(built, host_keys[i])
            host_states[i] = member.host_consume(host_states.get(i), member.host_batch(built))
        except NotImplementedError:
            raise
        except Exception as e:  # noqa: BLE001
            errors[i] = e
    for i, member in host_members:
        if i in errors:
            continue
        try:
            _raise_build_errors(built, host_keys[i])
            agg = member.host_reduce(built)
            prev = host_aggs.get(i)
            host_aggs[i] = agg if prev is None else member.merge_agg(prev, agg)
        except NotImplementedError:
            raise
        except Exception as e:  # noqa: BLE001
            errors[i] = e


def _raise_build_errors(built: HostInputs, keys: Sequence[str]) -> None:
    """Raise a member's first input build error seen so far this batch."""
    for key in keys:
        if key in built.build_errors:
            raise built.build_errors[key]


_FAMILY_POOL = None
_FAMILY_POOL_LOCK = threading.Lock()


def _family_pool():
    """The process's pool for family kernels, made once: the C kernels
    keep grow-only arenas per thread, so short-lived threads would leak
    them."""
    global _FAMILY_POOL
    with _FAMILY_POOL_LOCK:
        if _FAMILY_POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            _FAMILY_POOL = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1), thread_name_prefix="deequ-family"
            )
    return _FAMILY_POOL


def _family_hll_mode(batch, column: str):
    """(hll_mode, hashvals) folding the column's HLL register update into
    its family kernel, with the identities of ops/sketches/hll.py: a
    float64 column hashes its bit patterns (mode 1), an int64 or boolean
    column its canonical int64 values (mode 2). (0, None) when the
    kernel cannot reproduce the identity."""
    try:
        col = batch.column(column)
    except Exception:  # noqa: BLE001 - a missing column: the member fails alone
        return 0, None
    if col.ctype == ColumnType.DOUBLE and col.values.dtype == np.float64:
        return 1, None
    if col.ctype == ColumnType.LONG and col.values.dtype == np.int64:
        return 2, col.values
    if col.ctype == ColumnType.BOOLEAN and col.values.dtype == np.bool_:
        return 2, col.values.astype(np.int64)
    return 0, None


def _publish_family(built: HostInputs, job: FamilyJobPlan, derived, n_rows: int) -> None:
    """Publish a family's outputs (moments6, sample, n_valid, level,
    registers or None) under the memo keys its members read; a moments
    memo already published this batch stays."""
    mom, sample, n_valid, level, regs = derived
    built[job.qkey] = {"sample": sample, "n": int(n_valid), "level": int(level)}
    if regs is not None:
        built[job.rkey] = regs
    if job.mkey not in built:
        built[job.mkey] = {
            "count": float(mom[0]),
            "sum": float(mom[1]),
            "min": float(mom[2]),
            "max": float(mom[3]),
            "m2": float(mom[4]),
            "n_where": float(mom[5]),
            "n_rows": float(n_rows),
        }


def _counts_family_shortcut(built: HostInputs, job: FamilyJobPlan) -> bool:
    """The counts route of a family (ops/counts_family.py): an int64
    column counted over a dense window, else an int64 or float64 column
    by the hash counter, and every family output derived from the counts.
    True when the memos were published (the select kernel then never
    runs, and the float64 `num:` input is never built)."""
    batch = built.batch
    try:
        col = batch.column(job.column)
    except Exception:  # noqa: BLE001 - a missing column: the member fails alone
        return False
    if col.ctype not in (ColumnType.LONG, ColumnType.DOUBLE):
        return False
    values = np.asarray(col.values)
    is_long = col.ctype == ColumnType.LONG
    if values.dtype != (np.int64 if is_long else np.float64):
        return False
    try:
        valid = np.asarray(built[f"valid:{job.column}"])
        warr = None if job.where is None else np.asarray(built[job.wkey])
    except Exception:  # noqa: BLE001 - a build failure: the regular route reports it
        return False
    if valid.dtype != np.bool_ or len(valid) != len(values):
        return False
    if warr is not None and (warr.dtype != np.bool_ or len(warr) != len(values)):
        return False
    derived = None
    if is_long:
        res = counts_family.counts_for_column(values, valid, warr)
        if res is not None:
            counts, lo, _n_valid, n_where = res
            derived = counts_family.family_from_counts(counts, lo, job.cap, n_where, job.want_regs)
    if derived is None:
        n_v = len(values)
        if n_v > 262144:
            # a strided 4096-row sample that is nearly all distinct (a
            # 65,536-value population expects ~3969) means the counter's
            # bound is far exceeded: skip its probe of ~262k rows
            sample = values[:: n_v // 4096][:4096]
            if np.unique(sample).size > 4000:
                return False
        hres = counts_family.hash_counts_for_column(values, valid, warr)
        if hres is None:
            return False
        keys, counts, _n_valid, n_where = hres
        derived = counts_family.family_from_hash_counts(
            keys, counts, "i64" if is_long else "f64", job.cap, n_where, job.want_regs
        )
    _publish_family(built, job, derived, len(values))
    return True


def _precompute_family_kernels(
    built: HostInputs,
    host_assisted: Sequence[Tuple[int, Any]],
    host_members: Sequence[Tuple[int, Any]] = (),
    errors: Dict[int, BaseException] = None,
    streaming: bool = False,
    family_memo: Optional[Dict] = None,
) -> None:
    """Scan sharing across analyzer kinds on the host: for each host-folded
    quantile sketch's (column, where) family, one C traversal gives the
    family's moments (read by Mean, Sum, Minimum, Maximum, StandardDeviation
    and Completeness through their `__moments:` memo), the sketch's
    decimated sample and, when a host-folded ApproxCountDistinct on the
    family reads them, its HLL registers; families of one where mask and
    cap run as one multi-column traversal (`masked_moments_select_multi`;
    `DEEQU_TPU_NO_MULTI_FAMILY` runs one per column, with the same bits),
    groups in parallel on the family pool. Before the kernels: a batch
    decoded by the encoded fold publishes its columns' memos from its run
    streams (data/encfold.py), and a column with few distinct values
    derives them from counts (`_counts_family_shortcut`); a column that
    missed the counts route once is not probed again in this scan
    (`family_memo`). Any failure leaves a memo unset, and its members
    compute on their own."""
    from deequ_tpu_torch.ops import native

    errors = errors if errors is not None else {}
    planned = plan_family_jobs(
        [member for i, member in host_assisted if i not in errors],
        host_members=[member for i, member in host_members if i not in errors],
    )
    if not planned:
        return
    counts_ok = counts_family.enabled()
    batch = built.batch
    enc = getattr(batch, "encfold", None)
    if enc and counts_ok:
        from deequ_tpu_torch.data import encfold

        encfold.publish_memos(built, enc, planned)
    inputs: Dict[str, tuple] = {}  # qkey -> the kernel's arrays
    shortcuts = 0
    for job in planned:
        if job.qkey in built:
            continue
        miss_key = ("counts_miss", job.column, job.wkey)
        if counts_ok and (family_memo is None or miss_key not in family_memo):
            if _counts_family_shortcut(built, job):
                shortcuts += 1
                continue
            if family_memo is not None:
                # dtype and cardinality are the column's: the miss holds
                # for every batch of this scan
                family_memo[miss_key] = True
        try:
            x = np.asarray(built[f"num:{job.column}"])
            valid = np.asarray(built[f"valid:{job.column}"])
            warr = None if job.where is None else np.asarray(built[job.wkey])
        except Exception:  # noqa: BLE001 - the members meet the build error
            continue
        if valid.dtype != np.bool_ or (warr is not None and warr.dtype != np.bool_):
            continue
        if valid.all():
            valid = None  # the kernels' unmasked loops, same results
        hll_mode, hashvals = (
            _family_hll_mode(batch, job.column) if job.want_regs and streaming else (0, None)
        )
        inputs[job.qkey] = (x, valid, warr, hll_mode, hashvals)
    counters.record_family(shortcuts=shortcuts)
    groups = [
        group for _key, group in group_family_jobs([j for j in planned if j.qkey in inputs])
    ]
    if not groups:
        return
    multi = runtime.multi_family_enabled()
    # the family pool's threads adopt this thread's trace context, so the
    # family spans stay under this scan (a no-op when untraced)
    trace_tracer = observe.current_tracer()
    trace_parent = observe.current_span()

    def run_group(group: List[FamilyJobPlan]):
        """-> (each job's outputs, C traversals run)."""
        args = [inputs[job.qkey] for job in group]
        x0 = args[0][0]
        with observe.attached(trace_tracer, trace_parent), observe.span(
            "family_kernel",
            cat="dispatch",
            where=str(group[0].wkey),
            cap=int(group[0].cap),
            rows=len(x0),
            dtype=str(x0.dtype),
            columns=len(group),
            cols=",".join(job.column for job in group),
            batched=len(group) > 1 and multi,
        ):
            if len(group) > 1 and multi:
                # one where mask and cap per group (`family_group_key`)
                outs = native.masked_moments_select_multi(
                    [(x, valid, mode, hv) for x, valid, _w, mode, hv in args], args[0][2],
                    group[0].cap,
                )
                if outs is not None:
                    return outs, 1
            return [
                native.masked_moments_select(x, valid, warr, job.cap, hll_mode=mode, hashvals=hv)
                for job, (x, valid, warr, mode, hv) in zip(group, args)
            ], len(group)

    if len(groups) > 1 and (os.cpu_count() or 1) > 1:
        # the C kernels release the GIL: groups run at once
        group_outs = list(_family_pool().map(run_group, groups))
    else:
        group_outs = [run_group(group) for group in groups]
    kernels = 0
    for group, (outs, calls) in zip(groups, group_outs):
        kernels += calls
        for job, out in zip(group, outs):
            if out is not None:
                _publish_family(built, job, out, len(inputs[job.qkey][0]))
    counters.record_family(kernels=kernels)


def plan_shape_key(
    analyzers: Sequence[ScanShareableAnalyzer], layout: Any, assisted: Sequence[Any] = ()
) -> Tuple[Any, ...]:
    """What decides a batch's device program: the members (by repr, in
    pass order) and the wire layout."""
    return (tuple(repr(a) for a in analyzers), tuple(repr(a) for a in assisted), layout)


# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------


def pack_batch_inputs(
    built_items: Sequence[Tuple[str, Optional[np.ndarray]]],
    padded: int,
    sticky: Dict[str, Any],
    num_rows: int,
    pin: bool = False,
    prepacked: Optional[Dict[str, "runtime.WireRow"]] = None,
):
    """The minimal wire format for one batch, as host tensors:

      * bool masks   -> bit-packed, 1 bit/row, big-endian bit order
                        (np.packbits)
      * all-true masks -> not sent; rebuilt on the device from the row count
      * integers     -> range-narrowed to int8/int16 where exact
      * floats       -> float64

    Same-format rows share one flat buffer per group, so each group is
    one host-to-device copy. `sticky` (kept by the caller for one pass)
    pins each key's format across batches; a key only moves toward the
    general form (const -> bits, narrow -> wider int). `pin` allocates
    the buffers in page-locked memory for asynchronous copies.

    `prepacked` maps keys to the wire rows the decode already wrote in
    final form (the batch's `wire_rows`, runtime.WireRow): their padded
    buffers are copied into the group buffers as they are (no packbits,
    no narrowing), and their built array may be None. A bits row elides
    to const by the same sticky rule as a mask; an "ival" row (a narrow
    int value row) widens to float64 on the device.

    Returns (host buffers by group name, layout); the hashable layout is
    (groups, const_keys, padded)."""
    prepacked = prepacked or {}
    entries_by_group: Dict[Tuple[str, str], List[tuple]] = {}
    const_keys: List[str] = []
    for key, arr in built_items:
        row = prepacked.get(key)
        if row is not None:
            if row.kind == "bits":
                if row.all_valid and sticky.get(key, "const") == "const":
                    sticky[key] = "const"
                    const_keys.append(key)
                    continue
                sticky[key] = "bits"
                entries_by_group.setdefault(("uint8", "bits"), []).append((key, row.arr))
            else:
                entries_by_group.setdefault((row.arr.dtype.name, row.kind), []).append(
                    (key, row.arr)
                )
            continue
        if arr.dtype == np.bool_:
            if arr.all() and sticky.get(key, "const") == "const":
                sticky[key] = "const"
                const_keys.append(key)
                continue
            sticky[key] = "bits"
            entries_by_group.setdefault(("uint8", "bits"), []).append(
                (key, np.packbits(arr))
            )
        elif np.issubdtype(arr.dtype, np.integer):
            arr = runtime.narrow_int_wire(arr, key, sticky)
            entries_by_group.setdefault((arr.dtype.name, "int"), []).append((key, arr))
        else:
            entries_by_group.setdefault(("float64", "val"), []).append(
                (key, arr.astype(np.float64, copy=False))
            )

    buffers: Dict[str, torch.Tensor] = {}
    groups = []
    for (dtype_name, kind), entries in sorted(entries_by_group.items()):
        if dtype_name not in _WIRE_DTYPES:
            raise TypeError(f"no wire format for {dtype_name} inputs")
        group_name = f"{dtype_name}:{kind}"
        row_len = padded // 8 if kind == "bits" else padded
        buf = torch.empty(len(entries) * row_len, dtype=_WIRE_DTYPES[dtype_name], pin_memory=pin)
        view = buf.numpy()
        for i, (_key, arr) in enumerate(entries):
            start = i * row_len
            view[start : start + len(arr)] = arr
            view[start + len(arr) : start + row_len] = 0
        buffers[group_name] = buf
        groups.append((group_name, tuple((key, kind) for key, _arr in entries)))
    layout = (tuple(groups), tuple(sorted(const_keys)), padded)
    return buffers, layout


def pack_dictionaries(
    buffers: Dict[str, torch.Tensor],
    layout,
    dictionaries: Sequence[Tuple[str, Tuple[str, ...], Any]],
    pin: bool = False,
):
    """Add to a batch's wire (`pack_batch_inputs`' buffers and layout) the
    STRING columns whose `dtclass:` and `hll:` keys the device computes
    from the batch's large Arrow dictionary (K5) instead of receiving
    them. `dictionaries` lists (column, keys, Column); each ships as a
    group `dict:<column>` of kind "dict", its rows' int32 codes, with its
    dictionary's offsets and UTF-8 bytes beside it (`_pack_dictionary`).
    Traced, the packing's seconds count as the keys' input builds.
    Returns the layout with the groups added."""
    groups, const_keys, padded = layout
    groups = list(groups)
    for column, keys, col in dictionaries:
        sp = observe.current_span()
        t0 = 0.0 if sp is None else time.perf_counter()
        group_name = f"dict:{column}"
        (
            buffers[group_name], buffers[f"{group_name}:offsets"], buffers[f"{group_name}:bytes"]
        ) = _pack_dictionary(col, padded, pin)
        groups.append((group_name, tuple((key, "dict") for key in keys)))
        if sp is not None:
            seconds = (time.perf_counter() - t0) / len(keys)
            for key in keys:
                sp.add("build_s", seconds).add(f"build_s:{key}", seconds)
    return (tuple(groups), const_keys, padded)


def _pack_dictionary(col, padded: int, pin: bool):
    """A STRING column's batch as K5's wire: its rows' int32 dictionary
    codes (-1 for a null row and past the batch's end, `padded` in all),
    its Arrow dictionary's offsets as int64 from 0 (string and
    large_string, at the dictionary's slice offset) and its UTF-8 bytes.
    The dictionary is read in place; each buffer is one copy."""
    import pyarrow as pa

    dictionary = large_arrow_dictionary(col)
    codes = col.dict_encode()[0]
    n = len(dictionary)
    raw = dictionary.buffers()
    wide = pa.types.is_large_string(dictionary.type)
    offsets = np.frombuffer(raw[1], dtype=np.int64 if wide else np.int32)[
        dictionary.offset : dictionary.offset + n + 1
    ]
    lo, hi = int(offsets[0]), int(offsets[-1])
    codes_buf = torch.empty(padded, dtype=torch.int32, pin_memory=pin)
    view = codes_buf.numpy()
    view[: len(codes)] = codes
    view[len(codes) :] = -1
    offsets_buf = torch.empty(n + 1, dtype=torch.int64, pin_memory=pin)
    np.subtract(offsets, lo, out=offsets_buf.numpy())
    bytes_buf = torch.empty(hi - lo, dtype=torch.uint8, pin_memory=pin)
    if hi > lo:
        bytes_buf.numpy()[:] = np.frombuffer(raw[2], dtype=np.uint8)[lo:hi]
    return codes_buf, offsets_buf, bytes_buf


class FusedProgram:
    """One batch's device program for a plan shape: unpack the wire, run
    every analyzer's reduction, pack the partials into one float64 buffer.
    Eager PyTorch compiles nothing, so what is cached per plan shape is
    the decoded layout and the output layout."""

    def __init__(
        self,
        analyzers: Sequence[ScanShareableAnalyzer],
        layout,
        device: torch.device,
        assisted: Sequence[ScanShareableAnalyzer] = (),
    ):
        self.analyzers = list(analyzers)
        self.assisted = list(assisted)
        self.groups, self.const_keys, self.padded = layout
        self.device = device
        # big-endian bit order of np.packbits: bit 7 is the first row
        self._shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=device)

    def unpack(self, wire: Dict[str, torch.Tensor], num_rows: int) -> Dict[str, Any]:
        inputs: Dict[str, Any] = {}
        for group_name, entries in self.groups:
            if entries[0][1] == "dict":
                # a STRING column's classes and HLL codes from its
                # dictionary (K5), gathered to the rows
                classes, packed = cuda_kernels.classify_hash_dictionary(
                    wire[f"{group_name}:offsets"], wire[f"{group_name}:bytes"], wire[group_name]
                )
                for key, _kind in entries:
                    inputs[key] = classes if key.startswith("dtclass:") else packed
                continue
            rows = wire[group_name].view(len(entries), -1)
            for i, (key, kind) in enumerate(entries):
                row = rows[i]
                if kind == "bits":
                    bits = (row[:, None] >> self._shifts[None, :]) & 1
                    inputs[key] = bits.reshape(-1).bool()
                elif kind == "ival":
                    # a decode-to-wire narrow int row of a num: key: every
                    # value is exact in float64, so this is the row the
                    # Column route ships
                    inputs[key] = row.to(runtime.compute_dtype())
                elif kind == "int" and row.element_size() < 4:
                    inputs[key] = row.to(torch.int32)
                else:
                    inputs[key] = row
        if self.const_keys:
            # padded rows past num_rows are False, like the packed masks
            all_rows = torch.arange(self.padded, device=self.device) < num_rows
            for key in self.const_keys:
                inputs[key] = all_rows
        return inputs

    def __call__(self, wire: Dict[str, torch.Tensor], num_rows: int):
        """-> (flat float64 partials on the device, their layout): the
        merge members' partials, then the assisted members' outputs."""
        inputs = self.unpack(wire, num_rows)
        outs = [a.device_reduce(inputs) for a in self.analyzers]
        outs += [a.device_batch(inputs) for a in self.assisted]
        return pack_outputs(outs, self.device)


def get_fused_fn(
    analyzers: Sequence[ScanShareableAnalyzer],
    layout,
    device: torch.device,
    assisted: Sequence[ScanShareableAnalyzer] = (),
) -> FusedProgram:
    key = (plan_shape_key(analyzers, layout, assisted), str(device))
    with _PLAN_CACHE_LOCK:
        program = _PLAN_CACHE.get(key)
        counters.record_plan_cache(program is not None)
        if program is None:
            program = FusedProgram(analyzers, layout, device, assisted)
            _PLAN_CACHE[key] = program
            while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
                _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    return program


def pack_outputs(outs: Sequence[Dict[str, torch.Tensor]], device: torch.device):
    """Every partial as float64 in ONE flat device tensor (registers,
    counts, histograms and flags are all exact in float64) -> (flat,
    meta); `meta` lists (analyzer position, key, shape) in pack order."""
    leaves: List[torch.Tensor] = []
    meta: List[Tuple[int, str, Tuple[int, ...]]] = []
    for i, out in enumerate(outs):
        for key, value in out.items():
            meta.append((i, key, tuple(value.shape)))
            leaves.append(value.reshape(-1).to(runtime.compute_dtype()))
    if not leaves:
        return torch.zeros(0, dtype=runtime.compute_dtype(), device=device), meta
    return torch.cat(leaves), meta


def unpack_outputs(flat: np.ndarray, meta, n_analyzers: int) -> List[Dict[str, np.ndarray]]:
    """Host float64 partials per analyzer from one packed buffer."""
    outs: List[Dict[str, np.ndarray]] = [{} for _ in range(n_analyzers)]
    off = 0
    for i, key, shape in meta:
        n = int(np.prod(shape)) if shape else 1
        outs[i][key] = flat[off : off + n].reshape(shape).copy()
        off += n
    return outs


class PipelinedAggFold:
    """Cross-batch host fold that overlaps device work with host work:
    `submit` starts the batch's device-to-host copy into pinned memory
    behind a CUDA event, then folds the PREVIOUS batch, whose copy has had
    a batch of device time to land. Partials merge in float64 through
    each analyzer's `merge_agg`, in batch order. Each assisted member's
    output (its sample) is consumed into its host state.

    Under a mesh (parallel/distributed.py) a batch's output holds its
    `n_dev` shards' packed partials, one row each: the merge partials
    fold in shard order 0..n_dev-1 into the batch's, and each assisted
    member consumes each shard's sample, in shard order."""

    def __init__(
        self,
        analyzers: Sequence[ScanShareableAnalyzer],
        device: torch.device,
        assisted: Sequence[ScanShareableAnalyzer] = (),
        n_dev: int = 1,
    ):
        self.analyzers = list(analyzers)
        self.assisted = list(assisted)
        self.device = device
        self.n_dev = n_dev
        self._total: Optional[List[Dict[str, np.ndarray]]] = None
        self._assisted_states: List[Optional[State]] = [None] * len(self.assisted)
        self._pending = None

    def submit(
        self,
        flat: torch.Tensor,
        meta,
        timing: Optional[Tuple[Any, Any]] = None,
    ) -> None:
        """`timing`: the (start, end) CUDA events around the batch's
        program, read once its partials have landed."""
        if self.device.type == "cuda":
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(torch.cuda.current_stream(self.device))
        else:
            host, landed = flat, None
        if self._pending is not None:
            self._fold(self._pending)
        self._pending = (host, landed, meta, timing)

    def _fold(self, pending) -> None:
        """Wait for a batch's packed partials to land on the host (the
        `transfer` span: under asynchronous launches this is where the
        host waits for the device) and fold them (the `merge` span). A
        timed batch's program time goes on the transfer span as
        `device_ms`: its end event came before the copy's, so reading it
        waits for nothing more."""
        host, landed, meta, timing = pending
        with observe.span("transfer", cat="transfer", bytes=int(host.nbytes)) as sp:
            if landed is not None:
                landed.synchronize()
            if timing is not None and sp:
                sp.set(device_ms=timing[0].elapsed_time(timing[1]))
            rows = host.numpy().reshape(self.n_dev, -1)
        with observe.span("merge", cat="merge"):
            self._merge(rows, meta)

    def _merge(self, rows: np.ndarray, meta) -> None:
        n_merge = len(self.analyzers)
        batch_aggs = None
        for d in range(self.n_dev):
            outs = unpack_outputs(rows[d], meta, n_merge + len(self.assisted))
            for i, (analyzer, out) in enumerate(zip(self.assisted, outs[n_merge:])):
                self._assisted_states[i] = analyzer.host_consume(
                    self._assisted_states[i], analyzer.host_finish_batch(out)
                )
            shard_aggs = outs[:n_merge]
            batch_aggs = (
                shard_aggs
                if batch_aggs is None
                else [a.merge_agg(t, b) for a, t, b in zip(self.analyzers, batch_aggs, shard_aggs)]
            )
        if self._total is None:
            self._total = batch_aggs
        else:
            self._total = [
                a.merge_agg(t, b)
                for a, t, b in zip(self.analyzers, self._total, batch_aggs)
            ]

    def finish(self) -> Tuple[List[Dict[str, np.ndarray]], List[Optional[State]]]:
        """-> (folded merge partials, assisted members' states)."""
        if self._pending is not None:
            self._fold(self._pending)
            self._pending = None
        return (self._total if self._total is not None else []), self._assisted_states


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------


def scan_partition(
    analyzers, partition, *, batch_size=None, device=None, controller=None, forensics=None
):
    """Fold ONE partition to per-analyzer results through the
    single-source pass: the one sub-scan of a solo partitioned run
    (`FusedScanPass._run_partitioned`) and of a shard of the sharded scan
    (parallel/multihost.py), so a shard's per-partition states are a solo
    run's, bit for bit."""
    return FusedScanPass(
        analyzers, batch_size, device=device, controller=controller, forensics=forensics
    ).run(partition.source())


def _pad_size(n: int, batch_size: int) -> int:
    """A mesh shard's padded rows for `n` rows: a power of two (at least
    8), capped at `batch_size` rounded up to a multiple of 8, as the JAX
    package pads, so the port's shards hold the JAX mesh's rows."""
    size = 8
    while size < n:
        size *= 2
    return min(size, max(-(-batch_size // 8) * 8, 8))


class FusedScanPass:
    """Runs a set of scan-shareable analyzers in one device pass over a
    table or a streamed source. `device` is where the pass runs: CUDA
    unless the caller asks for the CPU. A `controller`
    (core/controller.RunController) is checked before every batch and
    every partition. A `forensics` capture (observe/forensics.py
    ForensicsCapture) samples each decoded host batch's violating rows;
    without one, each batch pays one falsy check."""

    #: the pass's own `plan_fuse` and `fused_scan` spans (the mesh pass
    #: opens one `dist_scan` span instead)
    _scan_spans = True

    def __init__(
        self,
        analyzers: Sequence[ScanShareableAnalyzer],
        batch_size: Optional[int] = None,
        device: runtime.DeviceLike = None,
        controller=None,
        state_cache=None,
        forensics=None,
    ):
        self.analyzers = list(analyzers)
        # an explicit size (even the default's) enters the plan signature
        self._batch_size_explicit = batch_size is not None
        self.batch_size = batch_size if batch_size is not None else DEFAULT_BATCH_SIZE
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {self.batch_size}")
        self.device = runtime.resolve_device(device)
        self._controller = controller
        # repository/states.StateCacheContext (or None): lets a
        # partitioned run load a partition's states instead of scanning it
        self._state_cache = state_cache
        self._forensics = forensics

    def run(self, table: Table) -> List[AnalyzerRunResult]:
        if getattr(table, "partitions", None) is not None:
            return self._run_partitioned(table)
        return self._run_single(table)

    def _run_partitioned(self, source) -> List[AnalyzerRunResult]:
        """For each partition in the source's (name) order, load its
        states from the attached state cache (fingerprint and plan
        signature hit) or scan it through the single-source pass and save
        the states of a scan without error; then merge the results
        through `State.merge` in partition order. Cache on, off or absent
        fold and merge alike, so the bits equal a full rescan's. A
        controller is checked at each partition boundary."""
        parts = list(source.partitions())
        cache = (
            self._state_cache
            if self._state_cache is not None and runtime.state_cache_enabled()
            else None
        )
        signature = None
        cap = self._forensics
        if cache is not None or cap is not None:
            from deequ_tpu_torch.repository.states import plan_signature_for

            signature = plan_signature_for(
                self.analyzers,
                source,
                batch_size=self.batch_size if self._batch_size_explicit else None,
                device=self.device,
            )
        if cap is not None:
            cap.note_plan_signature(signature)
        merged: Optional[List[AnalyzerRunResult]] = None
        cached_n = scanned_n = 0
        ctl = self._controller
        for part in parts:
            if ctl is not None:
                # a partition boundary is a resume point: every partition
                # before it has saved its states, so a soft cancel trips here
                ctl.check(
                    where=f"partition {part.name}",
                    progress={
                        "partitions_done": cached_n + scanned_n,
                        "partitions_total": len(parts),
                        "partitions_cached": cached_n,
                    },
                    boundary=True,
                )
            results: Optional[List[AnalyzerRunResult]] = None
            if cache is not None:
                sp = observe.span("state_cache", cat="cache", op="load", partition=part.name)
                with sp:
                    states = cache.repository.load_states(
                        cache.dataset, part.fingerprint, signature, self.analyzers
                    )
                    if sp:
                        sp.set(hit=states is not None)
                if states is not None:
                    results = [AnalyzerRunResult(a, state=s) for a, s in zip(self.analyzers, states)]
                    cached_n += 1
                    if cap is not None:
                        cap.note_partition(part.name, part.fingerprint, "cache")
            if results is None:
                results = scan_partition(
                    self.analyzers,
                    part,
                    batch_size=self.batch_size if self._batch_size_explicit else None,
                    device=self.device,
                    controller=ctl,
                    forensics=(
                        cap.enter_partition(part.name, part.fingerprint) if cap is not None else None
                    ),
                )
                scanned_n += 1
                if cap is not None:
                    cap.note_partition(part.name, part.fingerprint, "scan")
                if cache is not None and all(r.error is None for r in results):
                    with observe.span("state_cache", cat="cache", op="save", partition=part.name):
                        cache.repository.save_states(
                            cache.dataset, part.fingerprint, signature,
                            [(r.analyzer, r.state) for r in results],
                        )
            merged = (
                results
                if merged is None
                else [_merge_partition_results(m, r) for m, r in zip(merged, results)]
            )
        counters.record_state_cache(cached_n, scanned_n, len(parts))
        return merged

    def _run_single(self, table: Table) -> List[AnalyzerRunResult]:
        results: Dict[int, AnalyzerRunResult] = {}
        plan_sp = (
            observe.span("plan_fuse", cat="plan", analyzers=len(self.analyzers))
            if self._scan_spans
            else _NO_SPAN
        )
        with plan_sp:
            plan = plan_scan_members(self.analyzers, runtime.placement_mode(self.device))
            for i, err in plan.spec_errors.items():
                results[i] = AnalyzerRunResult(self.analyzers[i], error=err)
            if plan_sp:
                plan_sp.set(
                    placement=plan.mode,
                    input_keys=len(plan.specs),
                    device_members=len(plan.merge_idx) + len(plan.assisted_idx),
                    host_members=len(plan.host_idx) + len(plan.host_assisted_idx),
                )
        live_idx = plan.merge_idx + plan.assisted_idx + plan.host_idx + plan.host_assisted_idx
        if not live_idx:
            return [results[i] for i in range(len(self.analyzers))]
        counters.record_placement(
            plan.mode,
            len(plan.merge_idx) + len(plan.assisted_idx),
            len(plan.host_idx) + len(plan.host_assisted_idx),
        )
        prune = plan_row_group_prune(table, [self.analyzers[i] for i in live_idx])
        if prune is not None:
            # spec elision must precede column pruning, so that an elided
            # where's filter columns drop out of the decode
            table = apply_prune_plan(table, prune, plan.specs)
        table = prune_table_columns(table, plan.specs)
        if self._forensics is not None:
            # coordinates and prune provenance come from the pruned source
            self._forensics.note_table(table)
        # decode routing comes last: it classifies the columns that
        # survived pruning, and attaches to the final view
        decode_plan = self._plan_decode(table, plan, [self.analyzers[i] for i in live_idx])
        if decode_plan is not None:
            table = apply_decode_plan(table, decode_plan)
            if self._forensics is not None:
                self._forensics.note_decode_plan(decode_plan)
        scan_sp = (
            observe.span("fused_scan", cat="scan", analyzers=len(self.analyzers))
            if self._scan_spans
            else _NO_SPAN
        )
        with scan_sp:
            scan = self._run_pass(table, plan)
            if scan_sp:
                scan_sp.set(rows=scan.rows, batches=scan.batches)
            aggs = assisted_states = None
            if scan.use_device and scan.device_error is None:
                # the last batch's transfer and merge belong to the scan
                aggs, assisted_states = scan.fold.finish()
        # host outcomes stand on their own
        for i, member in scan.host_members:
            if i in scan.host_errors:
                results[i] = AnalyzerRunResult(member, error=scan.host_errors[i])
                continue
            try:
                results[i] = AnalyzerRunResult(
                    member, state=member.state_from_aggregates(scan.host_aggs.get(i))
                )
            except Exception as e:  # noqa: BLE001
                results[i] = AnalyzerRunResult(member, error=e)
        for i, member in scan.host_assisted:
            results[i] = AnalyzerRunResult(
                member, state=scan.host_states.get(i), error=scan.host_errors.get(i)
            )
        if scan.device_error is not None:
            # a failed input build fails every analyzer of the shared
            # device program (reference: AnalysisRunner.scala:310-313)
            for i in plan.merge_idx + plan.assisted_idx:
                results[i] = AnalyzerRunResult(self.analyzers[i], error=scan.device_error)
            return [results[i] for i in range(len(self.analyzers))]
        if scan.use_device:
            for i, agg in zip(plan.merge_idx, aggs):
                analyzer = self.analyzers[i]
                try:
                    state = analyzer.state_from_aggregates(agg)
                except Exception as e:  # noqa: BLE001
                    results[i] = AnalyzerRunResult(analyzer, error=e)
                else:
                    results[i] = AnalyzerRunResult(analyzer, state=state)
            for i, state in zip(plan.assisted_idx, assisted_states):
                results[i] = AnalyzerRunResult(self.analyzers[i], state=state)
        return [results[i] for i in range(len(self.analyzers))]

    def _plan_decode(self, table, plan: ScanMemberPlan, live) -> Optional[DecodePlan]:
        """The scan's decode routing, with the decode-to-wire and
        encoded-fold verdicts of its members."""
        return plan_decode_fastpath(table, plan.specs, member_plan=plan, analyzers=live)

    def _new_scan(self, plan: ScanMemberPlan) -> "_BatchScan":
        return _BatchScan(self.device, self._controller, self.analyzers, plan)

    def _pass_label(self, scan: "_BatchScan") -> str:
        members = (
            scan.analyzers + scan.assisted
            + [m for _, m in scan.host_members] + [m for _, m in scan.host_assisted]
        )
        return "scan:" + ",".join(a.name for a in members)

    def _run_pass(self, table: Table, plan: ScanMemberPlan) -> "_BatchScan":
        """One scan over the table's batches: the device program for the
        device-placed members (none runs when no member is), the host fold
        for the rest. With `DEEQU_TPU_HEARTBEAT_S` set, a heartbeat
        reports the scan's progress while it runs."""
        scan = self._new_scan(plan)
        scan.forensics = self._forensics
        counters.record_pass(self._pass_label(scan))
        streaming = bool(getattr(table, "is_streaming", False))
        batch_size = self.batch_size
        if not scan.use_device and not streaming and not self._batch_size_explicit:
            # a pure host fold over an in-memory table with no explicit
            # batch size (an explicit one is a memory bound, always kept):
            # the default exists for the device copy and for stream memory,
            # so one batch of up to ~16M rows saves the per-batch machinery
            batch_size = max(batch_size, min(table.num_rows, 1 << 24))
        scan.streaming = streaming
        total_rows = getattr(table, "num_rows", None)
        # a streamed source caps its batches at its `batch_rows`
        hb_batch = batch_size
        if streaming and getattr(table, "batch_rows", None):
            hb_batch = min(hb_batch, int(table.batch_rows))
        scan.progress = observe.heartbeat.start(
            runtime.heartbeat_s(),
            total_rows=total_rows,
            predicted_batches=(
                None if total_rows is None else max(1, -(-int(total_rows) // hb_batch))
            ),
            name="fused_scan",
        )
        watchdog = None
        if self._controller is not None and runtime.stall_watchdog_s() > 0:
            # a stall dumps the live heartbeat snapshot when the heartbeat
            # runs, else the deequ-* thread stacks, and then cancels
            watchdog = StallWatchdog(
                self._controller, runtime.stall_watchdog_s(), snapshot_fn=scan.progress.snapshot
            ).start()
        try:
            if streaming and runtime.pipeline_enabled():
                scan.run_pipelined(table.batches(batch_size))
            else:
                scan.run_serial(table.batches(batch_size))
        finally:
            if watchdog is not None:
                watchdog.stop()
            scan.progress.finish()
        return scan


@dataclass
class _Prepped:
    """One batch after prep: its host inputs and, for the device program,
    its wire on the device, the copy's event and the wire's layout (or
    the input build error that stopped the program); `precomputed` when
    the prep ran the batch's family kernels."""

    batch: Table
    built: HostInputs
    wire: Optional[Dict[str, torch.Tensor]] = None
    copied: Any = None
    layout: Any = None
    error: Optional[BaseException] = None
    precomputed: bool = False
    wire_bytes: int = 0  # the packed host buffers' bytes, for the dispatch span
    # STRING column -> the `dtclass:`/`hll:` keys K5 computes from its
    # dictionary on the device (`_BatchScan._dictionary_routes`)
    dictionaries: Dict[str, Tuple[str, ...]] = field(default_factory=dict)


def program_timer(device: torch.device) -> Optional[Tuple[Any, Any]]:
    """Two timing events for one launch of the fused program, only under a
    live span (the `dispatch` span) on a CUDA device: untraced, no event
    is made."""
    if observe.current_span() is None or device.type != "cuda":
        return None
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


class _BatchScan:
    """One pass's per-batch loop: `prep` builds a batch's device inputs,
    packs them (splicing in the rows the decode wrote straight to the
    wire) and copies the wire to the device; `fold_item` launches the
    program on the batch and folds it, then folds the host-placed
    members. The serial loop runs both on the caller; the pipelined loop
    runs `prep` on a stage thread (ops/pipeline.py), with its copies on a
    CUDA stream of its own and the host-folded sketches' family kernels,
    and `fold_item` on the caller in batch order. The sticky wire dict is
    written by `prep` alone, in batch order, so both loops give the same
    bits.

    A STRING column whose DataType classes and HLL codes only the device
    program reads, and whose batch came with an Arrow dictionary of more
    than LARGE_DICTIONARY entries (data/table.py), ships that dictionary
    and its codes instead: K5 classifies and hashes it on the device.
    Smaller dictionaries, shared across batches by the dictionary memo,
    and columns with no Arrow dictionary build the keys on the host.

    Spans never synchronize with the card: a `dispatch` span times the
    host's launch of a batch's program, and the wait for the device falls
    into the `transfer` span of the fold that reads its partials."""

    #: whether a batch's large dictionaries may ship for K5 (the mesh's
    #: shards slice host rows, and keep the host route)
    dictionary_route = True

    def __init__(self, device, controller, analyzers, plan: ScanMemberPlan):
        self.device = device
        self.controller = controller
        self.plan = plan
        self.analyzers = [analyzers[i] for i in plan.merge_idx]
        self.assisted = [analyzers[i] for i in plan.assisted_idx]
        self.host_members = [(i, analyzers[i]) for i in plan.host_idx]
        self.host_assisted = [(i, analyzers[i]) for i in plan.host_assisted_idx]
        self.device_keys = sorted(plan.device_keys)
        self.use_device = bool(self.analyzers or self.assisted)
        self.sticky: Dict[str, Any] = {}
        self.fold = PipelinedAggFold(self.analyzers, self.device, self.assisted)
        self.host_aggs: Dict[int, Dict[str, np.ndarray]] = {}
        self.host_states: Dict[int, Optional[State]] = {}
        self.host_errors: Dict[int, BaseException] = {}
        self.family_memo: Dict[Any, Any] = {}  # cross-batch, this scan's
        self.device_error: Optional[BaseException] = None
        # read by the prep stage, so batches in flight stop packing
        self.device_down = threading.Event()
        self.copy_stream = None
        self.streaming = False
        self.batches = 0
        self.rows = 0
        self.forensics = None  # observe/forensics.ForensicsCapture
        self.progress = observe.heartbeat.NOOP_PROGRESS
        # column -> its `dtclass:`/`hll:` keys, and of them those only the
        # device program reads (the keys K5 may compute)
        self.string_keys: Dict[str, List[str]] = {}
        for key, spec in plan.specs.items():
            if key.startswith(("dtclass:", "hll:")):
                self.string_keys.setdefault(spec.columns[0], []).append(key)
        self.device_only_keys = plan.packed_only_keys

    @property
    def host_count(self) -> int:
        return len(self.host_members) + len(self.host_assisted)

    def prep(self, batch: Table, precompute: bool = False) -> _Prepped:
        built = HostInputs(self.plan.specs, batch)
        item = _Prepped(batch, built)
        if precompute and len(self.host_errors) < self.host_count:
            with observe.span("host_prep", cat="host", rows=batch.num_rows):
                _precompute_family_kernels(
                    built, self.host_assisted, self.host_members, self.host_errors,
                    streaming=True, family_memo=self.family_memo,
                )
            item.precomputed = True
        item.dictionaries = self._dictionary_routes(batch)
        if not self.use_device or self.device_down.is_set():
            return item
        wire_rows = getattr(batch, "wire_rows", None) or {}
        routed = {key for keys in item.dictionaries.values() for key in keys}
        try:
            items = [
                (key, None if key in wire_rows else built[key])
                for key in self.device_keys
                if key not in routed
            ]
        except NotImplementedError:
            raise
        except Exception as e:  # noqa: BLE001
            item.error = e
            self.device_down.set()
            return item
        self._ship(item, items, wire_rows)
        return item

    def _dictionary_routes(self, batch: Table) -> Dict[str, Tuple[str, ...]]:
        """The batch's STRING columns that take K5: column -> the keys K5
        computes for it. Records the verdict (`counters.record_device_strings`)
        over every STRING column with a `dtclass:` or `hll:` key."""
        if not self.string_keys:
            return {}
        routes: Dict[str, Tuple[str, ...]] = {}
        total = 0
        for column, keys in self.string_keys.items():
            if not batch.has_column(column):
                continue
            col = batch.column(column)
            if col.ctype != ColumnType.STRING:
                continue
            total += 1
            served = tuple(key for key in keys if key in self.device_only_keys)
            if (
                served
                and self.dictionary_route
                and self.use_device
                and large_arrow_dictionary(col) is not None
            ):
                routes[column] = served
        counters.record_device_strings(len(routes), total)
        return routes

    def _copy_to(self, host: Dict[str, torch.Tensor], device: torch.device, stream):
        """-> (the wire copied to `device`, the copy's event): the copy
        runs on `stream` behind an event, or on the current stream with
        no event when `stream` is None."""
        if stream is None:
            return {k: v.to(device, non_blocking=True) for k, v in host.items()}, None
        # the pinned buffers go back to the host allocator only once the
        # copy recorded on this stream has landed
        with torch.cuda.stream(stream):
            wire = {k: v.to(device, non_blocking=True) for k, v in host.items()}
            copied = torch.cuda.Event()
            copied.record(stream)
        return wire, copied

    def _ship(self, item: _Prepped, items, wire_rows) -> None:
        """Pack the batch's device inputs into its wire and copy it to the
        device (on the copy stream, when the pipeline made one)."""
        batch = item.batch
        pin = self.device.type == "cuda"
        host, item.layout = pack_batch_inputs(
            items, runtime.wire_pad_size(batch.num_rows), self.sticky, batch.num_rows,
            pin=pin, prepacked=wire_rows,
        )
        if item.dictionaries:
            item.layout = pack_dictionaries(
                host, item.layout,
                [(column, keys, batch.column(column)) for column, keys in item.dictionaries.items()],
                pin=pin,
            )
        item.wire_bytes = sum(int(v.nbytes) for v in host.values())
        item.wire, item.copied = self._copy_to(host, self.device, self.copy_stream)

    def _await_copy(self, wire: Dict[str, torch.Tensor], copied, device: torch.device) -> None:
        """Make `device`'s current stream wait for the wire's copy."""
        if copied is None:
            return
        stream = torch.cuda.current_stream(device)
        stream.wait_event(copied)
        for tensor in wire.values():
            # the copy stream's allocator must not hand these blocks out
            # again while this stream still reads them
            tensor.record_stream(stream)

    def _launch(self, item: _Prepped) -> None:
        """Run the device program on the batch's wire and submit its
        partials to the fold; traced on a CUDA device, between two timing
        events on the program's stream."""
        self._await_copy(item.wire, item.copied, self.device)
        program = get_fused_fn(self.analyzers, item.layout, self.device, self.assisted)
        counters.record_launch()
        timing = program_timer(self.device)
        if timing is not None:
            stream = torch.cuda.current_stream(self.device)
            timing[0].record(stream)
        flat, meta = program(item.wire, item.batch.num_rows)
        if timing is not None:
            timing[1].record(stream)
        self.fold.submit(flat, meta, timing=timing)

    def fold_item(self, item: _Prepped) -> bool:
        """Fold one prepped batch; False once every member has failed."""
        if self.controller is not None:
            self.controller.check(
                where="fused_scan batch", progress={"batches": self.batches, "rows": self.rows}
            )
        device_live = self.use_device and self.device_error is None
        host_live = len(self.host_errors) < self.host_count
        if not device_live and not host_live:
            return False
        rows = item.batch.num_rows
        if device_live:
            if item.error is not None:
                self.device_error = item.error
                self.device_down.set()
            elif item.wire is not None:
                with observe.span(
                    "dispatch", cat="dispatch", rows=rows, wire_bytes=item.wire_bytes,
                    **self._dispatch_attrs(),
                ):
                    self._launch(item)
        with observe.span("host_fold", cat="host", rows=rows):
            if host_live:
                fold_host_batch(
                    item.built, self.host_members, self.host_assisted, self.plan.host_keys,
                    self.host_aggs, self.host_states, self.host_errors,
                    streaming=self.streaming, family_memo=self.family_memo,
                    precomputed=item.precomputed,
                )
        if self.forensics is not None:
            # the decoded host batch, through the members' own input
            # specs: no device tensor is read back
            with observe.span("forensics_capture", cat="forensics", rows=rows):
                self.forensics.capture_batch(item.batch, self.rows)
        self.batches += 1
        self.rows += rows
        if self.controller is not None:
            self.controller.beat()
        self.progress.advance(rows)
        return True

    def _dispatch_attrs(self) -> Dict[str, Any]:
        return {}

    def run_serial(self, batches) -> None:
        with contextlib.closing(iter(batches)) as it:
            for batch in it:
                if not self.fold_item(self.prep(batch)):
                    break  # every member has failed: stop scanning

    def _make_copy_streams(self) -> None:
        self.copy_stream = torch.cuda.Stream(device=self.device)

    def run_pipelined(self, batches) -> None:
        """A streamed source's loop with the staged prep (the serial loop
        with `DEEQU_TPU_PIPELINE=0` gives the same bits)."""
        if self.device.type == "cuda" and self.use_device:
            self._make_copy_streams()
        items = pipeline.staged(
            batches, lambda batch: self.prep(batch, precompute=True), name="prep",
            progress=self.progress,
        )
        with contextlib.closing(items):
            with observe.span("pipe_stage", cat="pipeline", stage="fold") as stage_sp:
                for item in items:
                    with self.progress.timed("fold"), observe.span(
                        "pipe_item", cat="pipeline", stage="fold", rows=item.batch.num_rows
                    ):
                        live = self.fold_item(item)
                    if not live:
                        break
                if stage_sp:
                    stage_sp.set(items=self.batches)
