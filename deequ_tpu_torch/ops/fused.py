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
their `device_batch` output (a histogram) joins the packed buffer, and
the fold finishes each against the batch's host inputs, which stay alive
until that batch folds (`host_finish_batch`, then `host_consume`).

Host-only members (the profiler's exact value counts and its speculative
numeric statistics of string columns) work on strings and dictionary
codes, which never ship: they fold each batch on the host
(`fold_host_batch`) from the same lazily built inputs, and a failed
input fails only the members that read it.

A streamed source (data/source.py) runs the same per-batch steps over
its decoded batches, with only the columns its inputs read; a Parquet
source's numeric and boolean columns (and its dictionary strings that
are read packed only) decode through the C library's kernels, and those
whose every chunk the footer proves readable skip pyarrow for the C
reader (`plan_decode_fastpath`), with the same bits as pyarrow's route. With the
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
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
from deequ_tpu_torch.analyzers.states import State
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import pipeline, runtime

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
    `_reader_chunk_meta`). Only decode time depends on it: every route
    gives the same Columns."""

    fast: Tuple[str, ...]
    reader_chunks: Dict[Tuple[int, str], Any] = field(default_factory=dict)

    @property
    def reader_cols(self) -> Tuple[str, ...]:
        return tuple(sorted({name for _, name in self.reader_chunks}))


def classify_decode_columns(col_types: Dict[str, str], specs: Dict[str, Any]) -> List[str]:
    """The scan's columns that take the C decode; the rest take the host
    chain. `col_types` is the source's `decode_column_types()`; `specs`
    the live input specs, whose key prefixes prove which
    dictionary-string columns are read packed only (plain strings,
    timestamps and decimals always take the host chain)."""
    from deequ_tpu_torch.ops import native

    consumers: Dict[str, set] = {}
    for spec in specs.values():
        prefix = spec.key.split(":", 1)[0]
        for col in spec.columns or ():
            consumers.setdefault(col, set()).add(prefix)
    fast: List[str] = []
    for name in sorted(col_types):
        token = col_types[name]
        if token in native.DECODE_PRIMITIVES or token == "bool":
            fast.append(name)
        elif token == "dictionary<string,int32>" and consumers.get(name, set()) <= PACKED_SAFE_PREFIXES:
            fast.append(name)
    return fast


def plan_decode_fastpath(table, specs: Dict[str, Any]) -> Optional[DecodePlan]:
    """The DecodePlan of a Parquet-backed scan, after column pruning, or
    None when `DEEQU_TPU_DECODE_FASTPATH=0`, the source cannot be
    planned (an in-memory table) or the C library is off. With
    `DEEQU_TPU_NATIVE_READER` on, the plan also holds the reader's
    chunks."""
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
    fast = classify_decode_columns(col_types, specs)
    reader_chunks = {}
    if runtime.native_reader_enabled():
        reader_chunks = table._reader_chunk_meta(fast)
    return DecodePlan(fast=tuple(fast), reader_chunks=reader_chunks)


def apply_decode_plan(table, plan: DecodePlan):
    """The source with the plan's fast set and reader chunks attached."""
    if plan.fast:
        table = table.with_decode_fastpath(plan.fast)
    if plan.reader_chunks:
        table = table.with_native_reader(plan.reader_cols, plan.reader_chunks)
    return table


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@dataclass
class ScanMemberPlan:
    """A pass's members and their deduplicated input specs. An analyzer
    whose spec construction fails sits in `spec_errors` and fails alone.
    `merge_idx` members fold partials with `merge_agg`; `assisted_idx`
    members (device-assisted) fold on the host with `host_consume`;
    `host_assisted_idx` members (host-only) never touch the device and
    read the inputs named in `host_keys`. `device_keys` are the inputs
    the device program needs."""

    merge_idx: List[int] = field(default_factory=list)
    assisted_idx: List[int] = field(default_factory=list)
    host_assisted_idx: List[int] = field(default_factory=list)
    specs: Dict[str, Any] = field(default_factory=dict)
    device_keys: Set[str] = field(default_factory=set)
    host_keys: Dict[int, List[str]] = field(default_factory=dict)
    spec_errors: Dict[int, BaseException] = field(default_factory=dict)


def plan_scan_members(analyzers: Sequence[Any], mode: Optional[str] = None) -> ScanMemberPlan:
    """Partition a scan's members — pure and data-free. Only the
    ``device`` placement is ported: every member folds in the fused
    device pass except the `host_only` device-assisted members, whose
    inputs (strings, dictionary codes) never ship under any placement."""
    if mode is None:
        mode = runtime.placement_mode()
    if mode != "device":
        raise NotImplementedError(f"placement {mode!r} is not ported yet")
    plan = ScanMemberPlan()
    for i, analyzer in enumerate(analyzers):
        try:
            analyzer_specs = analyzer.input_specs()
        except NotImplementedError:
            raise  # an unported feature is not a data failure
        except Exception as e:  # noqa: BLE001
            plan.spec_errors[i] = e
            continue
        keys = [spec.key for spec in analyzer_specs]
        if getattr(analyzer, "host_only", False):
            plan.host_assisted_idx.append(i)
            plan.host_keys[i] = keys
        else:
            if getattr(analyzer, "device_assisted", False):
                plan.assisted_idx.append(i)
            else:
                plan.merge_idx.append(i)
            plan.device_keys.update(keys)
        for spec in analyzer_specs:
            plan.specs.setdefault(spec.key, spec)
    return plan


class HostInputs(dict):
    """One batch's inputs by key. A key builds on its first access, so a
    member that answers from another's memo never pays for the inputs
    it skipped. A build failure is remembered and raised again on every
    access: it fails exactly the members that read the key."""

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
        try:
            value = np.asarray(spec.build(self.batch))
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
    host_assisted: Sequence[Tuple[int, Any]],
    host_keys: Dict[int, List[str]],
    states: Dict[int, Optional[State]],
    errors: Dict[int, BaseException],
) -> None:
    """One batch's fold of the host-only members, in pass order: a member
    may publish per-batch memos into `built` that a later one reads
    (`_LowCardCounts`' dictionary counts serve `_OptimisticNumericStats`),
    so the order is the plan's. A member whose input or fold fails
    records its error and skips the rest of the pass."""
    for i, member in host_assisted:
        if i in errors:
            continue
        try:
            for key in host_keys[i]:
                built[key]  # raises this key's build error
            states[i] = member.host_consume(states.get(i), member.host_batch(built))
        except NotImplementedError:
            raise
        except Exception as e:  # noqa: BLE001
            errors[i] = e


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
    built_items: Sequence[Tuple[str, np.ndarray]],
    padded: int,
    sticky: Dict[str, Any],
    num_rows: int,
    pin: bool = False,
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

    Returns (host buffers by group name, layout); the hashable layout is
    (groups, const_keys, padded)."""
    entries_by_group: Dict[Tuple[str, str], List[tuple]] = {}
    const_keys: List[str] = []
    for key, arr in built_items:
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
            rows = wire[group_name].view(len(entries), -1)
            for i, (key, kind) in enumerate(entries):
                row = rows[i]
                if kind == "bits":
                    bits = (row[:, None] >> self._shifts[None, :]) & 1
                    inputs[key] = bits.reshape(-1).bool()
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
    output is finished against the batch's host inputs (`host_ctx`, kept
    alive until the batch folds) and consumed into its host state."""

    def __init__(
        self,
        analyzers: Sequence[ScanShareableAnalyzer],
        device: torch.device,
        assisted: Sequence[ScanShareableAnalyzer] = (),
    ):
        self.analyzers = list(analyzers)
        self.assisted = list(assisted)
        self.device = device
        self._total: Optional[List[Dict[str, np.ndarray]]] = None
        self._assisted_states: List[Optional[State]] = [None] * len(self.assisted)
        self._pending = None

    def submit(
        self, flat: torch.Tensor, meta, host_ctx: Optional[Dict[str, np.ndarray]] = None
    ) -> None:
        if self.device.type == "cuda":
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(torch.cuda.current_stream(self.device))
        else:
            host, landed = flat, None
        if self._pending is not None:
            self._fold(self._pending)
        self._pending = (host, landed, meta, host_ctx)

    def _fold(self, pending) -> None:
        host, landed, meta, host_ctx = pending
        if landed is not None:
            landed.synchronize()
        n_merge = len(self.analyzers)
        outs = unpack_outputs(host.numpy(), meta, n_merge + len(self.assisted))
        batch_aggs = outs[:n_merge]
        for i, (analyzer, out) in enumerate(zip(self.assisted, outs[n_merge:])):
            self._assisted_states[i] = analyzer.host_consume(
                self._assisted_states[i], analyzer.host_finish_batch(out, host_ctx)
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


class FusedScanPass:
    """Runs a set of scan-shareable analyzers in one device pass over a
    table or a streamed source. `device` is where the pass runs: CUDA
    unless the caller asks for the CPU. A `controller`
    (core/controller.RunController) is checked before every batch and
    every partition."""

    def __init__(
        self,
        analyzers: Sequence[ScanShareableAnalyzer],
        batch_size: Optional[int] = None,
        device: runtime.DeviceLike = None,
        controller=None,
        state_cache=None,
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
        if cache is not None:
            from deequ_tpu_torch.repository.states import plan_signature_for

            signature = plan_signature_for(
                self.analyzers,
                source,
                batch_size=self.batch_size if self._batch_size_explicit else None,
                device=self.device,
            )
        merged: Optional[List[AnalyzerRunResult]] = None
        cached_n = scanned_n = 0
        ctl = self._controller
        for part in parts:
            if ctl is not None:
                ctl.check(
                    where=f"partition {part.name}",
                    progress={
                        "partitions_done": cached_n + scanned_n,
                        "partitions_total": len(parts),
                        "partitions_cached": cached_n,
                    },
                )
            results: Optional[List[AnalyzerRunResult]] = None
            if cache is not None:
                states = cache.repository.load_states(
                    cache.dataset, part.fingerprint, signature, self.analyzers
                )
                if states is not None:
                    results = [AnalyzerRunResult(a, state=s) for a, s in zip(self.analyzers, states)]
                    cached_n += 1
            if results is None:
                results = FusedScanPass(
                    self.analyzers, self.batch_size, self.device, controller=ctl
                ).run(part.source())
                scanned_n += 1
                if cache is not None and all(r.error is None for r in results):
                    cache.repository.save_states(
                        cache.dataset, part.fingerprint, signature,
                        [(r.analyzer, r.state) for r in results],
                    )
            merged = (
                results
                if merged is None
                else [_merge_partition_results(m, r) for m, r in zip(merged, results)]
            )
        runtime.record_state_cache(cached_n, scanned_n, len(parts))
        return merged

    def _run_single(self, table: Table) -> List[AnalyzerRunResult]:
        results: Dict[int, AnalyzerRunResult] = {}
        plan = plan_scan_members(self.analyzers)
        for i, err in plan.spec_errors.items():
            results[i] = AnalyzerRunResult(self.analyzers[i], error=err)
        members = [self.analyzers[i] for i in plan.merge_idx]
        assisted = [self.analyzers[i] for i in plan.assisted_idx]
        host_assisted = [(i, self.analyzers[i]) for i in plan.host_assisted_idx]
        if not (members or assisted or host_assisted):
            return [results[i] for i in range(len(self.analyzers))]
        table = prune_table_columns(table, plan.specs)
        # decode routing comes last: it classifies the columns that
        # survived pruning, and attaches to the final view
        decode_plan = plan_decode_fastpath(table, plan.specs)
        if decode_plan is not None:
            table = apply_decode_plan(table, decode_plan)
        folded, host_results, device_error = self._run_pass(
            table, members, assisted, host_assisted, plan
        )
        results.update(host_results)  # host outcomes stand on their own
        if device_error is not None:
            # a failed input build fails every analyzer of the shared
            # device program (reference: AnalysisRunner.scala:310-313)
            for i in plan.merge_idx + plan.assisted_idx:
                results[i] = AnalyzerRunResult(self.analyzers[i], error=device_error)
            return [results[i] for i in range(len(self.analyzers))]
        aggs, assisted_states = folded
        for i, analyzer, agg in zip(plan.merge_idx, members, aggs):
            try:
                state = analyzer.state_from_aggregates(agg)
            except Exception as e:  # noqa: BLE001
                results[i] = AnalyzerRunResult(analyzer, error=e)
            else:
                results[i] = AnalyzerRunResult(analyzer, state=state)
        for i, analyzer, state in zip(plan.assisted_idx, assisted, assisted_states):
            results[i] = AnalyzerRunResult(analyzer, state=state)
        return [results[i] for i in range(len(self.analyzers))]

    def _run_pass(self, table: Table, analyzers, assisted, host_assisted, plan: ScanMemberPlan):
        """-> ((folded merge partials, assisted states), host members'
        results, None) or (None, host members' results, the input build
        error that stopped the device program)."""
        runtime.record_pass()
        scan = _BatchScan(self.device, self._controller, analyzers, assisted, host_assisted, plan)
        if getattr(table, "is_streaming", False) and runtime.pipeline_enabled():
            scan.run_pipelined(table.batches(self.batch_size))
        else:
            scan.run_serial(table.batches(self.batch_size))
        host_results = {
            i: AnalyzerRunResult(member, state=scan.host_states.get(i), error=scan.host_errors.get(i))
            for i, member in host_assisted
        }
        if scan.device_error is not None:
            return None, host_results, scan.device_error
        return scan.fold.finish(), host_results, None


@dataclass
class _Prepped:
    """One batch after prep: its host inputs and, for the device program,
    its wire on the device, the copy's event and the wire's layout (or
    the input build error that stopped the program)."""

    batch: Table
    built: HostInputs
    wire: Optional[Dict[str, torch.Tensor]] = None
    copied: Any = None
    layout: Any = None
    error: Optional[BaseException] = None


class _BatchScan:
    """One pass's per-batch loop: `prep` builds a batch's device inputs,
    packs them and copies the wire to the device; `fold_item` launches
    the program on the batch and folds it, the host-only members too.
    The serial loop runs both on the caller; the pipelined loop runs
    `prep` on a stage thread (ops/pipeline.py), with its copies on a CUDA
    stream of its own, and `fold_item` on the caller in batch order. The
    sticky wire dict is written by `prep` alone, in batch order, so both
    loops give the same bits."""

    def __init__(self, device, controller, analyzers, assisted, host_assisted, plan):
        self.device = device
        self.controller = controller
        self.analyzers = analyzers
        self.assisted = assisted
        self.host_assisted = host_assisted
        self.plan = plan
        self.device_keys = sorted(plan.device_keys)
        self.use_device = bool(analyzers or assisted)
        self.sticky: Dict[str, Any] = {}
        self.fold = PipelinedAggFold(analyzers, self.device, assisted)
        self.host_states: Dict[int, Optional[State]] = {}
        self.host_errors: Dict[int, BaseException] = {}
        self.device_error: Optional[BaseException] = None
        # read by the prep stage, so batches in flight stop packing
        self.device_down = threading.Event()
        self.copy_stream = None
        self.batches = 0
        self.rows = 0

    def prep(self, batch: Table) -> _Prepped:
        built = HostInputs(self.plan.specs, batch)
        item = _Prepped(batch, built)
        if not self.use_device or self.device_down.is_set():
            return item
        try:
            items = [(key, built[key]) for key in self.device_keys]
        except NotImplementedError:
            raise
        except Exception as e:  # noqa: BLE001
            item.error = e
            self.device_down.set()
            return item
        host, item.layout = pack_batch_inputs(
            items, runtime.wire_pad_size(batch.num_rows), self.sticky, batch.num_rows,
            pin=self.device.type == "cuda",
        )
        if self.copy_stream is None:
            item.wire = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
            return item
        # the copy on the copy stream, behind an event the consumer's
        # stream waits on; the pinned buffers go back to the host
        # allocator only once the copy recorded on this stream has landed
        with torch.cuda.stream(self.copy_stream):
            item.wire = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
            item.copied = torch.cuda.Event()
            item.copied.record(self.copy_stream)
        return item

    def fold_item(self, item: _Prepped) -> bool:
        """Fold one prepped batch; False once every member has failed."""
        if self.controller is not None:
            self.controller.check(
                where="fused_scan batch", progress={"batches": self.batches, "rows": self.rows}
            )
        device_live = self.use_device and self.device_error is None
        host_live = len(self.host_errors) < len(self.host_assisted)
        if not device_live and not host_live:
            return False
        if device_live:
            if item.error is not None:
                self.device_error = item.error
                self.device_down.set()
            elif item.wire is not None:
                wire = item.wire
                if item.copied is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(item.copied)
                    for tensor in wire.values():
                        # the copy stream's allocator must not hand these
                        # blocks out again while this stream still reads them
                        tensor.record_stream(stream)
                program = get_fused_fn(self.analyzers, item.layout, self.device, self.assisted)
                runtime.record_launch()
                # assisted members finish against the batch's host inputs
                self.fold.submit(
                    *program(wire, item.batch.num_rows), item.built if self.assisted else None
                )
        fold_host_batch(
            item.built, self.host_assisted, self.plan.host_keys, self.host_states, self.host_errors
        )
        self.batches += 1
        self.rows += item.batch.num_rows
        return True

    def run_serial(self, batches) -> None:
        with contextlib.closing(iter(batches)) as it:
            for batch in it:
                if not self.fold_item(self.prep(batch)):
                    break  # every member has failed: stop scanning

    def run_pipelined(self, batches) -> None:
        if self.device.type == "cuda" and self.use_device:
            self.copy_stream = torch.cuda.Stream(device=self.device)
        items = pipeline.staged(batches, self.prep, name="prep")
        with contextlib.closing(items):
            for item in items:
                if not self.fold_item(item):
                    break
