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

reference: runners/AnalysisRunner.scala:279-326 (all scan-shareable
analyzers in one `df.agg(...)`); the JAX counterpart is
deequ_tpu/ops/fused.py.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
from deequ_tpu_torch.analyzers.states import State
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import runtime

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
    table. `device` is where the pass runs: CUDA unless the caller asks
    for the CPU."""

    def __init__(
        self,
        analyzers: Sequence[ScanShareableAnalyzer],
        batch_size: Optional[int] = None,
        device: runtime.DeviceLike = None,
    ):
        self.analyzers = list(analyzers)
        self.batch_size = batch_size if batch_size is not None else DEFAULT_BATCH_SIZE
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {self.batch_size}")
        self.device = runtime.resolve_device(device)

    def run(self, table: Table) -> List[AnalyzerRunResult]:
        return self._run_single(table)

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
        device_keys = sorted(plan.device_keys)
        use_device = bool(analyzers or assisted)
        pin = self.device.type == "cuda"
        sticky: Dict[str, Any] = {}
        fold = PipelinedAggFold(analyzers, self.device, assisted)
        host_states: Dict[int, Optional[State]] = {}
        host_errors: Dict[int, BaseException] = {}
        device_error: Optional[BaseException] = None
        for batch in table.batches(self.batch_size):
            built = HostInputs(plan.specs, batch)
            if use_device and device_error is None:
                try:
                    items = [(key, built[key]) for key in device_keys]
                except NotImplementedError:
                    raise
                except Exception as e:  # noqa: BLE001
                    device_error = e
                else:
                    host, layout = pack_batch_inputs(
                        items, runtime.wire_pad_size(batch.num_rows), sticky,
                        batch.num_rows, pin=pin,
                    )
                    wire = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
                    program = get_fused_fn(analyzers, layout, self.device, assisted)
                    # assisted members finish against the batch's host inputs
                    fold.submit(*program(wire, batch.num_rows), built if assisted else None)
            fold_host_batch(built, host_assisted, plan.host_keys, host_states, host_errors)
            if (device_error is not None or not use_device) and len(host_errors) == len(host_assisted):
                break  # every member has failed: stop scanning
        host_results = {
            i: AnalyzerRunResult(member, state=host_states.get(i), error=host_errors.get(i))
            for i, member in host_assisted
        }
        if device_error is not None:
            return None, host_results, device_error
        return fold.finish(), host_results, None
