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

reference: runners/AnalysisRunner.scala:279-326 (all scan-shareable
analyzers in one `df.agg(...)`); the JAX counterpart is
deequ_tpu/ops/fused.py.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
    whose spec construction fails sits in `spec_errors` and fails alone."""

    merge_idx: List[int] = field(default_factory=list)
    specs: Dict[str, Any] = field(default_factory=dict)
    spec_errors: Dict[int, BaseException] = field(default_factory=dict)


def plan_scan_members(analyzers: Sequence[Any], mode: Optional[str] = None) -> ScanMemberPlan:
    """Partition a scan's members — pure and data-free. Only the
    ``device`` placement is ported: every member folds in the fused
    device pass."""
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
        plan.merge_idx.append(i)
        for spec in analyzer_specs:
            plan.specs.setdefault(spec.key, spec)
    return plan


def plan_shape_key(analyzers: Sequence[ScanShareableAnalyzer], layout: Any) -> Tuple[Any, ...]:
    """What decides a batch's device program: the analyzers (by repr, in
    pass order) and the wire layout."""
    return (tuple(repr(a) for a in analyzers), layout)


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

    def __init__(self, analyzers: Sequence[ScanShareableAnalyzer], layout, device: torch.device):
        self.analyzers = list(analyzers)
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
        """-> (flat float64 partials on the device, their layout)."""
        inputs = self.unpack(wire, num_rows)
        return pack_outputs([a.device_reduce(inputs) for a in self.analyzers], self.device)


def get_fused_fn(
    analyzers: Sequence[ScanShareableAnalyzer], layout, device: torch.device
) -> FusedProgram:
    key = (plan_shape_key(analyzers, layout), str(device))
    with _PLAN_CACHE_LOCK:
        program = _PLAN_CACHE.get(key)
        if program is None:
            program = FusedProgram(analyzers, layout, device)
            _PLAN_CACHE[key] = program
            while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
                _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    return program


def pack_outputs(outs: Sequence[Dict[str, torch.Tensor]], device: torch.device):
    """Every partial as float64 in ONE flat device tensor (registers,
    counts and flags are all exact in float64) -> (flat, meta); `meta`
    lists (analyzer position, key, shape) in pack order."""
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
    each analyzer's `merge_agg`, in batch order."""

    def __init__(self, analyzers: Sequence[ScanShareableAnalyzer], device: torch.device):
        self.analyzers = list(analyzers)
        self.device = device
        self._total: Optional[List[Dict[str, np.ndarray]]] = None
        self._pending = None

    def submit(self, flat: torch.Tensor, meta) -> None:
        if self.device.type == "cuda":
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(torch.cuda.current_stream(self.device))
        else:
            host, landed = flat, None
        if self._pending is not None:
            self._fold(self._pending)
        self._pending = (host, landed, meta)

    def _fold(self, pending) -> None:
        host, landed, meta = pending
        if landed is not None:
            landed.synchronize()
        batch_aggs = unpack_outputs(host.numpy(), meta, len(self.analyzers))
        if self._total is None:
            self._total = batch_aggs
        else:
            self._total = [
                a.merge_agg(t, b)
                for a, t, b in zip(self.analyzers, self._total, batch_aggs)
            ]

    def finish(self) -> List[Dict[str, np.ndarray]]:
        if self._pending is not None:
            self._fold(self._pending)
            self._pending = None
        return self._total if self._total is not None else []


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
        if members:
            aggs, build_error = self._run_pass(table, members, plan.specs)
            for pos, (i, analyzer) in enumerate(zip(plan.merge_idx, members)):
                if build_error is not None:
                    # a failed input build fails every analyzer of the
                    # shared program (reference: AnalysisRunner.scala:310-313)
                    results[i] = AnalyzerRunResult(analyzer, error=build_error)
                    continue
                try:
                    state = analyzer.state_from_aggregates(aggs[pos])
                except Exception as e:  # noqa: BLE001
                    results[i] = AnalyzerRunResult(analyzer, error=e)
                else:
                    results[i] = AnalyzerRunResult(analyzer, state=state)
        return [results[i] for i in range(len(self.analyzers))]

    def _run_pass(self, table: Table, analyzers, specs):
        """-> (per-member folded partials, None) or (None, the input build
        error that stopped the pass)."""
        keys = sorted(specs)
        pin = self.device.type == "cuda"
        sticky: Dict[str, Any] = {}
        fold = PipelinedAggFold(analyzers, self.device)
        for batch in table.batches(self.batch_size):
            built = []
            for key in keys:
                try:
                    built.append((key, np.asarray(specs[key].build(batch))))
                except NotImplementedError:
                    raise
                except Exception as e:  # noqa: BLE001
                    return None, e
            host, layout = pack_batch_inputs(
                built, runtime.wire_pad_size(batch.num_rows), sticky,
                batch.num_rows, pin=pin,
            )
            wire = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
            program = get_fused_fn(analyzers, layout, self.device)
            fold.submit(*program(wire, batch.num_rows))
        return fold.finish(), None
