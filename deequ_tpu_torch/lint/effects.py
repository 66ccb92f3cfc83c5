"""Static effect model: what a planned scan READS and SHIPS, per input
key — the abstract-interpretation layer under the cost analyzer
(lint/cost.py).

The fused engine's wire format (ops/fused.pack_batch_inputs) is fully
determined by the input-spec key and the schema:

  * `num:{col}`      -> float64 values
  * `valid:{col}`    -> bool mask; all-true masks (non-nullable column)
                        are NOT transferred (synthesized from the row
                        count), otherwise bitpacked to 1 bit/row
  * `where:<all>`    -> all-true, never transferred
  * `where:`/`pred:`/`prednn:`/`match:` -> bool masks, 1 bit/row
  * `dtclass:{col}`  -> int8 class codes, 1 byte/row
  * `hll:{col}`      -> packed hash codes (15 bits), narrowed to int16

The port's copy of deequ_tpu/lint/effects.py, over the port's wire
(ops/fused.py:pack_batch_inputs). Placement, member partitioning, and family grouping come from the pure
planner in ops/fused.py (`plan_scan_members`/`plan_family_jobs`); this
module adds the byte model and the per-analyzer effect summary. Nothing
here ever touches data — schema only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.data.table import ColumnType
from deequ_tpu_torch.lint.schema import SchemaInfo

# Host-memory bytes per row a scan reads per column, by type. STRING and
# TIMESTAMP are nominal (object pointers / us ticks) — good enough for
# relative pass costs, which is all the report claims for them.
COLUMN_READ_BYTES: Dict[ColumnType, int] = {
    ColumnType.STRING: 16,
    ColumnType.LONG: 8,
    ColumnType.DOUBLE: 8,
    ColumnType.BOOLEAN: 1,
    ColumnType.TIMESTAMP: 8,
    ColumnType.DECIMAL: 8,
}

#: input-key prefixes whose wire payload is a bitpacked bool mask
_MASK_PREFIXES = ("where:", "pred:", "prednn:", "match:")


def prednn_elided(expression: str, schema: SchemaInfo) -> bool:
    """True when a `prednn:` (predicate-not-null) mask is provably
    all-true — the typechecker proves the predicate never yields NULL,
    so the runtime's all-true elision is a static fact, not a data
    accident. The typechecker's contract (never report non-nullable for
    an expression that can be NULL) makes this the safe direction."""
    try:
        from deequ_tpu_torch.lint.typecheck import analyze_expression

        typed, _diags = analyze_expression(expression, schema)
        return typed is not None and not typed.nullable
    except Exception:  # noqa: BLE001 — fall back to "transferred"
        return False


def column_read_bytes(schema: SchemaInfo, column: str) -> float:
    field = schema.field(column)
    if field is None:
        return 8.0
    return float(COLUMN_READ_BYTES.get(field.ctype, 8))


def key_wire_bytes_per_row(
    key: str, schema: SchemaInfo, compute_itemsize: int = 8
) -> float:
    """Device-wire bytes per row one input key costs under the fused
    engine's packed format; 0.0 for keys that are never transferred."""
    if key == "where:<all>":
        return 0.0
    if key.startswith("num:"):
        return float(compute_itemsize)
    if key.startswith("valid:"):
        field = schema.field(key[len("valid:"):])
        if field is not None and not field.nullable:
            return 0.0  # all-true mask: synthesized on device
        return 1.0 / 8.0
    if key.startswith("prednn:") and prednn_elided(key[len("prednn:"):], schema):
        return 0.0  # provably never-NULL predicate: all-true, elided
    if key.startswith(_MASK_PREFIXES):
        return 1.0 / 8.0
    if key.startswith("dtclass:"):
        return 1.0
    if key.startswith("hll:"):
        return 2.0
    return 8.0  # unknown key: assume a full-width value column


def key_read_columns(key: str, spec: Optional[Any] = None) -> Tuple[str, ...]:
    """Columns a key's build reads, from its InputSpec when declared."""
    columns = getattr(spec, "columns", None)
    if columns:
        return tuple(columns)
    return ()


@dataclass(frozen=True)
class AnalyzerEffect:
    """One analyzer's static effect inside a scan pass."""

    analyzer: str  # repr, stable across plan/runtime
    name: str
    #: 'merge' | 'assisted' | 'host' | 'host-assisted' | 'error'
    role: str
    input_keys: Tuple[str, ...]
    columns: Tuple[str, ...]  # deduplicated columns the inputs read

    @property
    def on_device(self) -> bool:
        return self.role in ("merge", "assisted")


def scan_effects(
    analyzers: Sequence[Any],
    mode: Optional[str] = None,
) -> Tuple[Any, List[AnalyzerEffect]]:
    """Run the pure planner and summarize each member's effect. `mode`
    defaults to `runtime.placement_mode()`, a CUDA run's placement.

    Returns (ScanMemberPlan, [AnalyzerEffect]) — the plan object is the
    same one the runtime consumes, so downstream cost predictions cannot
    drift from execution."""
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.ops.fused import plan_scan_members

    plan = plan_scan_members(analyzers, mode=mode or runtime.placement_mode())
    role_of: Dict[int, str] = {}
    for i in plan.merge_idx:
        role_of[i] = "merge"
    for i in plan.assisted_idx:
        role_of[i] = "assisted"
    for i in plan.host_idx:
        role_of[i] = "host"
    for i in plan.host_assisted_idx:
        role_of[i] = "host-assisted"
    for i in plan.spec_errors:
        role_of[i] = "error"

    key_columns = {
        key: key_read_columns(key, spec) for key, spec in plan.specs.items()
    }
    effects: List[AnalyzerEffect] = []
    for i, analyzer in enumerate(analyzers):
        role = role_of.get(i, "error")
        if role == "error":
            keys: Tuple[str, ...] = ()
        elif i in plan.host_keys:
            keys = tuple(plan.host_keys[i])
        else:
            try:
                keys = tuple(s.key for s in analyzer.input_specs())
            except Exception:  # noqa: BLE001
                keys = ()
        columns: List[str] = []
        for key in keys:
            for col in key_columns.get(key, ()):
                if col not in columns:
                    columns.append(col)
        effects.append(
            AnalyzerEffect(
                analyzer=repr(analyzer),
                name=str(getattr(analyzer, "name", type(analyzer).__name__)),
                role=role,
                input_keys=keys,
                columns=tuple(columns),
            )
        )
    return plan, effects


def pass_read_bytes_per_row(
    columns: Sequence[str], schema: SchemaInfo
) -> float:
    return float(sum(column_read_bytes(schema, c) for c in columns))


def pass_wire_bytes_per_row(
    device_keys: Sequence[str], schema: SchemaInfo, compute_itemsize: int = 8
) -> float:
    return float(
        sum(
            key_wire_bytes_per_row(k, schema, compute_itemsize)
            for k in device_keys
        )
    )


def analyzer_read_columns(analyzer: Any) -> Tuple[str, ...]:
    """Columns an analyzer reads, from its input specs (spec-declared
    read sets) with a fallback to the common column attributes."""
    columns: List[str] = []
    try:
        for spec in analyzer.input_specs():
            for col in getattr(spec, "columns", None) or ():
                if col not in columns:
                    columns.append(col)
        return tuple(columns)
    except Exception:  # noqa: BLE001
        pass
    for attr in ("column", "first_column", "second_column"):
        value = getattr(analyzer, attr, None)
        if isinstance(value, str) and value not in columns:
            columns.append(value)
    multi = getattr(analyzer, "columns", None)
    if isinstance(multi, (list, tuple)):
        for value in multi:
            if isinstance(value, str) and value not in columns:
                columns.append(value)
    return tuple(columns)
