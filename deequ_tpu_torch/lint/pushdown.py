"""Row-group pruning: a three-valued abstract interpreter over parquet
row-group statistics.

Per (where-predicate, row group) the interpreter proves one of

* ``all-false`` — no row in the group can satisfy the predicate: if
  EVERY member of the fused pass filters with an all-false where, the
  group is skipped before decode (it never touches Arrow),
* ``all-true``  — every row satisfies the predicate: the runtime swaps
  the filter's input spec for a constant mask, so the filter columns
  need not be decoded and the mask elides on the wire,
* ``unknown``   — decode and filter at runtime, exactly as without
  pruning.

The domain is the interval lattice shared with DQ204 (lint/interval.py)
applied to the DNF expansion from lint/fold.py: a clause (AND of atoms)
is all-false when any atom is, all-true when all atoms are; a predicate
(OR of clauses) is all-true when any clause is, all-false when all are.

Soundness is anchored to ENGINE semantics, not SQL's:

* Comparisons evaluate FALSE on NULL rows (the evaluator masks
  ``& ~null``), so an all-null group falsifies every comparison.
* ``Table.from_arrow`` folds NaN float values into the null mask at
  decode. Parquet statistics ignore NaN, so for DOUBLE/DECIMAL columns
  the file's null_count is only a LOWER bound on runtime nulls: no
  all-true verdict may rest on "null_count == 0" for those types, and
  no comparison over them ever proves all-true (a hidden NaN row would
  evaluate false). All-false verdicts stay sound: hidden NaN rows are
  runtime-null and evaluate false anyway.
* String min/max are never consulted (writers may truncate them); only
  null_count reasoning applies to STRING columns.
* min/max that fail float conversion or are themselves NaN count as
  absent.

Purity contract: this module never imports pyarrow or opens files.
Statistics arrive as plain ``RowGroupStats`` records;
``ParquetSource.row_group_stats()`` is the single reader. The port's copy
of deequ_tpu/lint/pushdown.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Set, Tuple

from deequ_tpu_torch.data.expr import (
    Between,
    Bin,
    Col,
    InList,
    IsNull,
    Node,
    Un,
    parse,
)
from deequ_tpu_torch.data.table import ColumnType
from deequ_tpu_torch.lint.fold import Atom, Branch, cmp_atom, const_fold, dnf_branches
from deequ_tpu_torch.lint.interval import Interval
from deequ_tpu_torch.lint.schema import SchemaInfo

ALL_TRUE = "all-true"
ALL_FALSE = "all-false"
UNKNOWN = "unknown"

#: parquet null_count equals the engine's runtime null count only for
#: these types — DOUBLE/DECIMAL fold NaN into the null mask at decode
#: (see module docstring), TIMESTAMP rides the conservative side.
_EXACT_NULLS = frozenset(
    (ColumnType.LONG, ColumnType.STRING, ColumnType.BOOLEAN)
)

#: min/max statistics are consulted for these types only.
_RANGE_TYPES = frozenset((ColumnType.LONG, ColumnType.DOUBLE))

_CMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge")


# -- statistics records ------------------------------------------------------


@dataclass(frozen=True)
class ColumnStats:
    """Raw per-column-chunk statistics. None = the writer did not record
    the stat (or recorded it unusably); absence degrades verdicts to
    unknown, never to wrong.

    The layout fields (physical_type onward) carry the footer metadata
    the C reader's and the encoded fold's verdicts key off
    (ops/fused.py); they default to None, and absence disqualifies a
    chunk from those paths, never mis-qualifies it."""

    min_value: Optional[object] = None
    max_value: Optional[object] = None
    null_count: Optional[int] = None
    physical_type: Optional[str] = None
    codec: Optional[str] = None
    encodings: Optional[Tuple[str, ...]] = None
    chunk_offset: Optional[int] = None
    chunk_bytes: Optional[int] = None
    num_values: Optional[int] = None
    max_def_level: Optional[int] = None
    max_rep_level: Optional[int] = None
    #: page placement: a chunk with no dictionary page before its data
    #: pages cannot be all-dictionary-coded
    #: (ops/fused.py:classify_encfold_columns)
    data_page_offset: Optional[int] = None
    dictionary_page_offset: Optional[int] = None


@dataclass(frozen=True)
class RowGroupStats:
    index: int
    num_rows: int
    columns: Mapping[str, ColumnStats]


def types_from_schema(schema: SchemaInfo) -> Dict[str, ColumnType]:
    return {f.name: f.ctype for f in schema.fields}


def _bounds(stats: ColumnStats) -> Optional[Tuple[float, float]]:
    """Usable numeric [min, max] of a chunk, or None. NaN bounds (legacy
    writers stored them for NaN-polluted columns) count as absent."""
    if stats.min_value is None or stats.max_value is None:
        return None
    try:
        lo = float(stats.min_value)  # type: ignore[arg-type]
        hi = float(stats.max_value)  # type: ignore[arg-type]
    except (TypeError, ValueError):
        return None
    if math.isnan(lo) or math.isnan(hi):
        return None
    return lo, hi


# -- atom/clause/predicate verdicts ------------------------------------------


def _atom_verdict(
    atom: Atom,
    group: RowGroupStats,
    types: Mapping[str, ColumnType],
) -> str:
    tag = atom[0]
    if tag == "const":
        return ALL_TRUE if atom[1] else ALL_FALSE
    if tag == "opaque":
        return UNKNOWN

    if tag == "null":
        _, col, must_null = atom
        stats = group.columns.get(col)
        ctype = types.get(col)
        if stats is None or stats.null_count is None or ctype is None:
            return UNKNOWN
        nulls = int(stats.null_count)
        rows = group.num_rows
        exact = ctype in _EXACT_NULLS
        if must_null:
            if nulls >= rows:
                return ALL_TRUE  # runtime nulls ⊇ parquet nulls
            if nulls == 0 and exact:
                return ALL_FALSE
            return UNKNOWN
        if nulls >= rows:
            return ALL_FALSE
        if nulls == 0 and exact:
            return ALL_TRUE
        return UNKNOWN

    if tag == "cmp":
        _, col, op, v = atom
        stats = group.columns.get(col)
        ctype = types.get(col)
        rows = group.num_rows
        if rows == 0:
            # the scan materializes no row from an empty group; treat as
            # all-false so it prunes
            return ALL_FALSE
        if stats is None or ctype is None:
            return UNKNOWN
        if stats.null_count is not None and int(stats.null_count) >= rows:
            # comparisons are FALSE on null rows — any type
            return ALL_FALSE
        if isinstance(v, str) or ctype not in _RANGE_TYPES:
            return UNKNOWN
        bounds = _bounds(stats)
        if bounds is None:
            return UNKNOWN
        value = float(v)
        domain = Interval.closed(bounds[0], bounds[1])
        no_nulls = (
            ctype is ColumnType.LONG and stats.null_count == 0
        )  # DOUBLE never qualifies: hidden NaN ⇒ runtime null ⇒ false
        if op == "ne":
            if domain.is_point and domain.lo == value:
                return ALL_FALSE
            if no_nulls and not domain.contains_point(value):
                return ALL_TRUE
            return UNKNOWN
        pred = Interval.from_cmp(op, value)
        if domain.disjoint(pred):
            return ALL_FALSE
        if no_nulls and pred.contains(domain):
            return ALL_TRUE
        return UNKNOWN

    return UNKNOWN


def _clause_verdict(
    branch: Branch,
    group: RowGroupStats,
    types: Mapping[str, ColumnType],
) -> str:
    saw_unknown = False
    for atom in branch:
        verdict = _atom_verdict(atom, group, types)
        if verdict == ALL_FALSE:
            return ALL_FALSE
        if verdict == UNKNOWN:
            saw_unknown = True
    return UNKNOWN if saw_unknown else ALL_TRUE


def predicate_verdict(
    branches: Sequence[Branch],
    group: RowGroupStats,
    types: Mapping[str, ColumnType],
) -> str:
    saw_unknown = False
    for branch in branches:
        verdict = _clause_verdict(branch, group, types)
        if verdict == ALL_TRUE:
            return ALL_TRUE
        if verdict == UNKNOWN:
            saw_unknown = True
    return UNKNOWN if saw_unknown else ALL_FALSE


# -- pushdown eligibility (DQ310) --------------------------------------------


def _first_blocker(
    node: Node, types: Mapping[str, ColumnType]
) -> Optional[Tuple[Node, str]]:
    """First subexpression with no statistics form, with a reason — the
    DQ310 caret anchors on its source span. None = every leaf of the
    predicate maps to a stats-decidable atom."""
    ok, _ = const_fold(node)
    if ok:
        return None
    if isinstance(node, Un) and node.op == "not":
        return _first_blocker(node.x, types)
    if isinstance(node, Bin) and node.op in ("and", "or"):
        return _first_blocker(node.l, types) or _first_blocker(node.r, types)
    if isinstance(node, Bin) and node.op in _CMP_OPS:
        atom = cmp_atom(node)
        if atom is None:
            return node, "not a column-vs-literal comparison"
        return _col_cmp_blocker(node, atom[1], types)
    if isinstance(node, IsNull):
        if isinstance(node.x, Col):
            return None
        return node, "IS NULL over a computed expression"
    if isinstance(node, Between):
        if not isinstance(node.x, Col):
            return node, "BETWEEN over a computed expression"
        for bound in (node.lo, node.hi):
            ok, v = const_fold(bound)
            if not ok or v is None or isinstance(v, bool):
                return node, "non-literal BETWEEN bound"
        return _col_cmp_blocker(node, node.x.name, types)
    if isinstance(node, InList):
        if not isinstance(node.x, Col):
            return node, "IN over a computed expression"
        for item in node.items:
            ok, v = const_fold(item)
            if not ok or v is None or isinstance(v, bool):
                return node, "non-literal IN item"
            if isinstance(v, str):
                return (
                    node,
                    "string min/max statistics are untrustworthy "
                    "(writers may truncate them)",
                )
        return _col_cmp_blocker(node, node.x.name, types)
    return node, "expression has no statistics form"


def _col_cmp_blocker(
    node: Node, col: str, types: Mapping[str, ColumnType]
) -> Optional[Tuple[Node, str]]:
    ctype = types.get(col)
    if ctype is None:
        return node, f"column '{col}' not in the scanned schema"
    if ctype is ColumnType.STRING:
        return (
            node,
            "string min/max statistics are untrustworthy "
            "(writers may truncate them)",
        )
    if ctype not in _RANGE_TYPES:
        return node, f"{ctype.name} columns carry no usable min/max statistics"
    return None


def _atom_columns(branches: Sequence[Branch]) -> Set[str]:
    cols: Set[str] = set()
    for branch in branches:
        for atom in branch:
            if atom[0] in ("cmp", "null"):
                cols.add(atom[1])
    return cols


# -- prune plan --------------------------------------------------------------


@dataclass(frozen=True)
class PredicatePrune:
    """One distinct where text's static outcome across all row groups."""

    where: str
    eligible: bool
    reason: Optional[str]
    span: Optional[Tuple[int, int]]
    verdicts: Tuple[str, ...]  # aligned with the file's row-group order


def _slices(rows: int, size: int) -> List[int]:
    return [min(size, rows - start) for start in range(0, rows, size)]


@dataclass(frozen=True)
class PrunePlan:
    """Static decision for one fused scan over one parquet file."""

    group_rows: Tuple[int, ...]
    predicates: Tuple[PredicatePrune, ...]
    #: every fused member filters (no bare where=None member) — only then
    #: may any group be skipped
    prunable: bool
    skip: FrozenSet[int]
    #: the statistics proved every group all-false for every predicate.
    #: One sentinel group still decodes (see build_prune_plan) so the
    #: filtered-empty result stays bit-identical to the unpruned scan;
    #: DQ311 reports the proof itself.
    proven_empty: bool = False

    # -- aggregates ----------------------------------------------------------

    @property
    def total_groups(self) -> int:
        return len(self.group_rows)

    @property
    def skipped_groups(self) -> int:
        return len(self.skip)

    @property
    def decoded_groups(self) -> int:
        return self.total_groups - self.skipped_groups

    @property
    def skipped_rows(self) -> int:
        return sum(self.group_rows[g] for g in self.skip)

    @property
    def decoded_rows(self) -> int:
        return sum(self.group_rows) - self.skipped_rows

    def elided_wheres(self) -> Tuple[str, ...]:
        """Where texts proven all-true on every SURVIVING group: their
        mask spec can be swapped for a constant (filter columns never
        decode, the mask elides on the wire)."""
        surviving = [
            g for g in range(self.total_groups) if g not in self.skip
        ]
        if not surviving:
            return ()
        return tuple(
            p.where
            for p in self.predicates
            if p.eligible
            and all(p.verdicts[g] == ALL_TRUE for g in surviving)
        )

    # -- decode replay -------------------------------------------------------

    def predicted_batch_rows(
        self, batch_size: int, *, pruned: bool = True
    ) -> Tuple[int, ...]:
        """Per-batch row counts of ParquetSource._iter_tables over the
        (optionally pruned) groups — an exact replay of its tiny-group
        coalescing, so EXPLAIN's batch count and first-batch bytes match
        observed traces. Empty result = the zero-batch case; the stream
        then yields its single empty fallback batch."""
        size = max(1, int(batch_size))
        tiny = max(1, size // 4)
        out: List[int] = []
        pending = 0
        for g, rows in enumerate(self.group_rows):
            if pruned and g in self.skip:
                continue
            if rows < tiny:
                pending += rows
                if pending < size:
                    continue
                merged, pending = pending, 0
                out.extend(_slices(merged, size))
            else:
                if pending:
                    out.extend(_slices(pending, size))
                    pending = 0
                out.extend(_slices(rows, size))
        if pending:
            out.extend(_slices(pending, size))
        return tuple(out)


def build_prune_plan(
    wheres: Sequence[Optional[str]],
    groups: Sequence[RowGroupStats],
    types: Mapping[str, ColumnType],
) -> PrunePlan:
    """Evaluate every distinct where text over every row group.

    `wheres` is one entry PER FUSED MEMBER (None = the member scans
    unfiltered). A group is skipped only when every member filters and
    every distinct predicate is proven all-false on it — an unfiltered
    member reads every group, so nothing may be skipped then.
    """
    prunable = len(wheres) > 0 and all(w is not None for w in wheres)
    texts: List[str] = []
    seen: Set[str] = set()
    for w in wheres:
        if w is not None and w not in seen:
            seen.add(w)
            texts.append(w)

    n = len(groups)
    predicates: List[PredicatePrune] = []
    for text in texts:
        predicates.append(_analyze_predicate(text, groups, types))

    skip: FrozenSet[int] = frozenset(
        g
        for g in range(n)
        if prunable
        and predicates
        and all(p.verdicts[g] == ALL_FALSE for p in predicates)
    )
    proven_empty = n > 0 and len(skip) == n
    if proven_empty:
        # never skip EVERYTHING: a scan that yields no batch falls back
        # to one empty batch, and analyzer states from a 0-row input are
        # not the same as states from real rows that all fail the filter
        # (empty-state vs 0-count). Decoding one sentinel group — the
        # cheapest — keeps the result bit-identical to the unpruned scan
        # while still skipping n-1 groups; DQ311 surfaces the proof.
        keep = min(range(n), key=lambda g: (groups[g].num_rows, g))
        skip = frozenset(g for g in skip if g != keep)
    return PrunePlan(
        group_rows=tuple(int(g.num_rows) for g in groups),
        predicates=tuple(predicates),
        prunable=prunable,
        skip=skip,
        proven_empty=proven_empty,
    )


def _analyze_predicate(
    text: str,
    groups: Sequence[RowGroupStats],
    types: Mapping[str, ColumnType],
) -> PredicatePrune:
    unknown_everywhere = (UNKNOWN,) * len(groups)
    try:
        ast = parse(text)
    except Exception:  # noqa: BLE001 — the runtime surfaces parse errors
        return PredicatePrune(
            where=text,
            eligible=False,
            reason="predicate does not parse",
            span=None,
            verdicts=unknown_everywhere,
        )

    branches = dnf_branches(ast)
    if branches is None or not branches:
        return PredicatePrune(
            where=text,
            eligible=False,
            reason="predicate too complex (DNF branch cap)",
            span=None,
            verdicts=unknown_everywhere,
        )

    eligible = True
    reason: Optional[str] = None
    span: Optional[Tuple[int, int]] = None
    blocker = _first_blocker(ast, types)
    if blocker is not None:
        eligible = False
        reason = blocker[1]
        span = blocker[0].span

    verdicts = tuple(
        predicate_verdict(branches, group, types) for group in groups
    )

    if eligible and groups and all(v == UNKNOWN for v in verdicts):
        # structurally fine but undecidable everywhere — when that is
        # because the file carries no statistics at all for a referenced
        # column, say so (the other cause, genuinely overlapping ranges,
        # is not a defect and stays silent)
        for col in sorted(_atom_columns(branches)):
            if all(
                group.columns.get(col) is None
                or (
                    _bounds(group.columns[col]) is None
                    and group.columns[col].null_count is None
                )
                for group in groups
            ):
                eligible = False
                reason = f"no statistics recorded for column '{col}'"
                break

    return PredicatePrune(
        where=text,
        eligible=eligible,
        reason=reason,
        span=span,
        verdicts=verdicts,
    )


__all__ = [
    "ALL_TRUE",
    "ALL_FALSE",
    "UNKNOWN",
    "ColumnStats",
    "RowGroupStats",
    "PredicatePrune",
    "PrunePlan",
    "build_prune_plan",
    "predicate_verdict",
    "types_from_schema",
]
