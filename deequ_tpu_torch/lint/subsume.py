"""Plan-subsumption prover: statically prove "suite A ⊆ scan S".

Given two validated plans over the same dataset fingerprint, decide
whether every metric suite A needs can be read off the folded states of
a (superset) fused scan S — without scanning a row. The verdict is one
of

* ``CONTAINED`` — every analyzer in A appears in S verbatim (analyzer
  identity is (type, repr), the engine's own equality), and the plan
  environments agree component-wise. S's folded per-family states fan
  back out to A bit-identically over the state semigroup.
* ``CONTAINED_WITH_RESIDUAL`` — as above, but at least one obligation
  matched up to the family-kernel equivalence: the same analyzer modulo
  its ``where`` spelling, with the two predicates proven EQUIVALENT by
  mutual three-valued implication over the schema (the same
  NaN/NULL-sound Kleene semantics as lint/pushdown.py — comparisons
  evaluate FALSE on NULL rows, and NaN folds into the null mask at
  decode). The states are still exact; only the (where, cap) family
  bucket spelling differs, so the proof carries the residual.
* ``INCOMPARABLE`` — any unmatched analyzer, any unprovable predicate
  implication, or ANY plan-environment component mismatch
  (placement / compute dtype / batch size / batch rows / fold
  variant). Signature components are never silently merged: a
  fold-variant or dtype mismatch changes the fold arithmetic, so the
  scan's states are not A's states even when the analyzer sets agree.

One-way implication (A's predicate implied by S's but not conversely)
is NEVER containment: a state folded under a strictly weaker predicate
covers a superset of rows and cannot be narrowed after the fact. The
prover records the one-way fact only as a fall-off detail for the
DQ322 diagnostic.

The proof object is machine-checkable: ``SubsumptionProof.pin`` takes
the reprs of the analyzers that actually executed (from the traced run
or the resulting metric map) and returns drift counters that must all
be zero for the proof to be pinned against execution.

Purity contract (enforced by the SUBSUME rule in tools/lint.py): this
module imports only the expression AST and the lint lattice — never
jax, pyarrow, numpy, pandas, nor the service/ops/runner layers — and
opens no files. Callers construct ``PlanEnv`` from live runtime knobs;
the prover itself only compares the components it is handed.

The port's copy of deequ_tpu/lint/subsume.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.data.expr import (
    Bin,
    ExpressionParseError,
    Node,
    Un,
    parse,
)
from deequ_tpu_torch.lint.fold import satisfiability
from deequ_tpu_torch.lint.schema import SchemaInfo

CONTAINED = "CONTAINED"
CONTAINED_WITH_RESIDUAL = "CONTAINED_WITH_RESIDUAL"
INCOMPARABLE = "INCOMPARABLE"

#: obligation kinds
EXACT = "exact"
EQUIVALENT_WHERE = "equivalent-where"
UNMATCHED = "unmatched"


@dataclass(frozen=True)
class PlanEnv:
    """The plan-signature components that change fold arithmetic (the
    same ones ``repository.states.plan_signature`` hashes). Two plans
    are only comparable when every component agrees — the prover treats
    any mismatch as INCOMPARABLE, never as mergeable."""

    placement: str = ""
    compute_dtype: str = ""
    batch_size: Optional[int] = None
    batch_rows: Optional[int] = None
    fold_variant: str = ""

    def components(self) -> Dict[str, Any]:
        return {
            "placement": self.placement,
            "compute_dtype": self.compute_dtype,
            "batch_size": self.batch_size,
            "batch_rows": self.batch_rows,
            "fold_variant": self.fold_variant,
        }

    def mismatches(self, other: "PlanEnv") -> List[str]:
        """Component-wise differences, rendered for the proof object."""
        out: List[str] = []
        mine, theirs = self.components(), other.components()
        for name in mine:
            if mine[name] != theirs[name]:
                out.append(f"{name}: {mine[name]!r} != {theirs[name]!r}")
        return out


@dataclass(frozen=True)
class Obligation:
    """One analyzer A needs, and how (whether) the scan discharges it."""

    analyzer: str  # repr of A's analyzer (the engine's identity)
    kind: str  # exact | equivalent-where | unmatched
    target: Optional[str] = None  # repr of the covering scan analyzer
    detail: str = ""
    # A's where text, for the DQ322 caret on the offending predicate
    where: Optional[str] = None

    @property
    def satisfied(self) -> bool:
        return self.kind in (EXACT, EQUIVALENT_WHERE)


@dataclass(frozen=True)
class SubsumptionProof:
    """The machine-checkable containment proof for one (A, S) pair."""

    verdict: str
    obligations: Tuple[Obligation, ...] = ()
    env_mismatches: Tuple[str, ...] = ()

    @property
    def contained(self) -> bool:
        return self.verdict in (CONTAINED, CONTAINED_WITH_RESIDUAL)

    def summary(self) -> str:
        """One line for EXPLAIN's ``sharing:`` rendering."""
        n = len(self.obligations)
        exact = sum(1 for o in self.obligations if o.kind == EXACT)
        equiv = sum(1 for o in self.obligations if o.kind == EQUIVALENT_WHERE)
        if self.env_mismatches:
            return (
                f"{self.verdict}: plan environments differ "
                f"({'; '.join(self.env_mismatches)})"
            )
        line = f"{self.verdict}: {exact}/{n} obligation(s) exact"
        if equiv:
            line += f", {equiv} equivalent-where"
        missing = [o for o in self.obligations if not o.satisfied]
        if missing:
            first = missing[0]
            why = first.detail or "no covering analyzer in the scan"
            line += f"; first fall-off: {first.analyzer} ({why})"
        return line

    def to_dict(self) -> Dict[str, Any]:
        return {
            "verdict": self.verdict,
            "env_mismatches": list(self.env_mismatches),
            "obligations": [
                {
                    "analyzer": o.analyzer,
                    "kind": o.kind,
                    "target": o.target,
                    "detail": o.detail,
                }
                for o in self.obligations
            ],
        }

    def pin(self, executed: Sequence[str]) -> Dict[str, int]:
        """Pin the proof against traced execution. ``executed`` is the
        reprs of the analyzers that actually ran in the scan (from the
        run's metric map or trace). All drift fields zero <=> every
        proven obligation's covering analyzer really executed and the
        proof claimed nothing it did not prove."""
        ran = set(executed)
        missing = sum(
            1
            for o in self.obligations
            if o.satisfied and o.target is not None and o.target not in ran
        )
        unproven = sum(1 for o in self.obligations if not o.satisfied)
        return {
            "obligations_unexecuted": missing,
            "obligations_unproven": unproven if self.contained else 0,
            "env_mismatches": len(self.env_mismatches) if self.contained else 0,
        }


# -- where-clause implication over the Kleene lattice -------------------------


def _parse_where(where: Optional[str]) -> Optional[Node]:
    """None (no filter) parses to None — handled as the constant-true
    predicate by the implication tests below."""
    if where is None:
        return None
    return parse(where)


def where_implies(
    a: Optional[str], b: Optional[str], schema: Optional[SchemaInfo] = None
) -> bool:
    """True when predicate ``a``'s filter mask is a subset of ``b``'s:
    no row evaluates TRUE under ``a`` and not under ``b``. Three-valued
    and NaN/NULL-sound exactly like lint/pushdown.py — NULL (and NaN,
    folded to null at decode) rows evaluate FALSE under every
    comparison, so they are excluded by both sides already. Parse
    failures prove nothing (returns False, never a wrong True)."""
    try:
        na, nb = _parse_where(a), _parse_where(b)
    except ExpressionParseError:
        return False
    if nb is None:
        return True  # everything is a subset of "no filter"
    if na is None:
        # constant-true implies b only when b is itself a tautology
        # over non-null rows: NOT b must admit no true row
        verdict = satisfiability(Un("not", nb), schema)
        return verdict in ("unsat", "null-only")
    verdict = satisfiability(Bin("and", na, Un("not", nb)), schema)
    return verdict in ("unsat", "null-only")


def wheres_equivalent(
    a: Optional[str], b: Optional[str], schema: Optional[SchemaInfo] = None
) -> bool:
    """Mutual implication: the two filter masks agree on every row.
    This — not one-way implication — is the bar for reusing a folded
    state across spellings: a state folded under a strictly weaker
    predicate covers extra rows and cannot be narrowed post hoc."""
    if a == b:
        return True
    return where_implies(a, b, schema) and where_implies(b, a, schema)


# -- analyzer matching --------------------------------------------------------


def _params_excluding_where(analyzer: Any) -> Optional[Dict[str, Any]]:
    """The analyzer's constructor surface minus the where spelling —
    the family-kernel identity ((column, cap, ...) bucket). None when
    the analyzer exposes no attribute dict (then only exact matches
    apply)."""
    try:
        params = dict(vars(analyzer))
    except TypeError:
        return None
    params.pop("where", None)
    return params


def _family_equivalent(a: Any, s: Any, schema: Optional[SchemaInfo]) -> bool:
    """Same analyzer modulo where, wheres provably equivalent."""
    if type(a) is not type(s):
        return False
    pa, ps = _params_excluding_where(a), _params_excluding_where(s)
    if pa is None or ps is None:
        return False
    try:
        if pa != ps:
            return False
    except Exception:  # noqa: BLE001 — incomparable params prove nothing
        return False
    return wheres_equivalent(
        getattr(a, "where", None), getattr(s, "where", None), schema
    )


def _near_miss_detail(a: Any, scan: Sequence[Any], schema: Optional[SchemaInfo]) -> str:
    """Why the nearest scan analyzer does NOT discharge the obligation —
    the DQ322 fall-off reason."""
    aw = getattr(a, "where", None)
    for s in scan:
        if type(s) is not type(a):
            continue
        pa, ps = _params_excluding_where(a), _params_excluding_where(s)
        if pa is None or ps is None or pa != ps:
            continue
        sw = getattr(s, "where", None)
        if where_implies(aw, sw, schema):
            return (
                f"where {aw!r} is implied by the scan's {sw!r} but not "
                "equivalent — the scan's folded state covers a superset "
                "of rows and cannot be narrowed"
            )
        return (
            f"where {aw!r} not provably equivalent to the scan's {sw!r} "
            "under three-valued NaN/NULL semantics"
        )
    for s in scan:
        if type(s) is type(a):
            return (
                f"nearest scan analyzer {s!r} differs in parameters, "
                "not only in where"
            )
    return "no scan analyzer of this type"


def prove_subsumption(
    suite: Sequence[Any],
    scan: Sequence[Any],
    schema: Optional[SchemaInfo] = None,
    *,
    suite_env: Optional[PlanEnv] = None,
    scan_env: Optional[PlanEnv] = None,
) -> SubsumptionProof:
    """Prove (or refuse to prove) "suite ⊆ scan".

    ``suite`` / ``scan`` are the two plans' analyzer lists (duplicates
    in the suite dedupe by engine identity first — the runner does the
    same). ``schema`` feeds the predicate-implication lattice; without
    it only structurally identical wheres prove equivalent.
    ``suite_env`` / ``scan_env`` carry the plan-signature components;
    any component mismatch is INCOMPARABLE before a single analyzer is
    compared."""
    env_mismatches: Tuple[str, ...] = ()
    if suite_env is not None and scan_env is not None:
        env_mismatches = tuple(suite_env.mismatches(scan_env))

    seen: set = set()
    unique: List[Any] = []
    for a in suite:
        if a not in seen:
            seen.add(a)
            unique.append(a)

    scan_list = list(scan)
    scan_set = set(scan_list)
    obligations: List[Obligation] = []
    for a in unique:
        if a in scan_set:
            obligations.append(
                Obligation(analyzer=repr(a), kind=EXACT, target=repr(a))
            )
            continue
        matched = None
        for s in scan_list:
            if _family_equivalent(a, s, schema):
                matched = s
                break
        if matched is not None:
            obligations.append(
                Obligation(
                    analyzer=repr(a),
                    kind=EQUIVALENT_WHERE,
                    target=repr(matched),
                    detail=(
                        f"where {getattr(a, 'where', None)!r} proven "
                        f"equivalent to {getattr(matched, 'where', None)!r}"
                    ),
                    where=getattr(a, "where", None),
                )
            )
            continue
        obligations.append(
            Obligation(
                analyzer=repr(a),
                kind=UNMATCHED,
                detail=_near_miss_detail(a, scan_list, schema),
                where=getattr(a, "where", None),
            )
        )

    if env_mismatches:
        verdict = INCOMPARABLE
    elif any(not o.satisfied for o in obligations):
        verdict = INCOMPARABLE
    elif any(o.kind == EQUIVALENT_WHERE for o in obligations):
        verdict = CONTAINED_WITH_RESIDUAL
    else:
        verdict = CONTAINED
    return SubsumptionProof(
        verdict=verdict,
        obligations=tuple(obligations),
        env_mismatches=env_mismatches,
    )


__all__ = [
    "CONTAINED",
    "CONTAINED_WITH_RESIDUAL",
    "EQUIVALENT_WHERE",
    "EXACT",
    "INCOMPARABLE",
    "Obligation",
    "PlanEnv",
    "SubsumptionProof",
    "UNMATCHED",
    "prove_subsumption",
    "where_implies",
    "wheres_equivalent",
]
