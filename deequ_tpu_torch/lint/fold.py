"""Constant folding and predicate satisfiability for plan linting.

Two static facts about a predicate matter at plan time:

* it folds to a constant (`1 = 1`, `TRUE OR x > 0`) — the filter is a
  no-op or drops every row (DQ205 / DQ204), and
* it is unsatisfiable for non-NULL rows (`x < 1 AND x > 2`, or an
  `isContainedIn(lower=5, upper=1)` whose generated range is empty and
  only the `IS NULL` escape branch can ever hold) — DQ204.

Satisfiability works on a bounded DNF expansion over simple atoms
(column-vs-literal comparisons, IS [NOT] NULL, constants); anything else
is opaque and makes the verdict 'unknown' rather than wrong. Kleene
semantics are respected when pushing NOT through comparisons:
NOT (a < b) == a >= b holds in 3-valued logic (both are NULL on NULL).

The port's copy of deequ_tpu/lint/fold.py.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from deequ_tpu_torch.data.expr import (
    Between,
    Bin,
    Col,
    Func,
    InList,
    IsNull,
    Like,
    Lit,
    Node,
    Un,
)
from deequ_tpu_torch.lint.interval import Interval
from deequ_tpu_torch.lint.schema import SchemaInfo

_DNF_BRANCH_CAP = 64

# -- constant folding --------------------------------------------------------

_UNSET = object()


def const_fold(node: Node):
    """Fold a literal-only subtree to its value (float | str | bool | None
    with SQL NULL semantics). Returns _UNSET sentinel-free API: a tuple
    (True, value) when the node is a compile-time constant, else
    (False, None)."""
    ok, v = _fold(node)
    return ok, v


def _fold(node: Node) -> Tuple[bool, object]:
    if isinstance(node, Lit):
        return True, node.value
    if isinstance(node, Un):
        ok, v = _fold(node.x)
        if not ok:
            return False, None
        if node.op == "neg":
            if v is None:
                return True, None
            try:
                return True, -float(v)
            except (TypeError, ValueError):
                return False, None
        # not: Kleene
        if v is None:
            return True, None
        return True, not bool(v)
    if isinstance(node, Bin):
        lok, lv = _fold(node.l)
        rok, rv = _fold(node.r)
        if not (lok and rok):
            # Kleene shortcuts: FALSE AND x == FALSE, TRUE OR x == TRUE
            if node.op == "and":
                for ok, v in ((lok, lv), (rok, rv)):
                    if ok and v is not None and not bool(v):
                        return True, False
            if node.op == "or":
                for ok, v in ((lok, lv), (rok, rv)):
                    if ok and v is not None and bool(v):
                        return True, True
            return False, None
        if node.op == "and":
            l3 = None if lv is None else bool(lv)
            r3 = None if rv is None else bool(rv)
            if l3 is False or r3 is False:
                return True, False
            if l3 is None or r3 is None:
                return True, None
            return True, True
        if node.op == "or":
            l3 = None if lv is None else bool(lv)
            r3 = None if rv is None else bool(rv)
            if l3 is True or r3 is True:
                return True, True
            if l3 is None or r3 is None:
                return True, None
            return True, False
        if lv is None or rv is None:
            return True, None
        if node.op in ("eq", "ne", "lt", "le", "gt", "ge"):
            try:
                if isinstance(lv, str) or isinstance(rv, str):
                    a, b = str(lv), str(rv)
                else:
                    a, b = float(lv), float(rv)
            except (TypeError, ValueError):
                return False, None
            out = {
                "eq": a == b, "ne": a != b, "lt": a < b,
                "le": a <= b, "gt": a > b, "ge": a >= b,
            }[node.op]
            return True, out
        try:
            a, b = float(lv), float(rv)
        except (TypeError, ValueError):
            return False, None
        if node.op == "add":
            return True, a + b
        if node.op == "sub":
            return True, a - b
        if node.op == "mul":
            return True, a * b
        if node.op == "div":
            return True, (None if b == 0 else a / b)
        if node.op == "mod":
            return True, (None if b == 0 else math.fmod(a, b))
        return False, None
    if isinstance(node, IsNull):
        ok, v = _fold(node.x)
        if not ok:
            return False, None
        is_null = v is None
        return True, (not is_null) if node.negated else is_null
    return False, None


# -- DNF satisfiability ------------------------------------------------------

# atom forms:
#   ('cmp', col, op, value)      op in eq/ne/lt/le/gt/ge; value float or str
#   ('null', col, must_be_null)  bool
#   ('const', bool)
#   ('opaque',)
Atom = Tuple
Branch = List[Atom]

_NEG_CMP = {"eq": "ne", "ne": "eq", "lt": "ge", "ge": "lt", "le": "gt", "gt": "le"}
_FLIP_CMP = {"lt": "gt", "gt": "lt", "le": "ge", "ge": "le", "eq": "eq", "ne": "ne"}


def _lit_value(node: Node):
    """Literal usable in an atom: (True, value) for numeric/str literals."""
    ok, v = _fold(node)
    if not ok or v is None:
        return False, None
    if isinstance(v, bool):
        return False, None
    if isinstance(v, (int, float)):
        return True, float(v)
    if isinstance(v, str):
        return True, v
    return False, None


def _cmp_atom(node: Bin) -> Optional[Atom]:
    if isinstance(node.l, Col):
        ok, v = _lit_value(node.r)
        if ok:
            return ("cmp", node.l.name, node.op, v)
    if isinstance(node.r, Col):
        ok, v = _lit_value(node.l)
        if ok:
            return ("cmp", node.r.name, _FLIP_CMP[node.op], v)
    return None


def _cross(a: List[Branch], b: List[Branch]) -> Optional[List[Branch]]:
    if len(a) * len(b) > _DNF_BRANCH_CAP:
        return None
    return [x + y for x in a for y in b]


def _dnf(node: Node, neg: bool) -> Optional[List[Branch]]:
    """DNF branches of `node` (negated when neg). None = too complex."""
    ok, v = _fold(node)
    if ok:
        if v is None:
            # NULL predicate is never TRUE (and its negation is NULL too)
            return [[("const", False)]]
        truth = bool(v) ^ neg
        return [[("const", truth)]]

    if isinstance(node, Un) and node.op == "not":
        return _dnf(node.x, not neg)

    if isinstance(node, Bin) and node.op in ("and", "or"):
        is_and = (node.op == "and") ^ neg
        l = _dnf(node.l, neg)
        r = _dnf(node.r, neg)
        if l is None or r is None:
            return None
        if is_and:
            return _cross(l, r)
        out = l + r
        return out if len(out) <= _DNF_BRANCH_CAP else None

    if isinstance(node, Bin) and node.op in _NEG_CMP:
        op = _NEG_CMP[node.op] if neg else node.op
        atom = _cmp_atom(Bin(op, node.l, node.r))
        return [[atom]] if atom is not None else [[("opaque",)]]

    if isinstance(node, IsNull):
        if isinstance(node.x, Col):
            must_be_null = (not node.negated) ^ neg
            return [[("null", node.x.name, must_be_null)]]
        return [[("opaque",)]]

    if isinstance(node, Between):
        if isinstance(node.x, Col):
            lo_ok, lo = _lit_value(node.lo)
            hi_ok, hi = _lit_value(node.hi)
            if lo_ok and hi_ok:
                effective_neg = node.negated ^ neg
                if not effective_neg:
                    return [[("cmp", node.x.name, "ge", lo),
                             ("cmp", node.x.name, "le", hi)]]
                return [[("cmp", node.x.name, "lt", lo)],
                        [("cmp", node.x.name, "gt", hi)]]
        return [[("opaque",)]]

    if isinstance(node, InList):
        if isinstance(node.x, Col):
            values = []
            for item in node.items:
                ok, v = _lit_value(item)
                if not ok:
                    return [[("opaque",)]]
                values.append(v)
            effective_neg = node.negated ^ neg
            if not effective_neg:
                branches = [[("cmp", node.x.name, "eq", v)] for v in values]
                return branches if len(branches) <= _DNF_BRANCH_CAP else None
            return [[("cmp", node.x.name, "ne", v) for v in values]]
        return [[("opaque",)]]

    if isinstance(node, (Like, Func, Col, Bin, Un)):
        return [[("opaque",)]]

    return [[("opaque",)]]


class _ColFacts:
    """Per-column conjunction state: one Interval element (the shared
    lattice in lint/interval.py, also the pushdown interpreter's domain)
    plus eq/ne point facts the interval form can't express."""

    __slots__ = ("iv", "eq", "ne", "domain")

    def __init__(self):
        self.iv = Interval.top()
        self.eq: object = _UNSET
        self.ne: set = set()
        self.domain: Optional[str] = None  # 'num' | 'str' once constrained


def _branch_verdict(
    branch: Branch, schema: Optional[SchemaInfo]
) -> Tuple[str, bool]:
    """-> (verdict 'sat'|'unsat'|'unknown', has_null_escape)."""
    facts: Dict[str, _ColFacts] = {}
    must_null: Dict[str, bool] = {}
    unknown = False
    has_escape = False

    for atom in branch:
        tag = atom[0]
        if tag == "const":
            if not atom[1]:
                return "unsat", False
        elif tag == "opaque":
            unknown = True
        elif tag == "null":
            _, col, is_null = atom
            if col in must_null and must_null[col] != is_null:
                return "unsat", False
            must_null[col] = is_null
            if is_null:
                has_escape = True
                if schema is not None:
                    fld = schema.field(col)
                    if fld is not None and not fld.nullable:
                        return "unsat", False
        elif tag == "cmp":
            _, col, op, v = atom
            # a TRUE comparison requires the column to be non-NULL
            if must_null.get(col) is True:
                return "unsat", False
            must_null[col] = False
            f = facts.setdefault(col, _ColFacts())
            dom = "str" if isinstance(v, str) else "num"
            if f.domain is None:
                f.domain = dom
            elif f.domain != dom:
                # mixed string/number constraints involve eval-side
                # coercion; don't try to reason about them
                unknown = True
                continue
            if dom == "str":
                if op == "eq":
                    if f.eq is not _UNSET and f.eq != v:
                        return "unsat", False
                    if v in f.ne:
                        return "unsat", False
                    f.eq = v
                elif op == "ne":
                    if f.eq is not _UNSET and f.eq == v:
                        return "unsat", False
                    f.ne.add(v)
                else:
                    unknown = True  # string ordering: out of scope
                continue
            if op == "eq":
                if f.eq is not _UNSET and f.eq != v:
                    return "unsat", False
                if v in f.ne:
                    return "unsat", False
                f.eq = v
            elif op == "ne":
                if f.eq is not _UNSET and f.eq == v:
                    return "unsat", False
                f.ne.add(v)
            elif op in ("ge", "gt", "le", "lt"):
                f.iv = f.iv.narrow(op, v)

    for col, f in facts.items():
        if f.domain != "num":
            continue
        if f.iv.is_empty:
            return "unsat", False
        if f.eq is not _UNSET:
            if not f.iv.contains_point(f.eq):
                return "unsat", False
        elif f.iv.is_point and f.iv.lo in f.ne:
            return "unsat", False

    # check for a must-null column that schema forbids was handled inline
    return ("unknown" if unknown else "sat"), has_escape


def satisfiability(node: Node, schema: Optional[SchemaInfo] = None) -> str:
    """-> 'sat' | 'unsat' | 'null-only' | 'unknown'.

    'null-only': some rows can satisfy the predicate, but ONLY via an
    IS NULL escape branch while every non-escape branch is impossible —
    e.g. `c IS NULL OR (c >= 5 AND c <= 1)`. A plain `c IS NULL`
    predicate has no impossible non-escape branch and stays 'sat'.
    """
    branches = _dnf(node, neg=False)
    if branches is None or not branches:
        return "unknown"

    sat_escape = unsat_n = unknown_n = sat_plain = 0
    for branch in branches:
        verdict, has_escape = _branch_verdict(branch, schema)
        if verdict == "unsat":
            unsat_n += 1
        elif verdict == "unknown":
            unknown_n += 1
        elif has_escape:
            sat_escape += 1
        else:
            sat_plain += 1

    if unsat_n == len(branches):
        return "unsat"
    if sat_plain == 0 and unknown_n == 0 and sat_escape > 0 and unsat_n > 0:
        return "null-only"
    if sat_plain == 0 and sat_escape == 0:
        return "unknown"
    return "sat"


def dnf_branches(node: Node) -> Optional[List[Branch]]:
    """Public DNF entry shared with the row-group pruning interpreter
    (lint/pushdown.py): branches of `node` un-negated; None when the
    expansion exceeds _DNF_BRANCH_CAP."""
    return _dnf(node, neg=False)


def cmp_atom(node: Bin) -> Optional[Atom]:
    """Public alias of the column-vs-literal atom extractor, used by the
    pushdown eligibility walk to classify comparison nodes."""
    return _cmp_atom(node)


def fold_to_constant(node: Node) -> Optional[Tuple[bool, object]]:
    """(True, value) when the whole predicate folds to a compile-time
    constant, else None. Kept as a thin alias over const_fold for the
    plan linter."""
    ok, v = _fold(node)
    return (True, v) if ok else None
