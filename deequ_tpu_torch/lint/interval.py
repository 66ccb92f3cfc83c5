"""The interval lattice shared by predicate satisfiability (DQ204,
lint/fold.py) and the row-group pruning interpreter (lint/pushdown.py).

One element is a possibly-open numeric interval with independent
strictness per bound. `narrow()` reproduces the exact tie-breaking the
DQ204 branch verdict always used (a strict bound replaces a non-strict
bound at the same endpoint, never the reverse), so the fold.py refactor
onto this type is verdict-preserving by construction. All operations
are total over +-inf endpoints; NaN endpoints are the caller's bug —
both consumers filter NaN before constructing intervals.

The port's copy of deequ_tpu/lint/interval.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

_CMP_OPS = ("eq", "lt", "le", "gt", "ge")


@dataclass(frozen=True)
class Interval:
    """{x : lo (<|<=) x (<|<=) hi} — strict flags select the strict form."""

    lo: float = -math.inf
    lo_strict: bool = False
    hi: float = math.inf
    hi_strict: bool = False

    # -- constructors --------------------------------------------------------

    @staticmethod
    def top() -> "Interval":
        return Interval()

    @staticmethod
    def point(v: float) -> "Interval":
        return Interval(v, False, v, False)

    @staticmethod
    def closed(lo: float, hi: float) -> "Interval":
        return Interval(lo, False, hi, False)

    @staticmethod
    def from_cmp(op: str, v: float) -> "Interval":
        """The solution set of `x <op> v` for op in eq/lt/le/gt/ge
        (`ne` has no interval form — callers handle it as a point
        complement)."""
        if op == "eq":
            return Interval.point(v)
        if op == "lt":
            return Interval(hi=v, hi_strict=True)
        if op == "le":
            return Interval(hi=v)
        if op == "gt":
            return Interval(lo=v, lo_strict=True)
        if op == "ge":
            return Interval(lo=v)
        raise ValueError(f"no interval form for comparison op {op!r}")

    # -- lattice ops ---------------------------------------------------------

    def narrow(self, op: str, v: float) -> "Interval":
        """Conjoin one ge/gt/le/lt bound. A bound only replaces the
        current one when it is tighter: larger (lo) / smaller (hi), or
        equal-but-strict over equal-but-non-strict."""
        lo, lo_strict, hi, hi_strict = self.lo, self.lo_strict, self.hi, self.hi_strict
        if op in ("ge", "gt"):
            strict = op == "gt"
            if v > lo or (v == lo and strict and not lo_strict):
                lo, lo_strict = v, strict
        elif op in ("le", "lt"):
            strict = op == "lt"
            if v < hi or (v == hi and strict and not hi_strict):
                hi, hi_strict = v, strict
        else:
            raise ValueError(f"cannot narrow with comparison op {op!r}")
        return Interval(lo, lo_strict, hi, hi_strict)

    def intersect(self, other: "Interval") -> "Interval":
        out = self
        out = out.narrow("gt" if other.lo_strict else "ge", other.lo)
        out = out.narrow("lt" if other.hi_strict else "le", other.hi)
        return out

    # -- predicates ----------------------------------------------------------

    @property
    def is_empty(self) -> bool:
        if self.lo > self.hi:
            return True
        return self.lo == self.hi and (self.lo_strict or self.hi_strict)

    @property
    def is_point(self) -> bool:
        return self.lo == self.hi and not (self.lo_strict or self.hi_strict)

    def contains_point(self, v: float) -> bool:
        if v < self.lo or (v == self.lo and self.lo_strict):
            return False
        if v > self.hi or (v == self.hi and self.hi_strict):
            return False
        return True

    def contains(self, other: "Interval") -> bool:
        """self is a superset of other (empty `other` is contained in
        anything)."""
        if other.is_empty:
            return True
        lower_ok = self.lo < other.lo or (
            self.lo == other.lo and (not self.lo_strict or other.lo_strict)
        )
        upper_ok = self.hi > other.hi or (
            self.hi == other.hi and (not self.hi_strict or other.hi_strict)
        )
        return lower_ok and upper_ok

    def disjoint(self, other: "Interval") -> bool:
        return self.intersect(other).is_empty


__all__ = ["Interval"]
