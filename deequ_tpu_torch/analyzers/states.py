"""Mergeable sufficient statistics — the state semigroup.

THE enabling abstraction (reference: analyzers/Analyzer.scala:29-53,
`State[S].sum`): every metric is computed from a state that merges
associatively+commutatively, which is what makes computation incremental
(per-batch), partition-parallel (per-device partial states combined by
collectives) and resumable (states persist; metrics recompute from merged
states without rescanning data).

Host-side states are plain float64/int dataclasses, the same fields as the
JAX package's states (interop.py carries one across). The per-batch
partials live with each analyzer's `device_reduce` (analyzers/scan.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TypeVar

S = TypeVar("S", bound="State")


class State:
    """A commutative-semigroup element."""

    def merge(self: S, other: S) -> S:
        raise NotImplementedError

    def __add__(self: S, other: S) -> S:
        return self.merge(other)


class DoubleValuedState(State):
    def metric_value(self) -> float:
        raise NotImplementedError


@dataclass(frozen=True)
class NumMatches(DoubleValuedState):
    """reference: analyzers/Size.scala:23"""

    num_matches: int

    def merge(self, other: "NumMatches") -> "NumMatches":
        return NumMatches(self.num_matches + other.num_matches)

    def metric_value(self) -> float:
        return float(self.num_matches)


@dataclass(frozen=True)
class NumMatchesAndCount(DoubleValuedState):
    """Ratio state; NaN when count == 0
    (reference: analyzers/Analyzer.scala:220-234)."""

    num_matches: int
    count: int

    def merge(self, other: "NumMatchesAndCount") -> "NumMatchesAndCount":
        return NumMatchesAndCount(
            self.num_matches + other.num_matches, self.count + other.count
        )

    def metric_value(self) -> float:
        if self.count == 0:
            return float("nan")
        return self.num_matches / self.count


@dataclass(frozen=True)
class MeanState(DoubleValuedState):
    """reference: analyzers/Mean.scala:25"""

    total: float
    count: int

    def merge(self, other: "MeanState") -> "MeanState":
        return MeanState(self.total + other.total, self.count + other.count)

    def metric_value(self) -> float:
        if self.count == 0:
            return float("nan")
        return self.total / self.count


@dataclass(frozen=True)
class MinState(DoubleValuedState):
    min_value: float

    def merge(self, other: "MinState") -> "MinState":
        return MinState(min(self.min_value, other.min_value))

    def metric_value(self) -> float:
        return self.min_value


@dataclass(frozen=True)
class MaxState(DoubleValuedState):
    max_value: float

    def merge(self, other: "MaxState") -> "MaxState":
        return MaxState(max(self.max_value, other.max_value))

    def metric_value(self) -> float:
        return self.max_value


@dataclass(frozen=True)
class SumState(DoubleValuedState):
    sum_value: float

    def merge(self, other: "SumState") -> "SumState":
        return SumState(self.sum_value + other.sum_value)

    def metric_value(self) -> float:
        return self.sum_value


@dataclass(frozen=True)
class StandardDeviationState(DoubleValuedState):
    """(n, avg, m2) — parallel variance via the Chan et al. pairwise update
    (reference: analyzers/StandardDeviation.scala:25-44)."""

    n: float
    avg: float
    m2: float

    def merge(self, other: "StandardDeviationState") -> "StandardDeviationState":
        if self.n == 0:
            return other
        if other.n == 0:
            return self
        n = self.n + other.n
        delta = other.avg - self.avg
        avg = (self.n * self.avg + other.n * other.avg) / n
        m2 = self.m2 + other.m2 + delta * delta * self.n * other.n / n
        return StandardDeviationState(n, avg, m2)

    def metric_value(self) -> float:
        if self.n == 0:
            return float("nan")
        return math.sqrt(self.m2 / self.n)


@dataclass(frozen=True)
class CorrelationState(DoubleValuedState):
    """(n, xAvg, yAvg, ck, xMk, yMk) — pairwise co-moment merge
    (reference: analyzers/Correlation.scala:26-52)."""

    n: float
    x_avg: float
    y_avg: float
    ck: float
    x_mk: float
    y_mk: float

    def merge(self, other: "CorrelationState") -> "CorrelationState":
        if self.n == 0:
            return other
        if other.n == 0:
            return self
        n1, n2 = self.n, other.n
        n = n1 + n2
        dx = other.x_avg - self.x_avg
        dy = other.y_avg - self.y_avg
        x_avg = self.x_avg + dx * n2 / n
        y_avg = self.y_avg + dy * n2 / n
        ck = self.ck + other.ck + dx * dy * n1 * n2 / n
        x_mk = self.x_mk + other.x_mk + dx * dx * n1 * n2 / n
        y_mk = self.y_mk + other.y_mk + dy * dy * n1 * n2 / n
        return CorrelationState(n, x_avg, y_avg, ck, x_mk, y_mk)

    def metric_value(self) -> float:
        if self.n == 0 or self.x_mk == 0 or self.y_mk == 0:
            return float("nan")
        return self.ck / math.sqrt(self.x_mk * self.y_mk)
