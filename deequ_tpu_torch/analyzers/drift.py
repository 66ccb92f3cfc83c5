"""Two-sample drift statistics computed state-vs-state.

Every function here compares two analyzer STATES (the mergeable
sufficient statistics the repository persists) without touching a row
of either sample: KLL sketches answer two-sample KS distance through
their rank functions, HLL registers answer cardinality ratios through
their estimates, frequency tables answer a chi-square homogeneity test
over the union of keys, and the scalar states (completeness, mean,
stddev) answer delta checks directly. This is what makes
week-over-week and train-vs-serve comparisons free on a warm
repository: both sides are O(log n) state merges (windows/query.py),
and the comparison itself is host-side arithmetic.

Import discipline: numpy and the stdlib only, no torch and no
`deequ_tpu_torch.ops` imports (tests/test_torch_independence.py holds
it). Sketch behavior is reached through the state objects' own methods
(`digest.rank`, `to_arrays`, `metric_value`), never by importing kernel
code; the port's states keep their arrays in numpy on the host, also
after a run on the card.

The JAX counterpart is deequ_tpu/analyzers/drift.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ChiSquareResult",
    "StateBag",
    "cardinality_drift",
    "completeness_drift",
    "frequency_chi_square",
    "mean_drift",
    "quantile_drift",
    "regularized_gamma_q",
    "stddev_drift",
]

_EPS = 1e-12


# ---------------------------------------------------------------------------
# StateBag — one side of a two-sample comparison
# ---------------------------------------------------------------------------


@dataclass
class StateBag:
    """One sample's analyzer states, keyed by analyzer repr — the unit a
    drift check compares. `signature` carries the plan signature the
    states were committed under (when known), so a baseline produced by
    a different plan flags DQ324 instead of silently comparing
    incompatible sketches. `label` names the sample in messages
    ("sliding(7)[...]", "baseline week 31")."""

    states: Dict[str, Tuple[Any, Any]] = field(default_factory=dict)
    signature: Optional[str] = None
    label: str = ""

    @classmethod
    def from_pairs(
        cls,
        pairs: Sequence[Tuple[Any, Any]],
        *,
        signature: Optional[str] = None,
        label: str = "",
    ) -> "StateBag":
        bag = cls(signature=signature, label=label)
        for analyzer, state in pairs:
            bag.states[repr(analyzer)] = (analyzer, state)
        return bag

    @classmethod
    def from_provider(
        cls,
        provider: Any,
        analyzers: Sequence[Any],
        *,
        signature: Optional[str] = None,
        label: str = "",
    ) -> "StateBag":
        """From an `InMemoryStateProvider` (or anything with
        `load(analyzer)`) — the path grouping analyzers take, since
        their states ride the provider rather than the partitioned
        repository."""
        return cls.from_pairs(
            [(a, provider.load(a)) for a in analyzers],
            signature=signature,
            label=label,
        )

    def get(self, analyzer: Any) -> Optional[Any]:
        entry = self.states.get(repr(analyzer))
        return entry[1] if entry is not None else None

    def __contains__(self, analyzer: Any) -> bool:
        return (
            repr(analyzer) in self.states
            and self.states[repr(analyzer)][1] is not None
        )

    def __len__(self) -> int:
        return len(self.states)


# ---------------------------------------------------------------------------
# sketch-backed statistics
# ---------------------------------------------------------------------------


def _sketch_of(state: Any) -> Any:
    """The KLL sketch inside an ApproxQuantileState (or a raw sketch)."""
    return getattr(state, "digest", state)


def quantile_drift(a: Any, b: Any) -> float:
    """Two-sample Kolmogorov–Smirnov distance from two KLL sketches:
    ``max |F_a(v) - F_b(v)|`` over the union of both sketches' retained
    items — scale-free, in [0, 1], and exact over the sketches'
    empirical CDFs (the sketch error is the only approximation). Two
    sketches over identically distributed data sit near 0; a shifted
    or reshaped distribution pushes toward 1."""
    sa, sb = _sketch_of(a), _sketch_of(b)
    ka, na, levels_a = sa.to_arrays()
    kb, nb, levels_b = sb.to_arrays()
    if na == 0 or nb == 0:
        return 0.0 if na == nb else 1.0
    values = np.unique(
        np.concatenate(
            [lv for lv in levels_a if len(lv)]
            + [lv for lv in levels_b if len(lv)]
        )
    )
    worst = 0.0
    for v in values.tolist():
        worst = max(worst, abs(sa.rank(v) - sb.rank(v)))
    return float(worst)


def cardinality_drift(a: Any, b: Any) -> float:
    """Symmetric cardinality ratio drift from two HLL states:
    ``max(r, 1/r) - 1`` with ``r = est_a / est_b`` — 0 when the two
    sides agree, 1.0 when one side holds twice the distincts of the
    other, scale-free in between."""
    ca = float(a.metric_value())
    cb = float(b.metric_value())
    if ca <= 0.0 and cb <= 0.0:
        return 0.0
    if ca <= 0.0 or cb <= 0.0:
        return float("inf")
    r = ca / cb
    return float(max(r, 1.0 / r) - 1.0)


# ---------------------------------------------------------------------------
# frequency chi-square (homogeneity over the union of keys)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChiSquareResult:
    statistic: float
    dof: int
    p_value: float


def _gamma_q_series(a: float, x: float) -> float:
    """Lower-series evaluation of P(a, x), returned as Q = 1 - P.
    Converges fast for x < a + 1 (Numerical Recipes §6.2 `gser`)."""
    term = 1.0 / a
    total = term
    ap = a
    for _ in range(500):
        ap += 1.0
        term *= x / ap
        total += term
        if abs(term) < abs(total) * 1e-15:
            break
    return 1.0 - total * math.exp(-x + a * math.log(x) - math.lgamma(a))

def _gamma_q_cf(a: float, x: float) -> float:
    """Continued-fraction evaluation of Q(a, x) by the modified Lentz
    method. Converges fast for x >= a + 1 (Numerical Recipes `gcf`)."""
    tiny = 1e-300
    b = x + 1.0 - a
    c = 1.0 / tiny
    d = 1.0 / b
    h = d
    for i in range(1, 500):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        if abs(d) < tiny:
            d = tiny
        c = b + an / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-15:
            break
    return h * math.exp(-x + a * math.log(x) - math.lgamma(a))


def regularized_gamma_q(a: float, x: float) -> float:
    """Regularized upper incomplete gamma Q(a, x) = Γ(a, x)/Γ(a) — the
    chi-square survival function is ``Q(dof/2, stat/2)``. Stdlib-only
    (no scipy needed), validated against scipy values in
    tests/test_torch_drift.py."""
    if a <= 0.0:
        raise ValueError(f"gamma Q needs a > 0, got {a}")
    if x < 0.0:
        raise ValueError(f"gamma Q needs x >= 0, got {x}")
    if x == 0.0:
        return 1.0
    if x < a + 1.0:
        return min(1.0, max(0.0, _gamma_q_series(a, x)))
    return min(1.0, max(0.0, _gamma_q_cf(a, x)))


def frequency_chi_square(a: Any, b: Any) -> ChiSquareResult:
    """Two-sample chi-square test of homogeneity over the union of two
    frequency tables (`FrequenciesAndNumRows` states): expected count
    of key i in sample A is ``(a_i + b_i) * A / (A + B)``, dof =
    #union-keys - 1, p-value from the chi-square survival function. A
    small p-value means the two categorical distributions differ."""
    counts_a = {k: int(c) for k, c in zip(a.keys, a.counts.tolist())}
    counts_b = {k: int(c) for k, c in zip(b.keys, b.counts.tolist())}
    union = sorted(set(counts_a) | set(counts_b))
    total_a = float(sum(counts_a.values()))
    total_b = float(sum(counts_b.values()))
    if not union or total_a <= 0.0 or total_b <= 0.0:
        return ChiSquareResult(0.0, 0, 1.0)
    grand = total_a + total_b
    stat = 0.0
    for key in union:
        ca = float(counts_a.get(key, 0))
        cb = float(counts_b.get(key, 0))
        pooled = ca + cb
        ea = pooled * total_a / grand
        eb = pooled * total_b / grand
        if ea > 0.0:
            stat += (ca - ea) ** 2 / ea
        if eb > 0.0:
            stat += (cb - eb) ** 2 / eb
    dof = len(union) - 1
    if dof <= 0:
        return ChiSquareResult(float(stat), 0, 1.0)
    p = regularized_gamma_q(dof / 2.0, stat / 2.0)
    return ChiSquareResult(float(stat), int(dof), float(p))


# ---------------------------------------------------------------------------
# scalar-state deltas
# ---------------------------------------------------------------------------


def completeness_drift(a: Any, b: Any) -> float:
    """Absolute completeness-ratio difference between two
    `NumMatchesAndCount` states; an empty side counts as drift 0 only
    against another empty side."""
    ra = float(a.metric_value())
    rb = float(b.metric_value())
    if math.isnan(ra) and math.isnan(rb):
        return 0.0
    if math.isnan(ra) or math.isnan(rb):
        return float("inf")
    return abs(ra - rb)


def _relative_delta(va: float, vb: float) -> float:
    if math.isnan(va) and math.isnan(vb):
        return 0.0
    if math.isnan(va) or math.isnan(vb):
        return float("inf")
    scale = max(abs(va), abs(vb))
    if scale < _EPS:
        return 0.0
    return abs(va - vb) / scale


def mean_drift(a: Any, b: Any) -> float:
    """Relative mean delta ``|m_a - m_b| / max(|m_a|, |m_b|)`` between
    two `MeanState`s — scale-free, 0 when equal."""
    return _relative_delta(float(a.metric_value()), float(b.metric_value()))


def stddev_drift(a: Any, b: Any) -> float:
    """Relative standard-deviation delta between two
    `StandardDeviationState`s."""
    return _relative_delta(float(a.metric_value()), float(b.metric_value()))
