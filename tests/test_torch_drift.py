"""State-vs-state drift statistics (analyzers/drift.py) and the drift
Check family (checks/drift.py): every measure is pinned against a
direct numpy two-sample recomputation over the raw samples, the
hand-rolled chi-square survival function is validated against known
scipy values and closed forms, StateBags round-trip through the DQST
envelope (KLL rng tail included), and `DriftCheck.evaluate` covers the
pass/fail/missing-state/signature-mismatch (DQ324) paths.

Port-mapped from tests/test_drift.py: the same cases against
deequ_tpu_torch, every run on the CPU (tests/torch_cpu.py). The cases at
the end carry the same states across to the JAX package
(deequ_tpu_torch/interop.py) and hold every drift statistic to the JAX
function's: counts exactly, floats within 1e-12 relative.
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import math

import numpy as np
import pytest

from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    Completeness,
    Mean,
    Size,
    StandardDeviation,
)
from deequ_tpu_torch.analyzers import states as S
from deequ_tpu_torch.analyzers.drift import (
    StateBag,
    cardinality_drift,
    completeness_drift,
    frequency_chi_square,
    mean_drift,
    quantile_drift,
    regularized_gamma_q,
    stddev_drift,
)
from deequ_tpu_torch.analyzers.frequency import FrequenciesAndNumRows
from deequ_tpu_torch.checks import CheckLevel, CheckStatus, DriftCheck
from deequ_tpu_torch.constraints.constraint import ConstraintStatus
from deequ_tpu_torch.data.table import ColumnType, Table
from deequ_tpu_torch.ops.fused import FusedScanPass
from deequ_tpu_torch.ops.sketches.kll import KLLSketch
from deequ_tpu_torch.repository.states import decode_states, encode_states


pytestmark = pytest.mark.usefixtures("cpu_default")


def _table(rng: np.random.Generator, n: int, *, mean=50.0, scale=10.0,
           nulls=0.05, card=200) -> Table:
    x = rng.normal(mean, scale, n)
    x[rng.random(n) < nulls] = np.nan
    g = rng.integers(0, card, n)
    return Table.from_pydict(
        {"x": list(x), "g": [int(v) for v in g]},
        types={"x": ColumnType.DOUBLE, "g": ColumnType.LONG},
    )


def _fold(analyzers, table):
    results = FusedScanPass(list(analyzers)).run(table)
    for r in results:
        assert r.error is None, r.error
    return [(r.analyzer, r.state) for r in results]


def _sketch(values) -> KLLSketch:
    sk = KLLSketch(k=2048)
    sk.update_batch(np.asarray(values, dtype=np.float64))
    return sk


def _np_two_sample_ks(a, b) -> float:
    """Direct numpy two-sample KS distance over the raw samples."""
    a = np.sort(np.asarray(a, dtype=np.float64))
    b = np.sort(np.asarray(b, dtype=np.float64))
    union = np.unique(np.concatenate([a, b]))
    fa = np.searchsorted(a, union, side="right") / len(a)
    fb = np.searchsorted(b, union, side="right") / len(b)
    return float(np.max(np.abs(fa - fb)))


# ---------------------------------------------------------------------------
# quantile (KS) drift
# ---------------------------------------------------------------------------


class TestQuantileDrift:
    def test_matches_numpy_ks_when_sketches_are_exact(self):
        """Small samples sit below the KLL compaction threshold, so the
        sketches hold every item and the state-vs-state KS must equal
        the direct numpy two-sample KS exactly."""
        rng = np.random.default_rng(3)
        a = rng.normal(0.0, 1.0, 400)
        b = rng.normal(0.6, 1.3, 500)
        got = quantile_drift(_sketch(a), _sketch(b))
        assert got == pytest.approx(_np_two_sample_ks(a, b), abs=1e-12)

    def test_identical_samples_have_zero_drift(self):
        rng = np.random.default_rng(4)
        a = rng.normal(10.0, 2.0, 300)
        assert quantile_drift(_sketch(a), _sketch(a.copy())) == 0.0

    def test_disjoint_supports_approach_one(self):
        a = _sketch(np.arange(0.0, 100.0))
        b = _sketch(np.arange(1000.0, 1100.0))
        assert quantile_drift(a, b) == pytest.approx(1.0)

    def test_large_samples_stay_near_numpy_within_sketch_error(self):
        rng = np.random.default_rng(5)
        a = rng.normal(0.0, 1.0, 60_000)
        b = rng.normal(0.25, 1.0, 60_000)
        got = quantile_drift(_sketch(a), _sketch(b))
        ref = _np_two_sample_ks(a, b)
        assert got == pytest.approx(ref, abs=0.02)  # 2x the k=2048 error

    def test_empty_sides(self):
        empty = KLLSketch(k=256)
        assert quantile_drift(empty, KLLSketch(k=256)) == 0.0
        assert quantile_drift(empty, _sketch([1.0, 2.0])) == 1.0

    def test_reads_the_digest_of_a_quantile_state(self):
        rng = np.random.default_rng(6)
        a = rng.normal(5.0, 1.0, 200)
        [(_, state)] = _fold(
            [ApproxQuantile("x", 0.5)],
            Table.from_pydict({"x": list(a)}, types={"x": ColumnType.DOUBLE}),
        )
        assert quantile_drift(state, _sketch(a)) == pytest.approx(0.0, abs=1e-12)


# ---------------------------------------------------------------------------
# cardinality drift
# ---------------------------------------------------------------------------


class TestCardinalityDrift:
    def _hll(self, rng, card, n=4000):
        [(_, state)] = _fold(
            [ApproxCountDistinct("g")],
            Table.from_pydict(
                {"g": [int(v) for v in rng.integers(0, card, n)]},
                types={"g": ColumnType.LONG},
            ),
        )
        return state

    def test_equal_sides_zero(self):
        rng = np.random.default_rng(7)
        a = self._hll(rng, 300)
        assert cardinality_drift(a, a) == 0.0

    def test_doubling_is_about_one_and_symmetric(self):
        rng = np.random.default_rng(8)
        a = self._hll(rng, 250)
        b = self._hll(rng, 500)
        d = cardinality_drift(a, b)
        assert d == pytest.approx(1.0, abs=0.15)  # HLL error band
        assert cardinality_drift(b, a) == d

    def test_matches_the_estimates_ratio_exactly(self):
        rng = np.random.default_rng(9)
        a, b = self._hll(rng, 100), self._hll(rng, 130)
        r = float(a.metric_value()) / float(b.metric_value())
        assert cardinality_drift(a, b) == pytest.approx(max(r, 1 / r) - 1.0)


# ---------------------------------------------------------------------------
# the chi-square machinery
# ---------------------------------------------------------------------------


class TestRegularizedGammaQ:
    def test_closed_form_dof2_family(self):
        # Q(1, x) = e^-x exactly
        for x in (0.01, 0.5, 1.0, 3.0, 10.0, 40.0):
            assert regularized_gamma_q(1.0, x) == pytest.approx(
                math.exp(-x), rel=1e-12
            )

    def test_closed_form_dof1_family(self):
        # Q(1/2, x) = erfc(sqrt(x)) — the chi-square(1) survival function
        for x in (0.05, 0.5, 2.0, 8.0):
            assert regularized_gamma_q(0.5, x) == pytest.approx(
                math.erfc(math.sqrt(x)), rel=1e-10
            )

    def test_integer_a_poisson_tail(self):
        # Q(k, x) = e^-x * sum_{j<k} x^j / j! for integer k
        for k in (2, 3, 6):
            for x in (0.5, 2.5, 9.0):
                ref = math.exp(-x) * sum(
                    x**j / math.factorial(j) for j in range(k)
                )
                assert regularized_gamma_q(float(k), x) == pytest.approx(
                    ref, rel=1e-10
                )

    def test_known_scipy_critical_values(self):
        # chi2.sf at the textbook 5% critical values, scipy-validated
        for stat, dof in (
            (3.841458820694124, 1),
            (5.991464547107979, 2),
            (11.070497693516351, 5),
        ):
            assert regularized_gamma_q(dof / 2.0, stat / 2.0) == pytest.approx(
                0.05, rel=1e-9
            )

    def test_domain_errors(self):
        with pytest.raises(ValueError):
            regularized_gamma_q(0.0, 1.0)
        with pytest.raises(ValueError):
            regularized_gamma_q(1.0, -0.5)
        assert regularized_gamma_q(2.0, 0.0) == 1.0


def _freq(counts: dict) -> FrequenciesAndNumRows:
    keys = list(counts)
    return FrequenciesAndNumRows(
        ["s"],
        [np.array(keys, dtype=object)],
        np.array([counts[k] for k in keys], dtype=np.int64),
        int(sum(counts.values())),
    )


class TestFrequencyChiSquare:
    def test_statistic_matches_numpy_recomputation(self):
        a = {"a": 10, "b": 20, "c": 30}
        b = {"a": 30, "b": 20, "c": 10, "d": 5}
        res = frequency_chi_square(_freq(a), _freq(b))
        # direct numpy homogeneity recomputation over the union
        union = sorted(set(a) | set(b))
        ca = np.array([a.get(k, 0) for k in union], dtype=np.float64)
        cb = np.array([b.get(k, 0) for k in union], dtype=np.float64)
        ta, tb = ca.sum(), cb.sum()
        ea = (ca + cb) * ta / (ta + tb)
        eb = (ca + cb) * tb / (ta + tb)
        ref = float((((ca - ea) ** 2) / ea + ((cb - eb) ** 2) / eb).sum())
        assert res.statistic == pytest.approx(ref, rel=1e-12)
        assert res.dof == len(union) - 1
        assert res.p_value == pytest.approx(
            regularized_gamma_q(res.dof / 2.0, res.statistic / 2.0)
        )

    def test_identical_distributions_do_not_reject(self):
        a = {"a": 500, "b": 300, "c": 200}
        res = frequency_chi_square(_freq(a), _freq(dict(a)))
        assert res.statistic == 0.0
        assert res.p_value == 1.0

    def test_shifted_distribution_rejects(self):
        a = {"a": 500, "b": 300, "c": 200}
        b = {"a": 200, "b": 300, "c": 500}
        assert frequency_chi_square(_freq(a), _freq(b)).p_value < 1e-6

    def test_degenerate_sides(self):
        res = frequency_chi_square(_freq({}), _freq({"a": 3}))
        assert (res.statistic, res.dof, res.p_value) == (0.0, 0, 1.0)
        res = frequency_chi_square(_freq({"a": 3}), _freq({"a": 5}))
        assert res.dof == 0 and res.p_value == 1.0


# ---------------------------------------------------------------------------
# scalar deltas, pinned against numpy recomputation
# ---------------------------------------------------------------------------


class TestScalarDrift:
    def test_completeness_mean_stddev_match_numpy(self):
        rng = np.random.default_rng(11)
        xa = rng.normal(40.0, 5.0, 800)
        xa[rng.random(800) < 0.10] = np.nan
        xb = rng.normal(44.0, 7.0, 600)
        xb[rng.random(600) < 0.02] = np.nan
        analyzers = [Completeness("x"), Mean("x"), StandardDeviation("x")]
        ta = Table.from_pydict({"x": list(xa)}, types={"x": ColumnType.DOUBLE})
        tb = Table.from_pydict({"x": list(xb)}, types={"x": ColumnType.DOUBLE})
        (_, ca), (_, ma), (_, sa) = _fold(analyzers, ta)
        (_, cb), (_, mb), (_, sb) = _fold(analyzers, tb)

        ra = np.count_nonzero(~np.isnan(xa)) / len(xa)
        rb = np.count_nonzero(~np.isnan(xb)) / len(xb)
        assert completeness_drift(ca, cb) == pytest.approx(abs(ra - rb), abs=1e-12)

        mean_a, mean_b = np.nanmean(xa), np.nanmean(xb)
        assert mean_drift(ma, mb) == pytest.approx(
            abs(mean_a - mean_b) / max(abs(mean_a), abs(mean_b)), rel=1e-9
        )

        std_a = np.nanstd(xa)  # population stddev, the engine's definition
        std_b = np.nanstd(xb)
        assert stddev_drift(sa, sb) == pytest.approx(
            abs(std_a - std_b) / max(std_a, std_b), rel=1e-6
        )

    def test_nan_handling(self):
        both = S.MeanState(float("nan"), 0)
        ok = S.MeanState(10.0, 2)
        assert mean_drift(both, S.MeanState(float("nan"), 0)) == 0.0
        assert mean_drift(both, ok) == float("inf")
        assert completeness_drift(
            S.NumMatchesAndCount(0, 0), S.NumMatchesAndCount(1, 2)
        ) == float("inf")

    def test_near_zero_means_do_not_explode(self):
        a = S.MeanState(1e-15, 1)
        b = S.MeanState(-1e-15, 1)
        assert mean_drift(a, b) == 0.0


# ---------------------------------------------------------------------------
# StateBag + envelope round trip (KLL rng tail included)
# ---------------------------------------------------------------------------


ANALYZERS = [
    Size(),
    Completeness("x"),
    Mean("x"),
    StandardDeviation("x"),
    ApproxCountDistinct("g"),
    ApproxQuantile("x", 0.5),
]


def _bag(rng: np.random.Generator, n=900, **kw) -> StateBag:
    pairs = _fold(ANALYZERS, _table(rng, n, **kw))
    return StateBag.from_pairs(pairs, signature="sig-A", label="test")


class TestStateBag:
    def test_round_trips_through_the_envelope(self):
        rng = np.random.default_rng(13)
        bag = _bag(rng)
        blob = encode_states([(a, bag.get(a)) for a in ANALYZERS])
        restored = StateBag.from_pairs(
            list(zip(ANALYZERS, decode_states(blob, ANALYZERS))),
            signature=bag.signature,
        )
        for a in ANALYZERS:
            assert a in restored
        # every drift measure sees the serde'd side as identical
        assert quantile_drift(
            bag.get(ApproxQuantile("x", 0.5)),
            restored.get(ApproxQuantile("x", 0.5)),
        ) == 0.0
        assert mean_drift(bag.get(Mean("x")), restored.get(Mean("x"))) == 0.0
        assert cardinality_drift(
            bag.get(ApproxCountDistinct("g")),
            restored.get(ApproxCountDistinct("g")),
        ) == 0.0

    def test_kll_rng_tail_survives_serde(self):
        """A deserialized KLL partial must merge bit-identically to the
        live sketch it was saved from — the envelope carries the PCG64
        generator position, not just (k, n, levels)."""
        rng = np.random.default_rng(14)
        analyzer = ApproxQuantile("x", 0.5)
        big = rng.normal(0.0, 1.0, 30_000)  # above compaction threshold
        [(_, live)] = _fold(
            [analyzer],
            Table.from_pydict({"x": list(big)}, types={"x": ColumnType.DOUBLE}),
        )
        [restored] = decode_states(
            encode_states([(analyzer, live)]), [analyzer]
        )
        [(_, other)] = _fold(
            [analyzer],
            Table.from_pydict(
                {"x": list(rng.normal(0.0, 1.0, 30_000))},
                types={"x": ColumnType.DOUBLE},
            ),
        )
        merged_live = live.merge(other)
        merged_restored = restored.merge(other)
        ka, na, la = merged_live.digest.to_arrays()
        kb, nb, lb = merged_restored.digest.to_arrays()
        assert (ka, na) == (kb, nb)
        assert all(np.array_equal(x, y) for x, y in zip(la, lb))

    def test_missing_analyzer(self):
        rng = np.random.default_rng(15)
        bag = _bag(rng)
        assert bag.get(Mean("zzz")) is None
        assert Mean("zzz") not in bag


# ---------------------------------------------------------------------------
# DriftCheck evaluate
# ---------------------------------------------------------------------------


class TestDriftCheck:
    CHECK = (
        DriftCheck(CheckLevel.ERROR, "weekly")
        .has_no_quantile_drift("x", max_quantile_shift=0.1)
        .has_no_cardinality_drift("g", max_ratio_drift=0.25)
        .has_no_completeness_drift("x", max_delta=0.05)
        .has_no_mean_drift("x", max_relative_delta=0.05)
        .has_no_stddev_drift("x", max_relative_delta=0.25)
    )

    def test_required_analyzers(self):
        reprs = {repr(a) for a in self.CHECK.required_analyzers()}
        assert repr(ApproxQuantile("x", 0.5)) in reprs
        assert repr(ApproxCountDistinct("g")) in reprs
        assert repr(Mean("x")) in reprs

    def test_stable_data_passes(self):
        rng = np.random.default_rng(16)
        result = self.CHECK.evaluate(
            current=_bag(rng), baseline=_bag(rng)
        )
        assert result.status == CheckStatus.SUCCESS
        assert all(
            r.status == ConstraintStatus.SUCCESS
            for r in result.constraint_results
        )
        assert result.diagnostics == []

    def test_skewed_data_fails_with_values(self):
        rng = np.random.default_rng(17)
        baseline = _bag(rng)
        current = _bag(rng, mean=80.0, scale=25.0, nulls=0.3, card=600)
        result = self.CHECK.evaluate(current=current, baseline=baseline)
        assert result.status == CheckStatus.ERROR
        failed = [
            r
            for r in result.constraint_results
            if r.status == ConstraintStatus.FAILURE
        ]
        assert len(failed) == len(result.constraint_results)
        assert all(r.value is not None for r in failed)

    def test_warning_level_degrades_status_not_constraints(self):
        rng = np.random.default_rng(18)
        check = DriftCheck(CheckLevel.WARNING, "w").has_no_mean_drift(
            "x", max_relative_delta=1e-9
        )
        result = check.evaluate(
            current=_bag(rng), baseline=_bag(rng)
        )
        assert result.status == CheckStatus.WARNING

    def test_missing_baseline_state_fails_with_dq324(self):
        rng = np.random.default_rng(19)
        current = _bag(rng)
        thin = StateBag.from_pairs(
            [(Mean("x"), current.get(Mean("x")))], signature="sig-A"
        )
        check = (
            DriftCheck(CheckLevel.ERROR, "w")
            .has_no_mean_drift("x")
            .has_no_completeness_drift("x")
        )
        result = check.evaluate(current=current, baseline=thin)
        by_desc = {
            r.constraint.description.split(" <=")[0]: r.status
            for r in result.constraint_results
        }
        assert by_desc["mean drift of 'x'"] == ConstraintStatus.SUCCESS
        assert by_desc["completeness drift of 'x'"] == ConstraintStatus.FAILURE
        assert any(d.code == "DQ324" for d in result.diagnostics)

    def test_signature_mismatch_fails_everything_with_dq324(self):
        rng = np.random.default_rng(20)
        a = _bag(rng)
        b = _bag(rng)
        b.signature = "sig-OTHER"
        result = self.CHECK.evaluate(current=a, baseline=b)
        assert result.status == CheckStatus.ERROR
        assert all(
            r.status == ConstraintStatus.FAILURE
            for r in result.constraint_results
        )
        assert any(d.code == "DQ324" for d in result.diagnostics)

    def test_unknown_signatures_are_not_a_mismatch(self):
        rng = np.random.default_rng(21)
        a = _bag(rng)
        b = _bag(rng)
        a.signature = None
        result = self.CHECK.evaluate(current=a, baseline=b)
        assert result.status == CheckStatus.SUCCESS

    def test_has_no_drift_bundle(self):
        rng = np.random.default_rng(22)
        check = DriftCheck(CheckLevel.ERROR, "bundle").has_no_drift(
            "x",
            max_quantile_shift=0.1,
            max_cardinality_drift=0.5,
            max_completeness_delta=0.05,
            max_mean_delta=0.05,
        )
        # cardinality rides column 'x' here: give both bags an x-HLL
        analyzers = list(ANALYZERS) + [ApproxCountDistinct("x")]

        def bag(**kw):
            pairs = _fold(analyzers, _table(rng, 900, **kw))
            return StateBag.from_pairs(pairs, signature="s")

        assert (
            check.evaluate(current=bag(), baseline=bag()).status
            == CheckStatus.SUCCESS
        )
        skew = check.evaluate(
            current=bag(mean=95.0, scale=30.0, nulls=0.4),
            baseline=bag(),
        )
        assert skew.status == CheckStatus.ERROR

    def test_min_mode_frequency_constraint(self):
        """p-value constraints pass when the value is ABOVE threshold
        (mode='min'), the inverse of every drift-magnitude bound."""
        check = DriftCheck(CheckLevel.ERROR, "freq").has_no_frequency_drift(
            "s", min_p_value=0.01
        )
        [constraint] = check.constraints
        assert constraint.mode == "min"
        stable = _freq({"a": 500, "b": 300})
        shifted = _freq({"a": 100, "b": 700})
        from deequ_tpu_torch.analyzers import CountDistinct

        analyzer = CountDistinct(["s"])
        good = check.evaluate(
            current=StateBag.from_pairs([(analyzer, stable)]),
            baseline=StateBag.from_pairs([(analyzer, _freq({"a": 495, "b": 305}))]),
        )
        assert good.status == CheckStatus.SUCCESS
        bad = check.evaluate(
            current=StateBag.from_pairs([(analyzer, shifted)]),
            baseline=StateBag.from_pairs([(analyzer, stable)]),
        )
        assert bad.status == CheckStatus.ERROR
        [r] = bad.constraint_results
        assert r.value is not None and r.value < 0.01


# ---------------------------------------------------------------------------
# the JAX package's drift functions on the same states
# ---------------------------------------------------------------------------


def _carried(state):
    """The port's copy of a JAX-package state (deequ_tpu_torch/interop.py)."""
    import dataclasses

    from deequ_tpu_torch.interop import state_from_reference

    kind = type(state).__name__
    if kind == "ApproxQuantileState":
        k, n, levels = state.digest.to_arrays()
        fields = {"k": k, "n": n, "levels": levels, "rng_state": state.digest.rng_state_bytes()}
    elif kind == "FrequenciesAndNumRows":
        fields = {"columns": state.columns, "key_columns": state.key_columns,
                  "counts": state.counts, "num_rows": state.num_rows}
    else:
        fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    return state_from_reference(kind, fields)


def _close(got, want):
    if isinstance(want, int) or want in (0.0, 1.0) or math.isinf(want):
        assert got == want
    else:
        assert got == pytest.approx(want, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("shift", [0.0, 0.4, 5.0])
def test_drift_statistics_equal_jax_on_carried_states(shift, monkeypatch):
    import deequ_tpu.analyzers as J
    from deequ_tpu.analyzers import drift as jdrift
    from deequ_tpu_torch.analyzers import drift as pdrift

    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    janalyzers = [J.ApproxQuantile("x", 0.5), J.ApproxCountDistinct("g"), J.Completeness("x"),
                  J.Mean("x"), J.StandardDeviation("x")]
    measures = ["quantile_drift", "cardinality_drift", "completeness_drift", "mean_drift", "stddev_drift"]
    from deequ_tpu.data.table import ColumnType as JType
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.ops.fused import FusedScanPass as JPass

    def states(seed, mean):
        data = _table(np.random.default_rng(seed), 3000, mean=mean, nulls=0.05 + shift / 100)
        jtable = JTable.from_pydict(data.to_pydict(), types={"x": JType.DOUBLE, "g": JType.LONG})
        return [r.state for r in JPass(janalyzers).run(jtable)]

    base, cur = states(81, 50.0), states(82, 50.0 + shift)
    for name, jb, jc in zip(measures, base, cur):
        want = float(getattr(jdrift, name)(jc, jb))
        got = float(getattr(pdrift, name)(_carried(jc), _carried(jb)))
        _close(got, want)


def test_frequency_chi_square_equals_jax_on_carried_states():
    from deequ_tpu.analyzers import drift as jdrift
    from deequ_tpu.analyzers.frequency import FrequenciesAndNumRows as JFreq
    from deequ_tpu_torch.analyzers import drift as pdrift

    rng = np.random.default_rng(5)
    for _ in range(20):
        keys_a = rng.choice(40, size=int(rng.integers(1, 30)), replace=False)
        keys_b = rng.choice(40, size=int(rng.integers(1, 30)), replace=False)
        ja = JFreq(["c"], [np.array(keys_a, dtype=object)], rng.integers(1, 500, len(keys_a)), 0)
        jb = JFreq(["c"], [np.array(keys_b, dtype=object)], rng.integers(1, 500, len(keys_b)), 0)
        want = jdrift.frequency_chi_square(ja, jb)
        got = pdrift.frequency_chi_square(_carried(ja), _carried(jb))
        assert got.dof == want.dof
        _close(got.statistic, want.statistic)
        _close(got.p_value, want.p_value)


def test_regularized_gamma_q_equals_jax():
    from deequ_tpu.analyzers.drift import regularized_gamma_q as jq

    rng = np.random.default_rng(3)
    for a, x in zip(rng.uniform(0.05, 60, 400), rng.uniform(0, 120, 400)):
        assert regularized_gamma_q(float(a), float(x)) == jq(float(a), float(x))


def test_drift_check_verdicts_equal_jax_on_carried_states(monkeypatch):
    from deequ_tpu.analyzers.drift import StateBag as JBag
    from deequ_tpu.checks import CheckLevel as JLevel
    from deequ_tpu.checks import DriftCheck as JDriftCheck
    from deequ_tpu.data.table import ColumnType as JType
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.ops.fused import FusedScanPass as JPass

    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")

    def build(mod_check, level):
        return (mod_check(level.ERROR, "drift")
                .has_no_quantile_drift("x", 0.05)
                .has_no_cardinality_drift("g", 0.1)
                .has_no_completeness_drift("x", 0.02)
                .has_no_mean_drift("x", 0.01)
                .has_no_stddev_drift("x", 0.05))

    jcheck, pcheck = build(JDriftCheck, JLevel), build(DriftCheck, CheckLevel)
    janalyzers = jcheck.required_analyzers()
    assert [repr(a) for a in pcheck.required_analyzers()] == [repr(a) for a in janalyzers]

    def bag(seed, mean):
        data = _table(np.random.default_rng(seed), 3000, mean=mean)
        jtable = JTable.from_pydict(data.to_pydict(), types={"x": JType.DOUBLE, "g": JType.LONG})
        pairs = [(r.analyzer, r.state) for r in JPass(janalyzers).run(jtable)]
        return JBag.from_pairs(pairs), StateBag.from_pairs(
            [(p, _carried(s)) for p, (_a, s) in zip(pcheck.required_analyzers(), pairs)]
        )

    jbase, pbase = bag(91, 50.0)
    for seed, mean in ((92, 50.0), (93, 51.5)):
        jcur, pcur = bag(seed, mean)
        want = jcheck.evaluate(current=jcur, baseline=jbase)
        got = pcheck.evaluate(current=pcur, baseline=pbase)
        assert got.status.name == want.status.name
        for g, w in zip(got.constraint_results, want.constraint_results):
            assert g.status.name == w.status.name
            _close(g.value, w.value)
