"""Compliance and PatternMatch: the port's fused pass on device="cpu"
against the JAX package's, with and without a `where`, over the four
built-in Patterns and SQL predicates. The states are counts
(NumMatchesAndCount): they must be equal, and so the metrics."""

from __future__ import annotations

import numpy as np
import pytest

from deequ_tpu.analyzers.scan import Compliance as JCompliance
from deequ_tpu.analyzers.scan import PatternMatch as JPatternMatch
from deequ_tpu.analyzers.scan import Patterns as JPatterns
from deequ_tpu.data.table import Table as JTable
from deequ_tpu.ops.fused import FusedScanPass as JPass
from deequ_tpu.runners.analysis_runner import AnalysisRunner as JRunner
from deequ_tpu_torch.analyzers.scan import Compliance, PatternMatch, Patterns
from deequ_tpu_torch.data.table import Table as PTable
from deequ_tpu_torch.ops.fused import FusedScanPass as PPass
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner as PRunner

TEXTS = np.array(
    [
        "mail me at someone@example.com", "http://example.org/x", "ftp://files.example",
        "see https://a.b", "123-45-6789", "123 45 6789", "666-12-3456", "4111 1111 1111 1111",
        "378282246310005", "nothing here", "", None,
    ],
    dtype=object,
)
WHERES = [None, "n > 1", "n IS NULL"]
PATTERNS = ["EMAIL", "URL", "SOCIAL_SECURITY_NUMBER_US", "CREDITCARD"]
PREDICATES = ["n > 1", "x > 0 OR x IS NULL", "COALESCE(x, 0.0) >= 0", "s IN ('ok','warn')", "x / n > 1"]


@pytest.fixture(autouse=True)
def _device_placement(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    n = 1200
    x = rng.normal(0.5, 1.0, n)
    x[::5] = np.nan
    n_col = rng.integers(0, 4, n).astype(np.float64)
    n_col[::7] = np.nan
    return {
        "text": TEXTS[rng.integers(0, len(TEXTS), n)],
        "s": np.array(["ok", "warn", "err", None], dtype=object)[rng.integers(0, 4, n)],
        "x": x,
        "n": n_col,
    }


def states(data, jan, pan, batch_size=500):
    jres = JPass(jan, batch_size=batch_size).run(JTable.from_numpy(data))
    pres = PPass(pan, batch_size=batch_size, device="cpu").run(PTable.from_numpy(data))
    return [r.state_or_raise() for r in jres], [r.state_or_raise() for r in pres]


def assert_same(jan, pan, jstates, pstates):
    for ja, pa, js, ps in zip(jan, pan, jstates, pstates):
        assert repr(pa) == repr(ja)
        if js is None:
            assert ps is None
        else:
            assert (ps.num_matches, ps.count) == (js.num_matches, js.count)
        jm, pm = ja.compute_metric_from(js), pa.compute_metric_from(ps)
        assert pm.value.is_success == jm.value.is_success
        if jm.value.is_success:
            assert np.float64(pm.value.get()).tobytes() == np.float64(jm.value.get()).tobytes()
        else:
            assert str(pm.value.exception) == str(jm.value.exception)


@pytest.mark.parametrize("where", WHERES)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_builtin_patterns_equal_jax(data, pattern, where):
    jan = [JPatternMatch("text", getattr(JPatterns, pattern), where)]
    pan = [PatternMatch("text", getattr(Patterns, pattern), where)]
    assert getattr(Patterns, pattern) == getattr(JPatterns, pattern)
    assert_same(jan, pan, *states(data, jan, pan))


@pytest.mark.parametrize("pattern", [r"^(ok|warn)$", r"a*", r"[0-9]+"])
def test_custom_patterns_equal_jax(data, pattern):
    """`a*` matches the empty string everywhere: an empty match is a miss."""
    jan = [JPatternMatch("s", pattern), JPatternMatch("text", pattern, "x > 0")]
    pan = [PatternMatch("s", pattern), PatternMatch("text", pattern, "x > 0")]
    assert_same(jan, pan, *states(data, jan, pan))


@pytest.mark.parametrize("where", WHERES)
@pytest.mark.parametrize("predicate", PREDICATES)
def test_compliance_equals_jax(data, predicate, where):
    jan = [JCompliance("rule", predicate, where)]
    pan = [Compliance("rule", predicate, where)]
    assert_same(jan, pan, *states(data, jan, pan))


def test_empty_criterion_gives_the_empty_state(data):
    """Every row NULL for the criterion: no state, the failure metric."""
    jan = [JCompliance("rule", "x > 0", "x IS NULL"), JPatternMatch("text", "a", "n > 100")]
    pan = [Compliance("rule", "x > 0", "x IS NULL"), PatternMatch("text", "a", "n > 100")]
    jstates, pstates = states(data, jan, pan)
    assert pstates == [None, None] == jstates
    assert_same(jan, pan, jstates, pstates)


def test_failing_inputs_fail_the_metric_alone(data):
    """A non-string column for PatternMatch and an unparsable predicate
    fail their own metric; the others still run."""
    jan = [JPatternMatch("x", "1"), JCompliance("bad", "x >"), JCompliance("ok", "x > 0")]
    pan = [PatternMatch("x", "1"), Compliance("bad", "x >"), Compliance("ok", "x > 0")]
    jctx = JRunner.do_analysis_run(JTable.from_numpy(data), jan)
    pctx = PRunner.do_analysis_run(PTable.from_numpy(data), pan, device="cpu")
    for ja, pa in zip(jan, pan):
        jm, pm = jctx.metric(ja), pctx.metric(pa)
        assert pm.value.is_success == jm.value.is_success
        if jm.value.is_success:
            assert pm.value.get() == jm.value.get()
        else:
            assert str(pm.value.exception) == str(jm.value.exception)


# -- string-to-number parsing: the JAX package's pandas.to_numeric ------------

PARSE_STRINGS = [
    "٥", "١٢", "٣.٥", "٥٠", "５", "\xa05", "5\xa0", "\xa05\xa0", " 5", "5 ",
    "1_0", "nan", "inf", "1e3", " 5 ", "5", "+5", "5.", ".5", "-0", "x", "",
]


@pytest.mark.parametrize("text", PARSE_STRINGS, ids=lambda t: ascii(t))
def test_parse_floats_equals_jax(text):
    """Each string parses (or fails) exactly as the JAX package's parse."""
    from deequ_tpu.ops.strings import parse_floats as jparse
    from deequ_tpu_torch.ops.strings import parse_floats as pparse

    uniques = np.array([text], dtype=object)
    (jv, jok), (pv, pok) = jparse(uniques), pparse(uniques)
    assert pok.tolist() == jok.tolist()
    assert pv.tobytes() == jv.tobytes()


def test_expr_and_analyzers_agree_on_string_numerics():
    """A Compliance predicate and `numeric_values` see the same rows as
    numeric; the non-ASCII digit and the underscore are not numbers."""
    data = {"s": ["10", "1_0", "٥", "30", "x"]}
    jt, pt = JTable.from_pydict(data), PTable.from_pydict(data)
    results = PPass([Compliance("c", "s >= 0")], device="cpu").run(pt)
    compliance = results[0].analyzer.compute_metric_from(results[0].state_or_raise()).value.get()
    _vals, valid = pt.column("s").numeric_values()
    assert valid.tolist() == [True, False, False, True, False]
    assert compliance == valid.sum() / 5 == 0.4
    jresults = JPass([JCompliance("c", "s >= 0")]).run(jt)
    assert compliance == jresults[0].analyzer.compute_metric_from(
        jresults[0].state_or_raise()
    ).value.get()
