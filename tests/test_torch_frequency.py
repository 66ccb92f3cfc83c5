"""The frequency analyzers: the port's AnalysisRunner on device="cpu"
against the JAX package's, on single and multi-column groups. Counts are
exact; ratios are quotients of exact counts and must be equal; entropy
and mutual information sum logarithms in another order and agree within
1e-12. States carried across merge (tests/test_torch_interop.py)."""

from __future__ import annotations

import numpy as np
import pytest

import deequ_tpu.analyzers.frequency as JF
from deequ_tpu.analyzers.histogram import Histogram as JHistogram
from deequ_tpu.data.table import Table as JTable
from deequ_tpu.runners.analysis_runner import AnalysisRunner as JRunner
import deequ_tpu_torch.analyzers.frequency as PF
from deequ_tpu_torch.analyzers.histogram import Histogram as PHistogram
from deequ_tpu_torch.data.table import Table as PTable
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner as PRunner

SHAREABLE = ["Uniqueness", "Distinctness", "UniqueValueRatio", "CountDistinct"]
GROUPS = [["id"], ["cat"], ["grp"], ["cat", "grp"], ["grp", "id"], ["x"], ["flag"]]
LOGS = {"Entropy", "MutualInformation"}


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(31)
    n = 3000
    cats = np.array(["ok", "warn", "err", "skip", None], dtype=object)
    x = np.round(rng.normal(0, 3, n))
    x[::9] = np.nan
    data = {
        "id": rng.integers(0, 2000, n),
        "cat": cats[rng.integers(0, len(cats), n)],
        "grp": rng.integers(0, 5, n),
        "x": x,
        "flag": np.array([True, False, None], dtype=object)[rng.integers(0, 3, n)],
        "nulls": np.array([None] * n, dtype=object),
    }
    return JTable.from_numpy(data), PTable.from_numpy(data)


def run_both(tables, jan, pan):
    jt, pt = tables
    jctx = JRunner.do_analysis_run(jt, jan)
    pctx = PRunner.do_analysis_run(pt, pan, device="cpu")
    return jctx, pctx


def assert_same(jctx, pctx, jan, pan, name):
    for ja, pa in zip(jan, pan):
        jm, pm = jctx.metric(ja), pctx.metric(pa)
        assert repr(pa) == repr(ja)
        assert (pm.entity.value, pm.name, pm.instance) == (jm.entity.value, jm.name, jm.instance)
        assert pm.value.is_success == jm.value.is_success, (repr(pa), pm, jm)
        if not jm.value.is_success:
            assert str(pm.value.exception) == str(jm.value.exception)
        elif name in LOGS:
            assert abs(pm.value.get() - jm.value.get()) <= 1e-12
        else:
            assert pm.value.get() == jm.value.get()


@pytest.mark.parametrize("name", SHAREABLE)
@pytest.mark.parametrize("columns", GROUPS, ids=lambda c: "+".join(c))
def test_shareable_frequency_analyzers_equal_jax(tables, name, columns):
    jan, pan = [getattr(JF, name)(columns)], [getattr(PF, name)(columns)]
    assert_same(*run_both(tables, jan, pan), jan, pan, name)


@pytest.mark.parametrize("column", ["id", "cat", "grp", "x", "flag", "nulls"])
def test_entropy_equals_jax(tables, column):
    jan, pan = [JF.Entropy(column)], [PF.Entropy(column)]
    assert_same(*run_both(tables, jan, pan), jan, pan, "Entropy")


@pytest.mark.parametrize("pair", [("cat", "grp"), ("grp", "id"), ("x", "cat"), ("cat", "nulls")])
def test_mutual_information_equals_jax(tables, pair):
    jan, pan = [JF.MutualInformation(*pair)], [PF.MutualInformation(*pair)]
    assert_same(*run_both(tables, jan, pan), jan, pan, "MutualInformation")


def test_one_grouping_set_shared_by_all(tables):
    """Every analyzer of one column set in one run, with a failing
    precondition beside them: same metrics as the JAX package's run."""
    names = SHAREABLE + ["Entropy"]
    jan = [getattr(JF, n)("cat") for n in names] + [
        JF.MutualInformation("cat", "grp"), JF.Uniqueness(["missing"]), JF.MutualInformation(["cat"]),
    ]
    pan = [getattr(PF, n)("cat") for n in names] + [
        PF.MutualInformation("cat", "grp"), PF.Uniqueness(["missing"]), PF.MutualInformation(["cat"]),
    ]
    jctx, pctx = run_both(tables, jan, pan)
    for ja, pa in zip(jan, pan):
        assert_same(jctx, pctx, [ja], [pa], ja.name)


@pytest.mark.parametrize("column", ["cat", "grp", "x", "flag", "nulls"])
def test_histogram_equals_jax(tables, column):
    """Histogram (has_number_of_distinct_values) keeps NULLs as a bin."""
    jctx, pctx = run_both(tables, [JHistogram(column)], [PHistogram(column)])
    jd, pd = jctx.metric(JHistogram(column)).value.get(), pctx.metric(PHistogram(column)).value.get()
    assert pd.number_of_bins == jd.number_of_bins
    assert {k: (v.absolute, v.ratio) for k, v in pd.values.items()} == {
        k: (v.absolute, v.ratio) for k, v in jd.values.items()
    }


def test_states_merge_like_one_pass(tables):
    _, pt = tables
    half = pt.num_rows // 2
    a = PF.compute_frequencies(pt.slice(0, half), ["cat", "grp"])
    b = PF.compute_frequencies(pt.slice(half, pt.num_rows), ["grp", "cat"])
    whole = PF.compute_frequencies(pt, ["cat", "grp"])
    assert a.merge(b) == whole
    for name in SHAREABLE:
        analyzer = getattr(PF, name)(["cat", "grp"])
        assert analyzer.compute_metric_from(a.merge(b)) == analyzer.compute_metric_from(whole)
