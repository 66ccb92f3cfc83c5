"""Row-group pushdown tests.

Covers the interval lattice, the three-valued stats interpreter and its
NaN/NULL soundness edge cases (all-NULL groups, NaN-polluted float
min/max, untrusted string min/max, absent statistics), the prune-plan
skip/elision rules and the exact decode-batch replay, the
ParquetSource prune/projection composition, the end-to-end skip path
(the trace's rg_* counters and `prune` span, `cost_drift`, the
`runtime.monitored()` counts, bit-identical metrics vs DEEQU_TPU_PUSHDOWN=0,
predicted == observed skipped groups), and the DQ310/DQ311 lints.

Port-mapped from tests/test_pushdown.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import math

import numpy as np
import pytest

from deequ_tpu_torch.analyzers import Completeness, Compliance, Maximum, Mean, Size
from deequ_tpu_torch.data.expr import parse
from deequ_tpu_torch.data.table import ColumnType, Table
from deequ_tpu_torch.lint import explain_plan
from deequ_tpu_torch.lint.fold import dnf_branches
from deequ_tpu_torch.lint.cost import cost_drift
from deequ_tpu_torch.lint.interval import Interval
from deequ_tpu_torch.lint.pushdown import (
    ALL_FALSE,
    ALL_TRUE,
    UNKNOWN,
    ColumnStats,
    RowGroupStats,
    build_prune_plan,
    predicate_verdict,
)
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.runners import AnalysisRunner

pytestmark = pytest.mark.usefixtures("cpu_default")

TYPES = {
    "k": ColumnType.LONG,
    "v": ColumnType.DOUBLE,
    "s": ColumnType.STRING,
}


def group(rows=1000, index=0, **cols):
    """RowGroupStats from kwargs: k=(min, max, null_count) tuples."""
    built = {
        name: ColumnStats(min_value=mn, max_value=mx, null_count=nc)
        for name, (mn, mx, nc) in cols.items()
    }
    return RowGroupStats(index=index, num_rows=rows, columns=built)


def verdict(text, grp, types=TYPES):
    branches = dnf_branches(parse(text))
    assert branches is not None
    return predicate_verdict(branches, grp, types)


# ---------------------------------------------------------------------------
# interval lattice
# ---------------------------------------------------------------------------


class TestInterval:
    def test_from_cmp_shapes(self):
        assert Interval.from_cmp("eq", 3.0) == Interval.point(3.0)
        lt = Interval.from_cmp("lt", 3.0)
        assert lt.hi == 3.0 and lt.hi_strict and lt.lo == -math.inf
        ge = Interval.from_cmp("ge", 3.0)
        assert ge.lo == 3.0 and not ge.lo_strict and ge.hi == math.inf
        with pytest.raises(ValueError):
            Interval.from_cmp("ne", 3.0)

    def test_narrow_tightens_and_strictness_wins_on_ties(self):
        iv = Interval.top().narrow("ge", 0.0).narrow("le", 10.0)
        assert iv == Interval.closed(0.0, 10.0)
        # same bound, strict beats non-strict
        assert iv.narrow("gt", 0.0).lo_strict
        # looser bound never widens
        assert iv.narrow("ge", -5.0) == iv

    def test_emptiness_and_points(self):
        assert Interval.closed(5.0, 1.0).is_empty
        assert Interval.top().narrow("gt", 3.0).narrow("lt", 3.0).is_empty
        assert Interval.top().narrow("ge", 3.0).narrow("le", 3.0).is_point
        assert not Interval.closed(1.0, 2.0).is_empty

    def test_contains_and_disjoint(self):
        dom = Interval.closed(0.0, 10.0)
        assert Interval.from_cmp("ge", -1.0).contains(dom)
        assert not Interval.from_cmp("gt", 0.0).contains(dom)
        assert dom.disjoint(Interval.from_cmp("gt", 10.0))
        assert not dom.disjoint(Interval.from_cmp("ge", 10.0))
        assert dom.contains_point(10.0)
        assert not Interval.from_cmp("lt", 10.0).contains_point(10.0)


# ---------------------------------------------------------------------------
# atom/predicate verdicts over synthetic statistics
# ---------------------------------------------------------------------------


class TestVerdicts:
    def test_long_range_reasoning(self):
        g = group(k=(0, 10, 0))
        assert verdict("k > 100", g) == ALL_FALSE
        assert verdict("k < 0", g) == ALL_FALSE
        assert verdict("k > 5", g) == UNKNOWN
        assert verdict("k >= 0", g) == ALL_TRUE
        assert verdict("k <= 10", g) == ALL_TRUE

    def test_long_all_true_needs_zero_nulls(self):
        # a null row evaluates FALSE under any comparison, so containment
        # alone cannot prove all-true
        g = group(k=(0, 10, 3))
        assert verdict("k >= 0", g) == UNKNOWN
        assert verdict("k > 100", g) == ALL_FALSE

    def test_double_never_proves_all_true(self):
        # parquet stats ignore NaN and the engine folds NaN into the null
        # mask at decode: null_count==0 does NOT mean no runtime nulls
        g = group(v=(0.0, 10.0, 0))
        assert verdict("v >= -5", g) == UNKNOWN
        assert verdict("v > 100", g) == ALL_FALSE

    def test_all_null_group_falsifies_comparisons(self):
        g = group(rows=100, v=(None, None, 100), k=(None, None, 100))
        assert verdict("v > 0", g) == ALL_FALSE
        assert verdict("k != 7", g) == ALL_FALSE
        assert verdict("v IS NULL", g) == ALL_TRUE
        assert verdict("v IS NOT NULL", g) == ALL_FALSE

    def test_nan_polluted_min_max_degrades_to_unknown(self):
        g = group(v=(float("nan"), float("nan"), 0))
        assert verdict("v > 100", g) == UNKNOWN
        assert verdict("v < -100", g) == UNKNOWN

    def test_string_min_max_never_consulted(self):
        # even "usable-looking" string bounds stay untrusted (writers may
        # truncate them); only null_count reasoning applies to strings
        g = group(s=("aaa", "bbb", 0))
        assert verdict("s > 'zzz'", g) == UNKNOWN
        assert verdict("s = 'x'", g) == UNKNOWN
        assert verdict("s IS NOT NULL", g) == ALL_TRUE
        assert verdict("s IS NULL", g) == ALL_FALSE

    def test_double_null_atom_stays_unknown_at_zero_nulls(self):
        # null_count is only a LOWER bound for DOUBLE (hidden NaN)
        g = group(v=(0.0, 1.0, 0))
        assert verdict("v IS NOT NULL", g) == UNKNOWN
        assert verdict("v IS NULL", g) == UNKNOWN

    def test_missing_stats_degrade_to_unknown(self):
        g = RowGroupStats(index=0, num_rows=10, columns={})
        assert verdict("k > 5", g) == UNKNOWN
        assert verdict("k IS NULL", g) == UNKNOWN

    def test_empty_group_is_all_false(self):
        g = group(rows=0, k=(None, None, 0))
        assert verdict("k >= 0", g) == ALL_FALSE

    def test_ne_semantics(self):
        const = group(k=(7, 7, 0))
        assert verdict("k != 7", const) == ALL_FALSE
        wide = group(k=(0, 10, 0))
        assert verdict("k != 100", wide) == ALL_TRUE
        assert verdict("k != 5", wide) == UNKNOWN
        # DOUBLE: outside-range != cannot prove all-true (hidden NaN)
        dbl = group(v=(0.0, 10.0, 0))
        assert verdict("v != 100", dbl) == UNKNOWN
        assert verdict("v != 7", group(v=(7.0, 7.0, 0))) == ALL_FALSE

    def test_boolean_combinations(self):
        g = group(k=(0, 10, 0))
        assert verdict("k > 100 or k < -5", g) == ALL_FALSE
        assert verdict("k >= 0 and k <= 10", g) == ALL_TRUE
        assert verdict("k > 5 or k >= 0", g) == ALL_TRUE
        # atoms are judged independently against the statistics;
        # intra-clause unsatisfiability (k > 5 and k < 3) is DQ204's job
        assert verdict("k > 5 and k < 3", g) == UNKNOWN
        assert verdict("k > 5 and k > 100", g) == ALL_FALSE
        assert verdict("k > 5 or s = 'x'", g) == UNKNOWN


# ---------------------------------------------------------------------------
# prune plan: skip rule, elision, decode replay
# ---------------------------------------------------------------------------


GROUPS = [
    group(rows=100, index=0, k=(0, 9, 0)),
    group(rows=100, index=1, k=(10, 19, 0)),
    group(rows=100, index=2, k=(20, 29, 0)),
]


class TestPrunePlan:
    def test_skips_groups_proven_all_false_by_every_predicate(self):
        plan = build_prune_plan(["k < 10", "k < 15"], GROUPS, TYPES)
        assert plan.prunable
        # group 1 overlaps "k < 15" -> survives; group 2 is all-false for both
        assert plan.skip == frozenset({2})
        assert plan.skipped_rows == 100 and plan.decoded_rows == 200

    def test_unfiltered_member_blocks_all_skipping(self):
        plan = build_prune_plan(["k < 10", None], GROUPS, TYPES)
        assert not plan.prunable
        assert plan.skip == frozenset()
        # verdicts still computed (EXPLAIN shows them) — just never acted on
        assert plan.predicates[0].verdicts[2] == ALL_FALSE

    def test_no_members_means_nothing_to_prune(self):
        plan = build_prune_plan([], GROUPS, TYPES)
        assert not plan.prunable and plan.skip == frozenset()

    def test_duplicate_texts_analyzed_once(self):
        plan = build_prune_plan(["k < 10", "k < 10"], GROUPS, TYPES)
        assert len(plan.predicates) == 1

    def test_elision_judged_on_surviving_groups_only(self):
        # "k >= 10" is FALSE on group 0 and TRUE on groups 1-2; with
        # group 0 skipped, the filter is constant-true on what decodes
        plan = build_prune_plan(["k >= 10"], GROUPS, TYPES)
        assert plan.skip == frozenset({0})
        assert plan.elided_wheres() == ("k >= 10",)

    def test_proven_empty_keeps_one_sentinel_group(self):
        # everything provably all-false: one group (the cheapest) still
        # decodes so the filtered-empty result matches an unpruned scan
        plan = build_prune_plan(["k < -1"], GROUPS, TYPES)
        assert plan.proven_empty
        assert plan.skip == frozenset({1, 2})
        assert plan.elided_wheres() == ()

    def test_ineligible_predicate_never_elides(self):
        plan = build_prune_plan(["s = 'x'"], GROUPS, TYPES)
        assert plan.skip == frozenset()
        assert not plan.predicates[0].eligible
        assert plan.elided_wheres() == ()

    def test_batch_replay_coalesces_tiny_groups(self):
        # replays _iter_tables: groups under size//4 accumulate until a
        # flush; big groups flush pending first, then slice themselves
        plan = build_prune_plan(
            ["k < 0"],
            [
                group(rows=10, index=0, k=(0, 1, 0)),
                group(rows=10, index=1, k=(2, 3, 0)),
                group(rows=10, index=2, k=(4, 5, 0)),
                group(rows=1000, index=3, k=(6, 7, 0)),
            ],
            TYPES,
        )
        assert plan.predicted_batch_rows(100, pruned=False) == (
            30,
        ) + (100,) * 10
        # proven empty -> the cheapest group (10 rows, lowest index)
        # survives as the sentinel and becomes the only batch
        assert plan.skip == frozenset({1, 2, 3})
        assert plan.predicted_batch_rows(100, pruned=True) == (10,)

    def test_batch_replay_respects_skip_set(self):
        plan = build_prune_plan(["k < 15"], GROUPS, TYPES)
        assert plan.skip == frozenset({2})
        # 100-row groups are not tiny at batch 150 (tiny = 37): each
        # flushes as its own batch, exactly as _iter_tables does
        assert plan.predicted_batch_rows(150, pruned=True) == (100, 100)
        assert plan.predicted_batch_rows(150, pruned=False) == (100, 100, 100)


# ---------------------------------------------------------------------------
# eligibility reasons (DQ310 inputs)
# ---------------------------------------------------------------------------


class TestEligibility:
    def pred(self, text, groups=GROUPS, types=TYPES):
        return build_prune_plan([text], groups, types).predicates[0]

    def test_string_comparison_blocked_with_span(self):
        p = self.pred("k < 10 and s = 'x'")
        assert not p.eligible
        assert "string min/max" in p.reason
        # the caret anchors on the offending subexpression, not the whole
        a, b = p.span
        assert "s = 'x'" == "k < 10 and s = 'x'"[a:b]

    def test_computed_expression_blocked(self):
        p = self.pred("k + 1 > 3")
        assert not p.eligible
        assert "column-vs-literal" in p.reason

    def test_missing_column_blocked(self):
        p = self.pred("zz > 3")
        assert not p.eligible and "not in the scanned schema" in p.reason

    def test_unparseable_blocked(self):
        p = self.pred("k <<< 3")
        assert not p.eligible and p.reason == "predicate does not parse"
        assert p.verdicts == (UNKNOWN,) * len(GROUPS)

    def test_absent_statistics_reported(self):
        bare = [RowGroupStats(index=0, num_rows=10, columns={})]
        p = self.pred("k > 3", groups=bare)
        assert not p.eligible
        assert "no statistics recorded for column 'k'" in p.reason

    def test_eligible_but_overlapping_stays_silent(self):
        p = self.pred("k > 5", groups=[group(k=(0, 10, 1))])
        assert p.eligible and p.reason is None


# ---------------------------------------------------------------------------
# parquet fixture for source + end-to-end coverage
# ---------------------------------------------------------------------------

N_ROWS = 10_000
GROUP_ROWS = 1_000


@pytest.fixture(scope="module")
def parquet_path(tmp_path_factory):
    """10 row groups of 1000 rows, sorted by k so group min/max are
    selective; group 2's v column is entirely NULL; v carries NaN."""
    k = list(range(N_ROWS))
    v = [float(i % 97) - 48.0 for i in range(N_ROWS)]
    for i in range(0, N_ROWS, 53):
        v[i] = float("nan")
    for i in range(2 * GROUP_ROWS, 3 * GROUP_ROWS):
        v[i] = None
    s = [None if i % 11 == 0 else f"v{i % 5}" for i in range(N_ROWS)]
    table = Table.from_pydict(
        {"k": k, "v": v, "s": s},
        types={"k": ColumnType.LONG, "v": ColumnType.DOUBLE, "s": ColumnType.STRING},
    )
    path = str(tmp_path_factory.mktemp("pushdown") / "data.parquet")
    table.to_parquet(path, row_group_size=GROUP_ROWS)
    return path


def scan(path, batch_rows=2048):
    return Table.scan_parquet(path, batch_rows=batch_rows)


class TestParquetSourceStats:
    def test_row_group_stats_shape(self, parquet_path):
        stats = scan(parquet_path).row_group_stats()
        assert [g.num_rows for g in stats] == [GROUP_ROWS] * 10
        assert [g.index for g in stats] == list(range(10))
        first = stats[0].columns["k"]
        assert float(first.min_value) == 0.0
        assert float(first.max_value) == float(GROUP_ROWS - 1)
        assert first.null_count == 0

    def test_all_null_group_visible_in_stats(self, parquet_path):
        stats = scan(parquet_path).row_group_stats()
        assert stats[2].columns["v"].null_count == GROUP_ROWS
        types = {"k": ColumnType.LONG, "v": ColumnType.DOUBLE}
        assert verdict("v > 0", stats[2], types) == ALL_FALSE

    def test_prune_skips_groups_and_adjusts_num_rows(self, parquet_path):
        src = scan(parquet_path).with_prune(frozenset({0, 1, 2}))
        assert src.num_rows == 7 * GROUP_ROWS
        decoded = sum(t.num_rows for t in src.batches(4096))
        assert decoded == 7 * GROUP_ROWS

    def test_prune_and_projection_compose_both_ways(self, parquet_path):
        a = scan(parquet_path).with_prune(frozenset({9})).with_columns(["k"])
        b = scan(parquet_path).with_columns(["k"]).with_prune(frozenset({9}))
        for src in (a, b):
            assert src.prune_groups == frozenset({9})
            assert src.num_rows == 9 * GROUP_ROWS
            assert [n for n, _ in src.schema] == ["k"]

    def test_prune_sets_union(self, parquet_path):
        src = scan(parquet_path).with_prune(frozenset({1}))
        src = src.with_prune(frozenset({2}))
        assert src.prune_groups == frozenset({1, 2})

    def test_prune_everything_yields_empty_fallback(self, parquet_path):
        src = scan(parquet_path).with_prune(frozenset(range(10)))
        batches = list(src.batches(4096))
        assert len(batches) == 1 and batches[0].num_rows == 0


# ---------------------------------------------------------------------------
# end to end: skip counts, bit-identical metrics, prediction == the run
# ---------------------------------------------------------------------------


WHERE = f"k < {GROUP_ROWS + GROUP_ROWS // 2}"  # groups 0-1 survive
ANALYZERS = [
    Size(where=WHERE),
    Mean("v", where=WHERE),
    Completeness("s", where=WHERE),
    Compliance("v in range", "v >= -48", where=WHERE),
]


def run_traced(path, monkeypatch, pushdown, analyzers=ANALYZERS):
    """The traced run (its RunTrace carries the rg_* counters and the
    `prune` span, as in the JAX package's copy) and its
    `runtime.monitored()` counts (the port also keeps the rows skipped
    and the wheres elided there)."""
    monkeypatch.setenv("DEEQU_TPU_PUSHDOWN", pushdown)
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host")
    with runtime.monitored() as stats:
        ctx = AnalysisRunner.on_data(scan(path)).with_tracing(True).add_analyzers(analyzers).run()
    return ctx, stats


def metric_values(ctx):
    out = {}
    for analyzer, metric in ctx.metric_map.items():
        v = metric.value
        if v.is_success:
            value = v.get()
            if isinstance(value, float) and math.isnan(value):
                value = "nan"  # nan != nan would defeat the comparison
            out[repr(analyzer)] = ("OK", value)
        else:
            out[repr(analyzer)] = ("FAIL", type(v.exception).__name__)
    return out


class TestEndToEnd:
    def test_skips_counted_and_metrics_bit_identical(self, parquet_path, monkeypatch):
        on, on_stats = run_traced(parquet_path, monkeypatch, "1")
        off, off_stats = run_traced(parquet_path, monkeypatch, "0")
        assert on_stats.rg_total == 10
        assert on_stats.rg_skipped == 8
        assert off_stats.rg_total == 0 and off_stats.rg_skipped == 0
        assert on.run_trace.counters["rg_total"] == 10
        assert on.run_trace.counters["rg_skipped"] == 8
        assert "rg_skipped" not in off.run_trace.counters
        assert metric_values(on) == metric_values(off)

    def test_prune_span_records_decision(self, parquet_path, monkeypatch):
        ctx, stats = run_traced(parquet_path, monkeypatch, "1")
        assert stats.rg_total == 10
        assert stats.rg_skipped == 8
        assert stats.rg_rows_skipped == 8 * GROUP_ROWS
        spans = [sp for sp in ctx.run_trace.spans() if sp.name == "prune"]
        assert len(spans) == 1
        attrs = spans[0].attrs
        assert attrs["groups_total"] == 10
        assert attrs["groups_skipped"] == 8
        assert attrs["rows_skipped"] == 8 * GROUP_ROWS

    def test_predicted_skips_match_observed_trace(self, parquet_path, monkeypatch):
        ctx, stats = run_traced(parquet_path, monkeypatch, "1")
        scan_cost = ctx.plan_cost.scan_pass
        assert scan_cost.rg_total == 10
        assert scan_cost.rg_skipped == 8
        assert scan_cost.saved_read_bytes > 0
        assert scan_cost.rg_skipped == stats.rg_skipped
        assert ctx.plan_cost.counters["device_passes"] == stats.device_passes
        # groups 0-1 survive, one batch each (1,000 rows >= 2,048 / 4 is
        # no tiny group), as the pruned source yields them
        survivors = scan(parquet_path).with_prune(frozenset(range(2, 10)))
        assert scan_cost.n_batches == 2 == len(list(survivors.batches(4096)))
        drift = cost_drift(ctx.plan_cost, ctx.run_trace)
        assert drift["drift.rg_skipped"] == 0.0
        assert drift["drift.batches"] == 0.0
        assert all(v == 0.0 for k, v in drift.items() if k.startswith(("drift.counter.", "drift.span.")))

    def test_pushdown_off_predicts_zero_skips(self, parquet_path, monkeypatch):
        ctx, stats = run_traced(parquet_path, monkeypatch, "0")
        scan_cost = ctx.plan_cost.scan_pass
        assert scan_cost.rg_total == 10
        assert scan_cost.rg_skipped == 0
        assert stats.rg_skipped == 0
        assert scan_cost.n_batches == 10 == len(list(scan(parquet_path).batches(4096)))
        assert cost_drift(ctx.plan_cost, ctx.run_trace)["drift.batches"] == 0.0

    def test_unfiltered_member_disables_skipping(self, parquet_path, monkeypatch):
        ctx, stats = run_traced(
            parquet_path, monkeypatch, "1", analyzers=ANALYZERS + [Maximum("k")]
        )
        assert stats.rg_skipped == 0
        assert stats.rg_total == 10
        assert ctx.run_trace.counters.get("rg_skipped", 0) == 0
        assert ctx.run_trace.counters["rg_total"] == 10

    def test_all_groups_skipped_matches_off(self, parquet_path, monkeypatch):
        impossible = [
            Size(where="k < 0"),
            Mean("v", where="k < 0"),
            Completeness("s", where="k < 0"),
        ]
        on, on_stats = run_traced(parquet_path, monkeypatch, "1", analyzers=impossible)
        off, _ = run_traced(parquet_path, monkeypatch, "0", analyzers=impossible)
        # one sentinel group decodes (filtered-empty == unpruned scan)
        assert on_stats.rg_skipped == 9
        assert on.run_trace.counters["rg_skipped"] == 9
        assert on.plan_cost.scan_pass.rg_skipped == 9
        assert metric_values(on) == metric_values(off)

    def test_all_true_where_elides(self, parquet_path, monkeypatch):
        # k >= 0 holds on every group: nothing skips, but the filter
        # becomes a constant mask (no runtime predicate evaluation)
        always = [Size(where="k >= 0"), Completeness("s", where="k >= 0")]
        on, on_stats = run_traced(parquet_path, monkeypatch, "1", analyzers=always)
        off, off_stats = run_traced(parquet_path, monkeypatch, "0", analyzers=always)
        assert on_stats.wheres_elided == 1 and off_stats.wheres_elided == 0
        assert on_stats.rg_skipped == 0 and on_stats.rg_total == 10
        spans = [sp for sp in on.run_trace.spans() if sp.name == "prune"]
        assert spans and spans[0].attrs["wheres_elided"] == 1
        assert spans[0].attrs["groups_skipped"] == 0
        assert metric_values(on) == metric_values(off)


# ---------------------------------------------------------------------------
# EXPLAIN + DQ310/DQ311
# ---------------------------------------------------------------------------


class TestExplainIntegration:
    def test_explain_reports_row_group_prediction(self, parquet_path):
        result = explain_plan(scan(parquet_path), analyzers=ANALYZERS)
        scan_cost = result.cost.scan_pass
        assert scan_cost.rg_total == 10 and scan_cost.rg_skipped == 8
        text = result.render()
        assert "row groups: 2 decoded, 8 skipped statically" in text

    def test_dq310_fires_on_ineligible_where_with_caret(self, parquet_path):
        analyzers = [
            Size(where="s = 'v1'"),
            Completeness("v", where="s = 'v1'"),
        ]
        result = explain_plan(scan(parquet_path), analyzers=analyzers)
        diags = [d for d in result.diagnostics if d.code == "DQ310"]
        assert len(diags) == 1  # distinct texts analyzed once
        d = diags[0]
        assert d.source == "s = 'v1'" and d.span is not None
        assert "^" in d.render()
        assert "string min/max" in d.message

    def test_dq310_silent_on_eligible_wheres(self, parquet_path):
        result = explain_plan(scan(parquet_path), analyzers=ANALYZERS)
        assert "DQ310" not in [d.code for d in result.diagnostics]

    def test_dq311_fires_when_everything_prunes(self, parquet_path):
        analyzers = [Size(where="k < 0"), Mean("v", where="k < 0")]
        result = explain_plan(scan(parquet_path), analyzers=analyzers)
        assert "DQ311" in [d.code for d in result.diagnostics]

    def test_dq311_silent_when_groups_survive(self, parquet_path):
        result = explain_plan(scan(parquet_path), analyzers=ANALYZERS)
        assert "DQ311" not in [d.code for d in result.diagnostics]

    def test_in_memory_table_unaffected(self):
        table = Table.from_pydict({"v": np.arange(50, dtype=np.float64)})
        result = explain_plan(table, analyzers=[Mean("v", where="v < 10")])
        assert result.cost.scan_pass.rg_total is None
        assert result.cost.prune is None
