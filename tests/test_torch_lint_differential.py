"""The port's static analysis against the JAX package's on the same
inputs: seeded random where predicates over seeded random row-group
statistics (NaN and infinite bounds, all-null groups, absent statistics,
strings and doubles) give equal prune plans (`build_prune_plan`), equal
typecheck results (`typecheck.analyze_expression`) and equal
satisfiability verdicts (`fold.satisfiability`), exactly; and
`explain_plan` renders the same text in both packages on every line the
wire bytes do not enter (the port's wire is its own: float64 values,
int16 HLL codes, no row-count scalar).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from deequ_tpu.data.table import ColumnType as JColumnType
from deequ_tpu.lint import fold as jfold
from deequ_tpu.lint import pushdown as jpush
from deequ_tpu.lint import typecheck as jtype
from deequ_tpu.lint.schema import FieldInfo as JFieldInfo
from deequ_tpu.lint.schema import SchemaInfo as JSchemaInfo
from deequ_tpu_torch.data.table import ColumnType
from deequ_tpu_torch.lint import fold, pushdown, typecheck
from deequ_tpu_torch.lint.schema import FieldInfo, SchemaInfo

SEEDS = range(40)
COLUMNS = {"k": "LONG", "v": "DOUBLE", "s": "STRING", "b": "BOOLEAN", "n": "LONG"}


def _types(enum):
    return {name: getattr(enum, t) for name, t in COLUMNS.items()}


def _random_bound(rng, kind):
    if kind == "STRING":
        return rng.choice(["", "a", "m", "zz"])
    r = rng.random()
    if r < 0.08:
        return float("nan")
    if r < 0.14:
        return float(rng.choice([-np.inf, np.inf]))
    if r < 0.18:
        return "garbage"  # an unreadable bound
    if kind == "LONG":
        return int(rng.integers(-20, 20))
    return float(np.round(rng.normal(0, 10), 2))


def _random_groups(rng, stats_cls, groups_cls):
    groups = []
    for g in range(int(rng.integers(1, 7))):
        rows = int(rng.choice([0, 1, 10, 1000]))
        cols = {}
        for name, kind in COLUMNS.items():
            r = rng.random()
            if r < 0.1:
                continue  # the writer recorded nothing for this chunk
            nulls = rng.choice([None, 0, 3, rows])
            if r < 0.2:
                cols[name] = stats_cls(null_count=None if nulls is None else int(nulls))
                continue
            lo, hi = _random_bound(rng, kind), _random_bound(rng, kind)
            if kind != "STRING" and isinstance(lo, (int, float)) and isinstance(hi, (int, float)):
                lo, hi = min(lo, hi), max(lo, hi)
            cols[name] = stats_cls(
                min_value=lo, max_value=hi, null_count=None if nulls is None else int(nulls)
            )
        groups.append(groups_cls(index=g, num_rows=rows, columns=cols))
    return groups


def _random_atom(rng):
    col = rng.choice(["k", "v", "n"])
    op = rng.choice(["<", "<=", ">", ">=", "=", "!="])
    value = rng.choice(["3", "-2.5", "0", "17", "1e9"])
    forms = [
        f"{col} {op} {value}",
        f"{value} {op} {col}",
        f"{col} BETWEEN -3 AND {value}",
        f"{col} NOT BETWEEN 0 AND 5",
        f"{col} IN (1, 2, {value})",
        f"{col} IS NULL",
        f"{col} IS NOT NULL",
        f"s = '{rng.choice(['a', 'm'])}'",
        "s IS NULL",
        "b = true",
        f"{col} + 1 > 2",
        "1 = 1",
        "1 = 0",
        "NULL",
        f"{col} > NULL",
        "zz > 3",
    ]
    return forms[int(rng.integers(0, len(forms)))]


def _random_predicate(rng, depth=0):
    if depth > 2 or rng.random() < 0.35:
        return _random_atom(rng)
    r = rng.random()
    if r < 0.15:
        return f"NOT ({_random_predicate(rng, depth + 1)})"
    op = "AND" if r < 0.6 else "OR"
    return f"({_random_predicate(rng, depth + 1)}) {op} ({_random_predicate(rng, depth + 1)})"


def _plan_facts(plan):
    return (
        plan.group_rows,
        plan.prunable,
        tuple(sorted(plan.skip)),
        plan.proven_empty,
        tuple((p.where, p.eligible, p.reason, p.span, p.verdicts) for p in plan.predicates),
        plan.elided_wheres(),
        plan.predicted_batch_rows(700),
        plan.predicted_batch_rows(700, pruned=False),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_prune_plans_equal_jax(seed):
    """Exact: skip sets, verdicts, eligibility, reasons, spans, elided
    wheres and the batch replay."""
    rng = np.random.default_rng(seed)
    groups = _random_groups(rng, pushdown.ColumnStats, pushdown.RowGroupStats)
    jgroups = [
        jpush.RowGroupStats(
            index=g.index,
            num_rows=g.num_rows,
            columns={
                n: jpush.ColumnStats(
                    min_value=c.min_value, max_value=c.max_value, null_count=c.null_count
                )
                for n, c in g.columns.items()
            },
        )
        for g in groups
    ]
    wheres = [_random_predicate(rng) for _ in range(int(rng.integers(1, 5)))]
    if rng.random() < 0.2:
        wheres.append(None)  # an unfiltered member: nothing may skip
    got = pushdown.build_prune_plan(wheres, groups, _types(ColumnType))
    want = jpush.build_prune_plan(wheres, jgroups, _types(JColumnType))
    assert _plan_facts(got) == _plan_facts(want)


def _schemas(rng):
    nullable = {name: bool(rng.random() < 0.5) for name in COLUMNS}
    port = SchemaInfo(
        [FieldInfo(n, getattr(ColumnType, t), nullable[n]) for n, t in COLUMNS.items()]
    )
    jax = JSchemaInfo(
        [JFieldInfo(n, getattr(JColumnType, t), nullable[n]) for n, t in COLUMNS.items()]
    )
    return port, jax


def _diag_facts(diags):
    return [(d.code, d.severity.name, d.message, d.span, d.suggestion) for d in diags]


@pytest.mark.parametrize("seed", SEEDS)
def test_typecheck_and_satisfiability_equal_jax(seed):
    """Exact: the typed result, every diagnostic (code, text, caret span)
    and the satisfiability verdict, over random predicates, expressions
    and schemas."""
    from deequ_tpu.data.expr import parse as jparse
    from deequ_tpu_torch.data.expr import parse

    rng = np.random.default_rng(1000 + seed)
    schema, jschema = _schemas(rng)
    for _ in range(8):
        text = _random_predicate(rng)
        if rng.random() < 0.2:
            text = rng.choice(["k + 'a'", "length(s) > 2", "upper(s) = 'A'", "k >", "v * 2"])
        typed, diags = typecheck.analyze_expression(text, schema)
        jtyped, jdiags = jtype.analyze_expression(text, jschema)
        assert (typed is None) == (jtyped is None), text
        if typed is not None:
            assert (typed.kind, typed.nullable) == (jtyped.kind, jtyped.nullable), text
        assert _diag_facts(diags) == _diag_facts(jdiags), text
        try:
            ast, jast = parse(text), jparse(text)
        except Exception:  # noqa: BLE001 - both parsers refuse it alike
            continue
        assert fold.satisfiability(ast, schema) == jfold.satisfiability(jast, jschema), text
        assert fold.satisfiability(ast, None) == jfold.satisfiability(jast, None), text


# ---------------------------------------------------------------------------
# EXPLAIN renders the same text
# ---------------------------------------------------------------------------


def _static_lines(text):
    """The report without the lines the wire bytes enter and without the
    counters line, which `_same_counters` compares."""
    lines = []
    for line in text.splitlines():
        if line.startswith("  batches:"):
            line = line.split(", first-batch wire")[0]
        elif "wire" in line or line.startswith(("  per-batch", "predicted counters")):
            continue
        lines.append(line)
    return lines


def _same_counters(got, want):
    """Equal counts, but for the shared frequency aggregation: the port
    runs it on the run's device at any group count (ops/freq_agg.py), the
    JAX package only from 65,536 groups, so the port predicts one more
    launch per grouping pass with shareable members (one here)."""
    assert got.counters["device_passes"] == want.counters["device_passes"]
    assert got.counters["group_passes"] == want.counters["group_passes"]
    assert got.counters["device_launches"] == want.counters["device_launches"] + 1


@pytest.fixture
def same_knobs(monkeypatch):
    """Both packages on the same placement."""
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")


def _sorted_file(tmp_path, rows=6000, group=1000):
    rng = np.random.default_rng(5)
    k = np.arange(rows)
    v = rng.normal(size=rows)
    v[::13] = np.nan
    path = str(tmp_path / "sorted.parquet")
    pq.write_table(
        pa.table({
            "k": k,
            "v": v,
            "q": rng.integers(1, 50, rows),
            "s": np.array([f"s{i % 7}" for i in range(rows)], dtype=object),
        }),
        path,
        row_group_size=group,
    )
    return path


def _suite(mod):
    a = mod
    where = "k >= 2500"
    return [
        a.Size(where=where),
        a.Completeness("s", where=where),
        a.Mean("v", where=where),
        a.StandardDeviation("v", where=where),
        a.Maximum("q", where=where),
        a.ApproxCountDistinct("q", where=where),
        a.ApproxQuantile("v", 0.5, where=where),
        a.Compliance("c", "s = 's1'", where=f"{where} and v >= 0.0"),
        a.Uniqueness(["q"]),
    ]


@pytest.mark.parametrize("pushdown_on", ["1", "0"])
def test_explain_renders_the_jax_text_over_parquet(tmp_path, same_knobs, monkeypatch, pushdown_on):
    import deequ_tpu.analyzers as jan
    import deequ_tpu_torch.analyzers as an
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.lint import explain_plan as jexplain
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.lint import explain_plan

    monkeypatch.setenv("DEEQU_TPU_PUSHDOWN", pushdown_on)
    path = _sorted_file(tmp_path)
    got = explain_plan(Table.scan_parquet(path, batch_rows=1500), _suite(an), device="cpu")
    want = jexplain(JTable.scan_parquet(path, batch_rows=1500), _suite(jan))
    assert _static_lines(got.render()) == _static_lines(want.render())
    _same_counters(got.cost, want.cost)
    assert got.cost.scan_pass.rg_skipped == want.cost.scan_pass.rg_skipped
    if pushdown_on == "1":
        assert got.cost.scan_pass.rg_skipped == 2


def test_explain_renders_the_jax_text_over_a_table(same_knobs):
    import deequ_tpu.analyzers as jan
    import deequ_tpu_torch.analyzers as an
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.lint import explain_plan as jexplain
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.lint import explain_plan

    rng = np.random.default_rng(3)
    data = {
        "k": np.arange(5000),
        "v": rng.normal(size=5000),
        "q": rng.integers(0, 9, 5000),
        "s": np.array([f"s{i % 3}" for i in range(5000)], dtype=object),
    }
    got = explain_plan(Table.from_pydict(data), _suite(an), device="cpu", batch_size=1024)
    want = jexplain(JTable.from_pydict(data), _suite(jan), batch_size=1024)
    assert _static_lines(got.render()) == _static_lines(want.render())
    _same_counters(got.cost, want.cost)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_window_explain_renders_the_jax_windows_line(tmp_path, same_knobs, monkeypatch, warm):
    """A window query's admission cost renders the same `windows:` and
    `resilience:` lines in both packages, cold (every partition to
    rescan) and after a run has filled the repository and its segments."""
    import datetime

    import deequ_tpu.analyzers as jan
    import deequ_tpu_torch.analyzers as an
    from deequ_tpu import windows as jwin
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.lint.explain import render_explain as jrender
    from deequ_tpu.repository.states import FileSystemStateRepository as JRepo
    from deequ_tpu_torch import windows as win
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.lint.explain import render_explain
    from deequ_tpu_torch.repository.states import FileSystemStateRepository

    monkeypatch.setenv("DEEQU_TPU_ENCODED_FOLD", "0")
    monkeypatch.delenv("DEEQU_TPU_STATE_CACHE", raising=False)
    root = tmp_path / "ds"
    root.mkdir()
    rng = np.random.default_rng(8)
    for d in range(12):
        day = datetime.date(2026, 3, 1) + datetime.timedelta(days=d)
        pq.write_table(pa.table({"v": rng.normal(size=300), "q": rng.integers(0, 9, 300)}),
                       str(root / f"ev-{day.isoformat()}.parquet"))

    def suite(mod):
        return [mod.Size(), mod.Mean("v"), mod.Maximum("q"), mod.ApproxQuantile("v", 0.5)]

    q = win.WindowQuery(Table.scan_parquet_dataset(str(root)), suite(an),
                        repository=FileSystemStateRepository(str(tmp_path / "p")), dataset="d", device="cpu")
    jq = jwin.WindowQuery(JTable.scan_parquet_dataset(str(root)), suite(jan),
                          repository=JRepo(str(tmp_path / "j")), dataset="d")
    if warm:
        q.run(win.Sliding(7))
        jq.run(jwin.Sliding(7))
    got = render_explain(q.admission_cost(win.Sliding(7)))
    want = jrender(jq.admission_cost(jwin.Sliding(7)))

    def lines(text, prefix):
        return [line for line in text.splitlines() if line.startswith(prefix)]

    assert lines(got, "windows:") == lines(want, "windows:")
    assert len(lines(got, "windows:")) == 1
    assert lines(got, "resilience:") == lines(want, "resilience:")
    assert ("0 partitions rescanned" in lines(got, "windows:")[0]) == warm
