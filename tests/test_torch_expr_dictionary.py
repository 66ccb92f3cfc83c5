"""A predicate over one STRING column, evaluated once over the column's
dictionary entries and gathered through its codes (data/expr.py
`Predicate._dictionary_route`), against the JAX package's row-wise
evaluation of the same predicate over the same data, bit for bit.

Every node kind the route serves, over an Arrow dictionary (with a null
entry, entries no row uses, null rows), a plain Arrow string column, an
in-memory object column, slices of a parent column, an empty and an
all-null batch. Then the sharing (`pred:` and `prednn:` of one batch, and
batches with equal dictionaries, cause one evaluation), the predicates
that keep the row path, and the `dictionary_predicates` counter over a
streamed verification with the verify traffic's constraints. Every run
on the CPU (tests/torch_cpu.py).
"""

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import json
import os

import numpy as np
import pyarrow as pa
import pytest

from deequ_tpu.data.expr import Predicate as JPredicate
from deequ_tpu.data.table import Table as JTable
from deequ_tpu_torch.analyzers import scan
from deequ_tpu_torch.data import expr as expr_mod
from deequ_tpu_torch.data.expr import Predicate
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import runtime

pytestmark = pytest.mark.usefixtures("cpu_default")

EXPRESSIONS = [
    "s IN ('AIR', '12', 'x')",
    "s NOT IN ('AIR', 'x')",
    "`s` IS NULL OR `s` IN ('AIR','FOB',' mail ')",
    "s IN ('AIR', NULL)",
    "s = 'AIR'",
    "s <> 'AIR'",
    "s != '12'",
    "s < 'M'",
    "s <= '12'",
    "s > 5",
    "s >= 3.5",
    "s = 'None'",
    "s = NULL",
    "s IS NULL",
    "s IS NOT NULL",
    "NOT s = 'AIR'",
    "s IS NOT NULL AND s <> '12'",
    "s = 'AIR' OR s > 10",
    "s BETWEEN 'A' AND 'N'",
    "s NOT BETWEEN 1 AND 20",
    "s LIKE '%i%'",
    "s NOT LIKE 'A%'",
    "s LIKE '_2'",
    "s RLIKE '^[0-9.]+$'",
    "s NOT RLIKE 'a'",
    "COALESCE(s, 'x') = 'x'",
    "COALESCE(s, 0) > 1",
    "CASE WHEN s = 'AIR' THEN TRUE WHEN s IS NULL THEN FALSE ELSE s LIKE '1%' END",
    "CASE WHEN s > 4 THEN s ELSE 'zz' END < 'b'",
    "LOWER(s) = 'air'",
    "UPPER(TRIM(s)) = 'MAIL'",
    "LENGTH(s) > 3",
    "s + 1 > 4",
    "ABS(-s) < 10",
    "s * 2 = 24",
    "ISNULL(s)",
    "ISNOTNULL(s) AND s < '4'",
]

_ENTRIES = ["AIR", None, "12", " mail ", "unused", "3.5", "FOB", "air", "never"]
_INDICES = [0, 1, None, 2, 3, 5, 1, 0, None, 6, 7, 2, 5, 0]


def _arrow_dictionary(indices=_INDICES, entries=_ENTRIES) -> pa.Table:
    arr = pa.DictionaryArray.from_arrays(pa.array(indices, type=pa.int32()), pa.array(entries))
    return pa.table({"s": arr})


def _plain_values():
    return [None if i is None or _ENTRIES[i] is None else _ENTRIES[i] for i in _INDICES]


def _arrow_dictionary_tables():
    t = _arrow_dictionary()
    return Table.from_arrow(t), JTable.from_arrow(t)


def _arrow_string_tables():
    t = pa.table({"s": pa.array(_plain_values(), type=pa.string())})
    return Table.from_arrow(t), JTable.from_arrow(t)


def _memory_tables():
    values = _plain_values()
    return Table.from_pydict({"s": values}), JTable.from_pydict({"s": values})


def _dictionary_slice_tables():
    t = _arrow_dictionary()
    return Table.from_arrow(t).slice(3, 11), JTable.from_arrow(t.slice(3, 8))


def _memory_slice_tables():
    values = _plain_values()
    return Table.from_pydict({"s": values}).slice(2, 9), JTable.from_pydict({"s": values[2:9]})


def _empty_tables():
    t = _arrow_dictionary(indices=[])
    return Table.from_arrow(t), JTable.from_arrow(t)


def _all_null_tables():
    t = _arrow_dictionary(indices=[None, None, None])
    return Table.from_arrow(t), JTable.from_arrow(t)


def _all_null_memory_tables():
    t = pa.table({"s": pa.array([None, None], type=pa.string())})
    return Table.from_arrow(t), JTable.from_arrow(t)


DATA = {
    "arrow_dictionary": _arrow_dictionary_tables,
    "arrow_string": _arrow_string_tables,
    "memory": _memory_tables,
    "dictionary_slice": _dictionary_slice_tables,
    "memory_slice": _memory_slice_tables,
    "empty": _empty_tables,
    "all_null": _all_null_tables,
    "all_null_memory": _all_null_memory_tables,
}


@pytest.mark.parametrize("data", sorted(DATA))
@pytest.mark.parametrize("expression", EXPRESSIONS)
def test_dictionary_route_matches_jax_row_path(expression, data):
    table, jtable = DATA[data]()
    assert table.num_rows == jtable.num_rows
    pred = Predicate(expression)
    with runtime.monitored() as stats:
        mask = pred.eval_mask(table)
        nonnull = pred.eval_nonnull(table)
    # both builds were served from the dictionary
    assert (stats.dictionary_predicates, stats.dictionary_predicates_total) == (2, 2)
    values, null, _kind = JPredicate(expression).eval(jtable)
    assert mask.dtype == np.bool_ and nonnull.dtype == np.bool_
    np.testing.assert_array_equal(mask, np.asarray(values, dtype=bool) & ~null, err_msg=expression)
    np.testing.assert_array_equal(mask, JPredicate(expression).eval_mask(jtable))
    np.testing.assert_array_equal(nonnull, ~null, err_msg=expression)
    # and the port's own row path gives the same values
    v, nl, _ = pred.eval(table)
    np.testing.assert_array_equal(mask, np.asarray(v, dtype=bool) & ~nl)
    np.testing.assert_array_equal(nonnull, ~nl)


def test_null_dictionary_entry_rows_keep_their_row_path_masks():
    # rows 1 and 6 point at the dictionary's null entry: a valid row whose
    # value is None, which the row path compares as the text 'None'
    table, _jtable = _arrow_dictionary_tables()
    assert table.column("s").valid[1] and table.column("s").valid[6]
    pred = Predicate("s = 'None' OR s IS NULL")
    mask = pred.eval_mask(table)
    v, nl, _ = pred.eval(table)
    np.testing.assert_array_equal(mask, np.asarray(v, dtype=bool) & ~nl)
    assert mask[1] and mask[6] and mask[2] and mask[8] and not mask[0]


@pytest.mark.parametrize("expression", ["s IS NULL", "s = 'None'", "s IN ('AIR', '12')", "LENGTH(s) = 4"])
def test_taken_rows_of_a_null_entry_keep_the_row_path(expression):
    # `filter` builds per-row values, so a row of the null entry is a valid
    # None, which the encode gives the null code: the route declines
    t = _arrow_dictionary()
    keep = np.arange(len(_INDICES)) % 3 != 2
    table, jtable = Table.from_arrow(t).filter(keep), JTable.from_arrow(t).filter(keep)
    pred = Predicate(expression)
    with runtime.monitored() as stats:
        mask = pred.eval_mask(table)
        nonnull = pred.eval_nonnull(table)
    assert (stats.dictionary_predicates, stats.dictionary_predicates_total) == (0, 2)
    _v, null, _ = JPredicate(expression).eval(jtable)
    np.testing.assert_array_equal(mask, JPredicate(expression).eval_mask(jtable))
    np.testing.assert_array_equal(nonnull, ~null)


def _count_evaluations(monkeypatch):
    """The row counts of the top-level `_eval` calls made from now on."""
    seen = []
    depth = [0]
    real = expr_mod._eval

    def counting(node, table, n):
        if depth[0] == 0:
            seen.append(n)
        depth[0] += 1
        try:
            return real(node, table, n)
        finally:
            depth[0] -= 1

    monkeypatch.setattr(expr_mod, "_eval", counting)
    return seen


def test_pred_and_prednn_share_one_evaluation(monkeypatch):
    entries = ["share-a", "share-b", "share-c"]
    t = _arrow_dictionary(indices=[0, 1, 2, None, 1], entries=entries)
    table = Table.from_arrow(t)
    expression = "`s` IS NULL OR `s` IN ('share-a','share-c')"
    seen = _count_evaluations(monkeypatch)
    pred_spec, nonnull_spec = scan._pred_specs(expression)
    assert (pred_spec.key, nonnull_spec.key) == (f"pred:{expression}", f"prednn:{expression}")
    mask = pred_spec.build(table)
    nonnull = nonnull_spec.build(table)
    # one evaluation, over the three entries and the NULL row
    assert seen == [4]
    np.testing.assert_array_equal(mask, [True, False, True, True, False])
    np.testing.assert_array_equal(nonnull, [True] * 5)


def test_batches_with_equal_dictionaries_share_one_evaluation(monkeypatch):
    entries = ["equal-a", "equal-b"]
    first = Table.from_arrow(_arrow_dictionary(indices=[0, 1, 0], entries=entries))
    second = Table.from_arrow(_arrow_dictionary(indices=[1, None, 1, 1], entries=entries))
    expression = "s IN ('equal-b')"
    seen = _count_evaluations(monkeypatch)
    pred = Predicate(expression)
    np.testing.assert_array_equal(pred.eval_mask(first), [False, True, False])
    np.testing.assert_array_equal(
        Predicate(expression).eval_nonnull(second), [True, False, True, True]
    )
    np.testing.assert_array_equal(pred.eval_mask(second), [True, False, True, True])
    assert seen == [3]


def test_slices_of_one_column_share_one_evaluation(monkeypatch):
    table = Table.from_pydict({"s": ["slice-a", None, "slice-b", "slice-a", "slice-c"]})
    pred = Predicate("s LIKE '%a'")
    seen = _count_evaluations(monkeypatch)
    np.testing.assert_array_equal(pred.eval_mask(table.slice(0, 2)), [True, False])
    np.testing.assert_array_equal(pred.eval_mask(table.slice(2, 5)), [False, True, False])
    assert seen == [4]


@pytest.mark.parametrize(
    "expression",
    [
        "s IN ('x', 'y') OR a > 0",  # two columns
        "a > 0",  # numeric
        "a IN (1, 2)",
        "b",  # boolean
        "b = TRUE",
        "1 = 1",  # no column
    ],
)
def test_other_predicates_keep_the_row_path(expression, monkeypatch):
    table = Table.from_pydict(
        {"s": ["x", None, "y", "z"], "a": [1.0, None, -2.0, 2.0], "b": [True, False, None, True]}
    )
    jtable = JTable.from_pydict(
        {"s": ["x", None, "y", "z"], "a": [1.0, None, -2.0, 2.0], "b": [True, False, None, True]}
    )
    seen = _count_evaluations(monkeypatch)
    pred = Predicate(expression)
    with runtime.monitored() as stats:
        mask = pred.eval_mask(table)
        nonnull = pred.eval_nonnull(table)
    assert (stats.dictionary_predicates, stats.dictionary_predicates_total) == (0, 2)
    assert seen == [4, 4]
    _v, null, _ = JPredicate(expression).eval(jtable)
    np.testing.assert_array_equal(mask, JPredicate(expression).eval_mask(jtable))
    np.testing.assert_array_equal(nonnull, ~null)


def test_verify_traffic_counts_the_in_lists_dictionary_builds(tmp_path):
    from benchmark import checks
    from benchmark.gen import lineitem

    from deequ_tpu_torch import VerificationSuite, observe
    from deequ_tpu_torch.checks.check import CheckStatus

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", "tpch_lineitem_sf01.json")) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", "verify.json")) as f:
        constraints = json.load(f)["constraints"]
    config = dict(config, text_pool_bytes=1 << 16)
    rows = 3000
    data = lineitem.make(config, seed=2147483911, workdir=str(tmp_path), rows=rows)
    source = Table.scan_parquet(data.path, batch_rows=1024)
    with runtime.monitored() as stats, observe.tracing() as tracer:
        result = (
            VerificationSuite.on_data(source, device="cpu")
            .add_check(checks.build_check(constraints, rows))
            .run()
        )
    assert result.status == CheckStatus.SUCCESS
    batches = 3
    # the four IN lists' `pred:` and `prednn:` builds in every batch take
    # the route; the four ranges' and non_negative's do not
    in_lists = sum(spec["kind"] == "contained_in" for spec in constraints)
    compliances = sum(spec["kind"] in ("contained_in", "satisfies", "non_negative") for spec in constraints)
    assert (in_lists, compliances) == (4, 9)
    assert stats.dictionary_predicates == 2 * in_lists * batches
    assert stats.dictionary_predicates_total == 2 * compliances * batches
    assert tracer.counters["dictionary_predicates"] == 24
    assert tracer.counters["dictionary_predicates_total"] == 54
    assert "dictionary_predicates 24/54" in observe.render_report(tracer, counters=tracer.counters)
    builds = observe.report.build_seconds(tracer)
    assert any(key.startswith("prednn:`l_shipmode`") for key in builds)
