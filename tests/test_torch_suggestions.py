"""ConstraintSuggestionRunner and its rules: the port on device="cpu"
against the JAX package on the same seeded tables, and the port's file
outputs.

Tolerance: none for what the suggestions are made of. Whether a rule
applies, every suggestion (column, rule, current value, description,
code), the suggestion and evaluation JSON and the verdicts on the
held-out split must be equal. In the exported profile JSON a
schema-numeric column's mean, sum and standard deviation, which torch and
XLA sum in other orders, agree within 1e-12 relative."""

from __future__ import annotations

import json
import os
import stat

import numpy as np
import pytest

from deequ_tpu.data.table import Table as JTable
from deequ_tpu.ops import native
from deequ_tpu.profiles import ColumnProfilerRunner as JProfiler
from deequ_tpu.suggestions import ConstraintSuggestionRunner as JRunner
from deequ_tpu.suggestions import Rules as JRules
from deequ_tpu.suggestions import rules as jrules
from deequ_tpu_torch import ColumnProfilerRunner as PProfiler
from deequ_tpu_torch import ConstraintSuggestionRunner as PRunner
from deequ_tpu_torch import Rules as PRules
from deequ_tpu_torch import Table as PTable
from deequ_tpu_torch.core.fileio import write_text_output
from deequ_tpu_torch.suggestions import rules as prules

RULES = [
    "CompleteIfCompleteRule",
    "RetainCompletenessRule",
    "RetainTypeRule",
    "CategoricalRangeRule",
    "FractionalCategoricalRangeRule",
    "NonNegativeNumbersRule",
    "UniqueIfApproximatelyUniqueRule",
]
COLUMNS = ["id", "name", "status", "amountStr", "score", "flag", "level"]


@pytest.fixture(autouse=True)
def _device_placement_without_c_library(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)


def example_table(n=120):
    """tests/test_profiler_suggestions.py's table, and a skewed category."""
    return {
        "id": list(range(n)),
        "name": [f"name_{i}" for i in range(n)],
        "status": [["active", "inactive", "pending"][i % 3] for i in range(n)],
        "amountStr": [str(i * 10) for i in range(n)],
        "score": [float(i) / 2 if i % 10 != 0 else None for i in range(n)],
        "flag": [bool(i % 2) for i in range(n)],
        "level": [["low", "low", "low", "mid", "high", f"rare{i}"][i % 6] for i in range(n)],
    }


def random_table(seed, n=1200):
    rng = np.random.default_rng(seed)
    amount = rng.gamma(2.0, 10.0, n)
    amount[rng.random(n) < 0.05] = np.nan
    return {
        "key": np.arange(n),
        "amount": amount,
        "delta": rng.normal(0.0, 1.0, n),
        "code": np.array([str(v) for v in rng.integers(0, 40, n)], dtype=object),
        "state": np.array(["ok", "warn", "err", None, "o'brien"], dtype=object)[
            rng.choice(5, n, p=[0.6, 0.2, 0.1, 0.05, 0.05])
        ],
        "flag": rng.random(n) < 0.3,
    }


def profiles_of(data):
    jp = JProfiler.on_data(JTable.from_pydict(data)).with_engine("single").run()
    pp = PProfiler.on_data(PTable.from_pydict(data), device="cpu").run()
    return jp, pp


def suggestion_rows(result):
    return [
        (s.column_name, repr(s.suggesting_rule), s.current_value, s.description,
         s.code_for_constraint, repr(s.constraint))
        for s in result.all_suggestions()
    ]


def verdicts(result):
    if result.verification_result is None:
        return None
    return [
        (cr.status.value, cr.message)
        for r in result.verification_result.check_results.values()
        for cr in r.constraint_results
    ]


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("column", COLUMNS)
def test_each_rule_equals_jax(rule, column):
    jp, pp = profiles_of(example_table())
    jrule, prule = getattr(jrules, rule)(), getattr(prules, rule)()
    jprof, pprof = jp.profiles[column], pp.profiles[column]
    applies = prule.should_be_applied(pprof, pp.num_records)
    assert applies == jrule.should_be_applied(jprof, jp.num_records)
    assert prule.rule_description == jrule.rule_description and repr(prule) == repr(jrule)
    if applies:
        js, ps = jrule.candidate(jprof, jp.num_records), prule.candidate(pprof, pp.num_records)
        assert (ps.column_name, ps.current_value, ps.description, ps.code_for_constraint) == (
            js.column_name, js.current_value, js.description, js.code_for_constraint)
        assert repr(ps.constraint) == repr(js.constraint)


def test_the_rules_of_the_example_fire_as_the_jax_tests_expect():
    _, pp = profiles_of(example_table())
    p = pp.profiles
    assert prules.CompleteIfCompleteRule().candidate(p["id"], 120).code_for_constraint == \
        '.is_complete("id")'
    assert ".has_completeness" in prules.RetainCompletenessRule().candidate(p["score"], 120) \
        .code_for_constraint
    assert not prules.RetainTypeRule().should_be_applied(p["id"], 120)  # not inferred
    assert "ConstrainableDataTypes.INTEGRAL" in prules.RetainTypeRule() \
        .candidate(p["amountStr"], 120).code_for_constraint
    assert '"active"' in prules.CategoricalRangeRule().candidate(p["status"], 120) \
        .code_for_constraint
    assert prules.UniqueIfApproximatelyUniqueRule().should_be_applied(p["id"], 120)
    assert not prules.UniqueIfApproximatelyUniqueRule().should_be_applied(p["status"], 120)


def test_default_rules_match():
    assert [repr(r) for r in PRules.DEFAULT] == [repr(r) for r in JRules.DEFAULT]


@pytest.mark.parametrize("data", ["example", "random-0", "random-1"])
def test_end_to_end_equals_jax(data):
    cols = example_table() if data == "example" else random_table(int(data[-1]))
    jt = JTable.from_pydict(cols) if data == "example" else JTable.from_numpy(cols)
    pt = PTable.from_pydict(cols) if data == "example" else PTable.from_numpy(cols)
    jres = JRunner.on_data(jt).add_constraint_rules(JRules.DEFAULT).run()
    pres = PRunner.on_data(pt, device="cpu").add_constraint_rules(PRules.DEFAULT).run()
    assert suggestion_rows(pres) == suggestion_rows(jres)
    assert pres.suggestions_as_json() == jres.suggestions_as_json()
    parsed = json.loads(pres.suggestions_as_json())
    assert len(parsed["constraint_suggestions"]) == len(suggestion_rows(pres)) > 0


@pytest.mark.parametrize("ratio,seed", [(0.25, 7), (0.1, 0), (0.5, 3)])
def test_train_test_split_equals_jax(ratio, seed):
    cols = random_table(5, 2000)
    jres = (
        JRunner.on_data(JTable.from_numpy(cols))
        .add_constraint_rules(JRules.DEFAULT)
        .use_train_test_split_with_test_set_ratio(ratio, seed=seed)
        .run()
    )
    pres = (
        PRunner.on_data(PTable.from_numpy(cols), device="cpu")
        .add_constraint_rules(PRules.DEFAULT)
        .use_train_test_split_with_test_set_ratio(ratio, seed=seed)
        .run()
    )
    assert pres.num_records == jres.num_records
    assert suggestion_rows(pres) == suggestion_rows(jres)
    assert verdicts(pres) == verdicts(jres)
    assert pres.verification_result.status.value == jres.verification_result.status.value


def test_generated_constraints_mostly_hold_on_the_test_split():
    """The JAX package's expectation (tests/test_profiler_suggestions.py)."""
    data = example_table(400)
    jres = (
        JRunner.on_data(JTable.from_pydict(data))
        .add_constraint_rules(JRules.DEFAULT)
        .use_train_test_split_with_test_set_ratio(0.25, seed=7)
        .run()
    )
    pres = (
        PRunner.on_data(PTable.from_pydict(data), device="cpu")
        .add_constraint_rules(PRules.DEFAULT)
        .use_train_test_split_with_test_set_ratio(0.25, seed=7)
        .run()
    )
    assert verdicts(pres) == verdicts(jres)
    statuses = [status for status, _ in verdicts(pres)]
    assert statuses.count("Success") >= len(statuses) - 1


def test_json_outputs_equal_jax(tmp_path):
    cols = random_table(2, 800)

    def run(runner, table, rules, tag):
        paths = [str(tmp_path / f"{tag}-{kind}.json") for kind in ("profiles", "sugg", "eval")]
        (
            runner.on_data(table, **({"device": "cpu"} if tag == "port" else {}))
            .add_constraint_rules(rules)
            .use_train_test_split_with_test_set_ratio(0.2, seed=1)
            .save_column_profiles_json_to_path(paths[0])
            .save_constraint_suggestions_json_to_path(paths[1])
            .save_evaluation_results_json_to_path(paths[2])
            .run()
        )
        out = []
        for path in paths:
            with open(path, encoding="utf-8") as f:
                out.append(f.read())
        return out

    port = run(PRunner, PTable.from_numpy(cols), PRules.DEFAULT, "port")
    jax = run(JRunner, JTable.from_numpy(cols), JRules.DEFAULT, "jax")
    assert port[1:] == jax[1:]  # the suggestions and their verdicts
    # the profiles: torch and XLA sum a schema-numeric column's moments
    # in other orders, so those agree within 1e-12 relative
    pcols = json.loads(port[0])["columns"]
    jcols = json.loads(jax[0])["columns"]
    for pc, jc in zip(pcols, jcols):
        assert sorted(pc) == sorted(jc)
        for key, value in jc.items():
            if key in ("mean", "sum", "stdDev"):
                assert pc[key] == pytest.approx(value, rel=1e-12)
            else:
                assert pc[key] == value
    assert len(pcols) == len(jcols)
    evaluated = json.loads(port[2])["constraint_suggestions"]
    assert {e["constraint_result_on_test_set"] for e in evaluated} <= {"Success", "Failure"}


def test_outputs_refuse_to_overwrite(tmp_path):
    path = str(tmp_path / "out.json")
    builder = (
        PRunner.on_data(PTable.from_pydict(example_table()), device="cpu")
        .add_constraint_rules(PRules.DEFAULT)
        .save_constraint_suggestions_json_to_path(path)
    )
    builder.run()
    with pytest.raises(FileExistsError):
        builder.run()
    builder.overwrite_output_files(True).run()


@pytest.mark.parametrize("subdir", ["", "missing"], ids=["existing-dir", "missing-dir"])
def test_write_text_output(tmp_path, subdir):
    path = tmp_path / subdir / "x.json"
    write_text_output(str(path), "{}")
    assert path.read_bytes() == b"{}\n"
    with pytest.raises(FileExistsError):
        write_text_output(str(path), "[]")
    assert path.read_bytes() == b"{}\n"
    write_text_output(str(path), "[]\n", overwrite=True)
    assert path.read_bytes() == b"[]\n"
    assert sorted(p.name for p in path.parent.iterdir()) == ["x.json"]


def test_a_failed_write_keeps_the_old_file_and_no_tmp(tmp_path, monkeypatch):
    path = tmp_path / "x.json"
    path.write_bytes(b"old\n")

    def refuse(src, dst):
        raise OSError("rename refused")

    monkeypatch.setattr("deequ_tpu_torch.core.fileio.os.replace", refuse)
    with pytest.raises(OSError):
        write_text_output(str(path), "new", overwrite=True)
    assert path.read_bytes() == b"old\n"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["x.json"]


def test_written_file_honours_the_umask(tmp_path):
    path = tmp_path / "x.json"
    old = os.umask(0o027)
    try:
        write_text_output(str(path), "{}")
    finally:
        os.umask(old)
    assert stat.S_IMODE(path.stat().st_mode) == 0o640


def test_repository_options_save_and_reuse_the_profile():
    """The suggestion runner hands its metrics repository to the profile:
    a run saves the profile's metrics under its key, and a run that
    reuses the key recomputes none of them (its one pass folds only the
    profile's internal members, which are never saved) and suggests the
    same constraints."""
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.repository import InMemoryMetricsRepository, ResultKey

    repo, key = InMemoryMetricsRepository(), ResultKey(3, {"run": "suggest"})

    def suggest(reuse):
        builder = (PRunner.on_data(PTable.from_pydict(example_table()), device="cpu")
                   .add_constraint_rules(PRules.DEFAULT).use_repository(repo))
        builder = builder.reuse_existing_results_for_key(key) if reuse else (
            builder.save_or_append_result(key))
        return builder.run()

    first = suggest(reuse=False)
    assert repo.load_by_key(key).metric_map
    with runtime.monitored() as stats:
        again = suggest(reuse=True)
    assert (stats.device_passes, stats.group_passes) == (1, 0)
    assert again.suggestions_as_json() == first.suggestions_as_json()
