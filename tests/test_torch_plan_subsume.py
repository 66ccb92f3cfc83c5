"""The plan-subsumption prover (deequ_tpu_torch/lint/subsume.py): static
proofs that "suite A ⊆ scan S", sound under three-valued NaN/NULL
predicate semantics, with plan-environment components never silently
merged.

Soundness bar: a CONTAINED(-WITH-RESIDUAL) verdict promises the scan's
folded states fan back out to the suite bit-identically over the state
semigroup. Everything the prover cannot PROVE must come back
INCOMPARABLE — in particular one-way where implication, which covers a
superset of rows no post-hoc step can narrow.

Port-mapped from tests/test_plan_subsume.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

import pytest
from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

from deequ_tpu_torch.analyzers import ApproxQuantile, Completeness, Compliance, Mean, Size
from deequ_tpu_torch.data.table import ColumnType
from deequ_tpu_torch.lint import FieldInfo, SchemaInfo
from deequ_tpu_torch.lint.explain import sharing_diagnostics
from deequ_tpu_torch.lint.subsume import (
    CONTAINED,
    CONTAINED_WITH_RESIDUAL,
    EQUIVALENT_WHERE,
    EXACT,
    INCOMPARABLE,
    PlanEnv,
    prove_subsumption,
    where_implies,
    wheres_equivalent,
)

pytestmark = pytest.mark.usefixtures("cpu_default")

SCHEMA = SchemaInfo(
    [
        FieldInfo("item", ColumnType.STRING, nullable=False),
        FieldInfo("att1", ColumnType.STRING, nullable=True),
        FieldInfo("count", ColumnType.LONG, nullable=True),
        FieldInfo("price", ColumnType.DOUBLE, nullable=True),
    ]
)


# ---------------------------------------------------------------------------
# where-clause implication over the Kleene lattice
# ---------------------------------------------------------------------------


def test_where_implies_strict_subset_one_way():
    assert where_implies("count > 1", "count > 0", SCHEMA)
    assert not where_implies("count > 0", "count > 1", SCHEMA)


def test_where_none_is_constant_true():
    # everything is a subset of "no filter"...
    assert where_implies("price > 0", None, SCHEMA)
    # ...but "no filter" includes NULL rows every comparison excludes,
    # so constant-true never implies a comparison on a nullable column
    assert not where_implies(None, "price >= 0", SCHEMA)


def test_wheres_equivalent_mutual_not_one_way():
    assert wheres_equivalent("(count > 0)", "count > 0", SCHEMA)
    assert wheres_equivalent(None, None, SCHEMA)
    assert not wheres_equivalent("count >= 0", "count > 0", SCHEMA)


def test_where_parse_failure_proves_nothing():
    assert not where_implies("count >>> bogus", "count > 0", SCHEMA)
    assert not wheres_equivalent("count >>> bogus", "count >>> bogus2", SCHEMA)


# ---------------------------------------------------------------------------
# verdicts
# ---------------------------------------------------------------------------


def test_exact_subset_is_contained():
    suite = [Completeness("item"), Mean("price")]
    scan = [Completeness("item"), Mean("price"), Size(), Completeness("att1")]
    proof = prove_subsumption(suite, scan, SCHEMA)
    assert proof.verdict == CONTAINED
    assert proof.contained
    assert [o.kind for o in proof.obligations] == [EXACT, EXACT]
    assert all(o.target == o.analyzer for o in proof.obligations)
    assert proof.summary().startswith("CONTAINED: 2/2")


def test_suite_duplicates_dedupe_to_one_obligation():
    suite = [Mean("price"), Mean("price"), Mean("price")]
    proof = prove_subsumption(suite, [Mean("price")], SCHEMA)
    assert proof.verdict == CONTAINED
    assert len(proof.obligations) == 1


def test_equivalent_where_spelling_is_residual_not_exact():
    suite = [Mean("price", where="(count > 0)")]
    scan = [Mean("price", where="count > 0")]
    proof = prove_subsumption(suite, scan, SCHEMA)
    assert proof.verdict == CONTAINED_WITH_RESIDUAL
    assert proof.contained
    (ob,) = proof.obligations
    assert ob.kind == EQUIVALENT_WHERE
    assert ob.target == repr(scan[0])
    assert "equivalent" in ob.detail


def test_one_way_implication_is_never_containment():
    # the scan's weaker predicate folds MORE rows into its state; the
    # suite's metric cannot be recovered from it
    suite = [Mean("price", where="count > 1")]
    scan = [Mean("price", where="count > 0")]
    proof = prove_subsumption(suite, scan, SCHEMA)
    assert proof.verdict == INCOMPARABLE
    assert not proof.contained
    (ob,) = proof.obligations
    assert not ob.satisfied
    assert "cannot be narrowed" in ob.detail
    assert ob.where == "count > 1"


def test_adversarial_near_equivalence_declines():
    # >= vs > differ exactly on the boundary row: not equivalent, and
    # neither direction's one-way fact makes it containment
    suite = [Completeness("att1", where="count >= 0")]
    scan = [Completeness("att1", where="count > 0")]
    proof = prove_subsumption(suite, scan, SCHEMA)
    assert proof.verdict == INCOMPARABLE
    (ob,) = proof.obligations
    assert "not provably equivalent" in ob.detail or "cannot be narrowed" in ob.detail


def test_param_mismatch_is_not_a_where_problem():
    proof = prove_subsumption([Completeness("item")], [Completeness("att1")], SCHEMA)
    assert proof.verdict == INCOMPARABLE
    (ob,) = proof.obligations
    assert "differs in parameters" in ob.detail


def test_missing_family_reports_no_analyzer_of_type():
    proof = prove_subsumption([ApproxQuantile("price", 0.5)], [Size()], SCHEMA)
    assert proof.verdict == INCOMPARABLE
    (ob,) = proof.obligations
    assert ob.detail == "no scan analyzer of this type"


def test_compliance_predicate_is_a_param_not_a_where():
    # the Compliance PREDICATE is identity, not filtering: two different
    # predicates are different analyzers even with equivalent wheres
    a = Compliance("rule", "count > 1")
    s = Compliance("rule", "count > 0")
    proof = prove_subsumption([a], [s], SCHEMA)
    assert proof.verdict == INCOMPARABLE


# ---------------------------------------------------------------------------
# plan environments: signature components are never merged
# ---------------------------------------------------------------------------


def test_env_component_mismatch_is_incomparable_even_for_equal_sets():
    suite = [Mean("price")]
    host = PlanEnv(placement="host", compute_dtype="float64", fold_variant="pairwise")
    for other in (
        PlanEnv(placement="device", compute_dtype="float64", fold_variant="pairwise"),
        PlanEnv(placement="host", compute_dtype="float32", fold_variant="pairwise"),
        PlanEnv(placement="host", compute_dtype="float64", fold_variant="linear"),
        PlanEnv(
            placement="host",
            compute_dtype="float64",
            fold_variant="pairwise",
            batch_rows=4096,
        ),
    ):
        proof = prove_subsumption(
            suite, suite, SCHEMA, suite_env=host, scan_env=other
        )
        assert proof.verdict == INCOMPARABLE, other
        assert proof.env_mismatches
        assert "environments differ" in proof.summary()


def test_equal_envs_do_not_disturb_the_verdict():
    env = PlanEnv(placement="device", compute_dtype="float64", fold_variant="pairwise")
    proof = prove_subsumption(
        [Mean("price")], [Mean("price")], SCHEMA, suite_env=env, scan_env=env
    )
    assert proof.verdict == CONTAINED
    assert proof.env_mismatches == ()


# ---------------------------------------------------------------------------
# proof pinning against traced execution
# ---------------------------------------------------------------------------


def test_pin_zero_drift_when_targets_executed():
    suite = [Completeness("item"), Mean("price", where="(count > 0)")]
    scan = [Completeness("item"), Mean("price", where="count > 0")]
    proof = prove_subsumption(suite, scan, SCHEMA)
    assert proof.contained
    executed = [repr(a) for a in scan]
    assert proof.pin(executed) == {
        "obligations_unexecuted": 0,
        "obligations_unproven": 0,
        "env_mismatches": 0,
    }


def test_pin_counts_unexecuted_targets():
    suite = [Completeness("item"), Mean("price")]
    proof = prove_subsumption(suite, suite, SCHEMA)
    drift = proof.pin([repr(Completeness("item"))])
    assert drift["obligations_unexecuted"] == 1


def test_to_dict_is_json_shaped():
    import json

    proof = prove_subsumption([Mean("price")], [Size()], SCHEMA)
    payload = proof.to_dict()
    assert json.loads(json.dumps(payload)) == payload
    assert payload["verdict"] == INCOMPARABLE


# ---------------------------------------------------------------------------
# DQ321 / DQ322 diagnostics
# ---------------------------------------------------------------------------


def test_dq321_on_contained_proof():
    proof = prove_subsumption([Mean("price")], [Mean("price"), Size()], SCHEMA)
    diags = sharing_diagnostics(proof)
    assert [d.code for d in diags] == ["DQ321"]
    assert "superset scan" in diags[0].message


def test_dq322_caret_lands_on_the_offending_where():
    proof = prove_subsumption(
        [Mean("price", where="count >= 0")],
        [Mean("price", where="count > 0")],
        SCHEMA,
    )
    diags = sharing_diagnostics(proof)
    assert [d.code for d in diags] == ["DQ322"]
    d = diags[0]
    assert d.source == "count >= 0"
    assert d.span == (0, len("count >= 0"))
    rendered = d.render()
    assert "^" in rendered


def test_dq322_per_env_mismatch():
    env_a = PlanEnv(fold_variant="pairwise")
    env_b = PlanEnv(fold_variant="linear")
    proof = prove_subsumption(
        [Mean("price")], [Mean("price")], SCHEMA, suite_env=env_a, scan_env=env_b
    )
    diags = sharing_diagnostics(proof)
    assert [d.code for d in diags] == ["DQ322"]
    assert "fold_variant" in diags[0].message


def test_validate_plan_carries_sharing_diagnostics():
    from deequ_tpu_torch import Check, CheckLevel
    from deequ_tpu_torch.lint.planlint import validate_plan

    check = Check(CheckLevel.ERROR, "shared").has_mean("price", lambda m: True)
    scan = [Mean("price"), Completeness("item")]
    report = validate_plan(
        SCHEMA, [check], mode="lenient", num_rows=100, sharing_with=scan
    )
    assert "DQ321" in [d.code for d in report.diagnostics]


def test_explain_renders_the_sharing_line():
    from deequ_tpu_torch.lint.explain import explain_plan

    result = explain_plan(
        SCHEMA,
        analyzers=[Mean("price")],
        num_rows=100,
        sharing_with=[Mean("price"), Size()],
    )
    assert result.sharing is not None
    assert result.sharing.verdict == CONTAINED
    text = result.render()
    assert "sharing: CONTAINED" in text


def test_explain_sharing_line_absent_without_candidate():
    from deequ_tpu_torch.lint.explain import explain_plan

    result = explain_plan(SCHEMA, analyzers=[Mean("price")], num_rows=100)
    assert result.sharing is None
    assert "sharing:" not in result.render()
