"""Dedicated applicability-checker tests — the mirror of the reference's
checks/ApplicabilityTest.scala (recognize applicable checks, detect
non-existing columns, invalid expressions) plus the typed random-data
generator's contracts (reference: analyzers/applicability/Applicability.scala).

Port-mapped from tests/test_applicability.py: the same cases against
deequ_tpu_torch, with every run on device="cpu" and the toy tables of
tests/fixtures.py as the port's tables (tests/torch_fixtures.py).
"""

from __future__ import annotations

import numpy as np

from deequ_tpu_torch import Check, CheckLevel
from deequ_tpu_torch.analyzers import Completeness, Compliance, Mean, Size
from deequ_tpu_torch.applicability.applicability import (
    Applicability,
    SchemaField,
    generate_random_data,
)
from deequ_tpu_torch.data.table import ColumnType
from deequ_tpu_torch.verification.suite import VerificationSuite

SCHEMA = [
    SchemaField("item", ColumnType.STRING, nullable=False),
    SchemaField("att1", ColumnType.STRING),
    SchemaField("count", ColumnType.LONG),
    SchemaField("price", ColumnType.DOUBLE),
    SchemaField("flag", ColumnType.BOOLEAN),
    SchemaField("dec", ColumnType.DECIMAL, precision=10, scale=2),
    SchemaField("ts", ColumnType.TIMESTAMP),
]


class TestRandomDataGenerator:
    """reference: Applicability.scala:46-155."""

    def test_all_types_generate(self):
        t = generate_random_data(SCHEMA, 1000, seed=1)
        assert t.num_rows == 1000
        assert [name for name, _ in t.schema] == [f.name for f in SCHEMA]
        types = dict(t.schema)
        assert types["count"] == ColumnType.LONG
        assert types["price"] == ColumnType.DOUBLE
        assert types["flag"] == ColumnType.BOOLEAN
        assert types["ts"] == ColumnType.TIMESTAMP

    def test_nullable_fields_get_about_one_percent_nulls(self):
        t = generate_random_data(SCHEMA, 20_000, seed=2)
        null_fraction = t.column("att1").null_count / 20_000
        assert 0.002 < null_fraction < 0.03
        # non-nullable fields get none
        assert t.column("item").null_count == 0

    def test_decimal_respects_precision_and_scale(self):
        t = generate_random_data(
            [SchemaField("d", ColumnType.DECIMAL, nullable=False, precision=6, scale=2)],
            500,
            seed=3,
        )
        vals = t.column("d").values
        assert np.all(vals < 10**6)
        assert np.all(vals >= 0)

    def test_string_lengths_bounded(self):
        t = generate_random_data(
            [SchemaField("s", ColumnType.STRING, nullable=False)], 500, seed=4
        )
        lengths = [len(v) for v in t.column("s").values]
        assert min(lengths) >= 1 and max(lengths) <= 20

    def test_decimal_precision_equals_scale(self):
        # regression: precision == scale means zero whole digits; the
        # generator used to call rng.integers(0.1, 1.0) and crash
        t = generate_random_data(
            [SchemaField("d", ColumnType.DECIMAL, nullable=False, precision=2, scale=2)],
            500,
            seed=5,
        )
        vals = t.column("d").values
        assert np.all(vals >= 0)
        assert np.all(vals < 1)


class TestCheckApplicability:
    """reference: ApplicabilityTest.scala:49-178."""

    def test_recognizes_applicable_check(self):
        check = (
            Check(CheckLevel.ERROR, "applicable")
            .is_complete("item")
            .has_completeness("att1", lambda v: v > 0.5)
            .has_mean("price", lambda v: True)
            .has_size(lambda n: n > 0)
        )
        result = Applicability(device="cpu").is_applicable(check, SCHEMA)
        assert result.is_applicable
        assert not result.failures
        assert all(result.constraint_applicabilities.values())
        assert len(result.constraint_applicabilities) == 4

    def test_detects_non_existing_column(self):
        check = Check(CheckLevel.ERROR, "bad").is_complete("notThere")
        result = Applicability(device="cpu").is_applicable(check, SCHEMA)
        assert not result.is_applicable
        assert result.failures
        assert any("notThere" in name for name, _ in result.failures)

    def test_detects_wrong_type(self):
        check = Check(CheckLevel.ERROR, "bad").has_mean("att1", lambda v: True)
        result = Applicability(device="cpu").is_applicable(check, SCHEMA)
        assert not result.is_applicable

    def test_detects_invalid_expression(self):
        check = Check(CheckLevel.ERROR, "bad").satisfies(
            "count > > 3", "broken expression"
        )
        result = Applicability(device="cpu").is_applicable(check, SCHEMA)
        assert not result.is_applicable

    def test_partial_applicability_maps_per_constraint(self):
        check = (
            Check(CheckLevel.ERROR, "mixed")
            .is_complete("item")
            .is_complete("missing")
        )
        result = Applicability(device="cpu").is_applicable(check, SCHEMA)
        assert not result.is_applicable
        applicable = list(result.constraint_applicabilities.values())
        assert applicable.count(True) == 1
        assert applicable.count(False) == 1


class TestAnalyzersApplicability:
    def test_applicable_analyzers(self):
        result = Applicability(device="cpu").are_applicable(
            [Size(), Completeness("att1"), Mean("price")], SCHEMA
        )
        assert result.is_applicable
        assert not result.failures

    def test_failures_carry_instance_and_exception(self):
        result = Applicability(device="cpu").are_applicable(
            [Mean("att1"), Compliance("c", "price > > 1")], SCHEMA
        )
        assert not result.is_applicable
        assert len(result.failures) == 2
        for _instance, exception in result.failures:
            assert isinstance(exception, BaseException)


class TestStaticFirst:
    """The applicability checker answers statically whenever it can —
    zero random data generated, zero scans."""

    def test_static_checks_never_generate_data(self, monkeypatch):
        import deequ_tpu_torch.applicability.applicability as mod

        def boom(*args, **kwargs):
            raise AssertionError("static-first path generated random data")

        monkeypatch.setattr(mod, "generate_random_data", boom)
        check = (
            Check(CheckLevel.ERROR, "static")
            .is_complete("item")
            .has_mean("price", lambda v: True)
            .satisfies("count > 0", "positive")
            .is_complete("missing")  # static failure, still no scan
        )
        result = Applicability(device="cpu").is_applicable(check, SCHEMA)
        assert not result.is_applicable
        applicable = list(result.constraint_applicabilities.values())
        assert applicable.count(True) == 3
        assert applicable.count(False) == 1

    def test_static_analyzers_never_generate_data(self, monkeypatch):
        import deequ_tpu_torch.applicability.applicability as mod

        def boom(*args, **kwargs):
            raise AssertionError("static-first path generated random data")

        monkeypatch.setattr(mod, "generate_random_data", boom)
        result = Applicability(device="cpu").are_applicable(
            [Size(), Completeness("att1"), Mean("price"),
             Compliance("c", "price > > 1")],
            SCHEMA,
        )
        assert not result.is_applicable
        assert len(result.failures) == 1

    def test_udf_analyzer_falls_back_to_dynamic(self):
        # a binning UDF can fail in ways no static pass sees — the
        # dry-run on generated data must still run for it
        from deequ_tpu_torch.analyzers import Histogram

        def bad_binning(value):
            raise RuntimeError("udf exploded")

        result = Applicability(device="cpu").are_applicable(
            [Histogram("att1", binning_udf=bad_binning)], SCHEMA
        )
        assert not result.is_applicable
        assert len(result.failures) == 1

    def test_invalid_pattern_caught_statically(self, monkeypatch):
        import deequ_tpu_torch.applicability.applicability as mod
        from deequ_tpu_torch.analyzers import PatternMatch

        monkeypatch.setattr(
            mod,
            "generate_random_data",
            lambda *a, **k: (_ for _ in ()).throw(AssertionError("scanned")),
        )
        result = Applicability(device="cpu").are_applicable(
            [PatternMatch("att1", "(unclosed")], SCHEMA
        )
        assert not result.is_applicable
        assert len(result.failures) == 1


class TestSuiteIntegration:
    """reference: VerificationSuite.isCheckApplicableToData
    (VerificationSuite.scala:238-261)."""

    def test_is_check_applicable_to_data(self, device="cpu"):
        # takes a schema, like the reference's StructType overload
        ok = VerificationSuite.is_check_applicable_to_data(
            Check(CheckLevel.ERROR, "c").is_complete("att1"), SCHEMA, device="cpu"
        )
        assert ok.is_applicable
        bad = VerificationSuite.is_check_applicable_to_data(
            Check(CheckLevel.ERROR, "c").is_complete("zzz"), SCHEMA, device="cpu"
        )
        assert not bad.is_applicable
