"""Vectorized string kernels (ops/strings.py) vs their specs.

The classifier's spec is the reference's regex triple
(catalyst/StatefulDataType.scala:36-38) — asserted here by running the
actual regexes (ASCII-digit form, like Java's default `\\d`) over an
adversarial corpus plus random fuzz, and requiring the vectorized
classifier to agree on every value.

Port-mapped from tests/test_strings_kernels.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import re

import numpy as np
import pytest

from deequ_tpu_torch.ops import strings

pytestmark = pytest.mark.usefixtures("cpu_default")

_FRACTIONAL = re.compile(r"(-|\+)? ?[0-9]*\.[0-9]*")
_INTEGRAL = re.compile(r"(-|\+)? ?[0-9]*")
_BOOLEAN = re.compile(r"(true|false)")


def _strip_java_final_terminator(value: str) -> str:
    """Java's `$` matches before ONE final line terminator; emulate by
    stripping it and fullmatching the rest."""
    for term in ("\r\n", "\n", "\r", "", " ", " "):
        if value.endswith(term):
            return value[: -len(term)]
    return value


def reference_classify(value: str) -> int:
    body = _strip_java_final_terminator(value)
    if _FRACTIONAL.fullmatch(body):
        return strings.CODE_FRACTIONAL
    if _INTEGRAL.fullmatch(body):
        return strings.CODE_INTEGRAL
    if _BOOLEAN.fullmatch(body):
        return strings.CODE_BOOLEAN
    return strings.CODE_STRING


ADVERSARIAL = [
    "", " ", "  ", ".", "+", "-", "+ ", "- ", "+ 5", "- 5", "+5", "-5",
    "5", "55", "5.5", ".5", "5.", "+.5", "-.", " .", " 5", "  5", "5 ",
    "++5", "+-5", "5+", "5.5.5", "..", "5..5", "1e5", "inf", "nan",
    "true", "false", "True", "FALSE", "truee", "xtrue", " true",
    "123456789012345678901234567890", "-123.456", "+ 123.", "- .",
    "abc", "12a", "a12", "1 2", "1.2 ", "\t5", "5\n", "5\r\n", "5\r",
    "5 ", "true\n", "5\n6", "\n", "5\n\n", "０１２",  # unicode digits
    "١٢٣",  # arabic-indic digits (Python \d matches; Java/ours must not)
    "trué", "12½", "𝟓", "ｔｒｕｅ",
]


class TestClassify:
    def test_adversarial_corpus(self):
        arr = np.array(ADVERSARIAL, dtype=object).astype(str)
        got = strings.classify(arr)
        for value, code in zip(ADVERSARIAL, got):
            assert code == reference_classify(value), repr(value)

    def test_random_fuzz(self):
        rng = np.random.default_rng(1234)
        alphabet = list("0123456789+-. truefalsexyz\n\r")
        values = [
            "".join(rng.choice(alphabet, size=rng.integers(0, 12)))
            for _ in range(3000)
        ]
        got = strings.classify(np.array(values, dtype=str))
        for value, code in zip(values, got):
            assert code == reference_classify(value), repr(value)

    def test_empty_input(self):
        assert len(strings.classify(np.array([], dtype=str))) == 0


class TestLengthBuckets:
    def test_long_outlier_does_not_widen_short_values(self):
        # one 10k-char blob among short values: classification and hash
        # must still be correct (and not allocate an n x 10k matrix)
        blob = "9" * 10_000
        values = np.array(["1", "2.5", "true", "zz", blob], dtype=object)
        got = strings.classify(values)
        assert got.tolist() == [
            strings.CODE_INTEGRAL,
            strings.CODE_FRACTIONAL,
            strings.CODE_BOOLEAN,
            strings.CODE_STRING,
            strings.CODE_INTEGRAL,  # 10k digits is still ^\d*$
        ]
        hashes = strings.hash_strings(values)
        assert len(np.unique(hashes)) == 5

    def test_hash_independent_of_batch_composition(self):
        # the hash of a value must not depend on what else was hashed
        # with it (bucketed width is a function of the value alone)
        alone = strings.hash_strings(np.array(["abc"], dtype=object))[0]
        with_long = strings.hash_strings(
            np.array(["abc", "x" * 100], dtype=object)
        )[0]
        assert alone == with_long

    def test_classify_each_bucket_boundary(self):
        for n in (7, 8, 9, 16, 17, 64, 65, 128, 129, 400):
            digits = "1" * n
            text = "a" * n
            got = strings.classify(np.array([digits, text], dtype=object))
            assert got[0] == strings.CODE_INTEGRAL, n
            assert got[1] == strings.CODE_STRING, n


class TestHashStrings:
    def test_distinct_strings_distinct_hashes(self):
        values = np.array(
            [f"value-{i}" for i in range(100_000)] + ["a", "ab", "abc", ""],
            dtype=str,
        )
        hashes = strings.hash_strings(values)
        assert len(np.unique(hashes)) == len(values)  # no collisions here

    def test_deterministic(self):
        v = np.array(["x", "yy", "zzz"], dtype=str)
        assert np.array_equal(strings.hash_strings(v), strings.hash_strings(v))

    def test_uniformity_top_bits(self):
        # HLL uses the top 9 bits as the register index: all 512 buckets
        # should be hit roughly uniformly
        values = np.array([f"k{i}" for i in range(51_200)], dtype=str)
        idx = (strings.hash_strings(values) >> np.uint64(55)).astype(int)
        counts = np.bincount(idx, minlength=512)
        assert counts.min() > 40 and counts.max() < 180  # ~100 expected


class TestParseFloats:
    def test_accepted_forms(self):
        vals, ok = strings.parse_floats(
            np.array(["1", "-2.5", "1e3", "+4", " 5 ", "inf", "abc", ""], dtype=object)
        )
        assert ok.tolist() == [True, True, True, True, True, True, False, False]
        assert vals[0] == 1.0 and vals[1] == -2.5 and vals[2] == 1000.0

    def test_nan_not_ok(self):
        _, ok = strings.parse_floats(np.array(["nan"], dtype=object))
        assert not ok[0]


class TestMatchPattern:
    def test_spark_empty_match_is_miss(self):
        hit = strings.match_pattern(np.array(["", "a", "aa"], dtype=str), "a*")
        # "a*" matches everything, but with an EMPTY match on "" -> miss
        assert hit.tolist() == [False, True, True]


class TestAnalyzerIntegrationAfterVectorization:
    """End-to-end: the analyzers that now route through ops/strings."""

    def test_datatype_distribution_unchanged(self):
        from deequ_tpu_torch.analyzers import DataType
        from deequ_tpu_torch.data.table import Table
        from deequ_tpu_torch.ops.fused import FusedScanPass

        t = Table.from_pydict({"s": ["1", "2.5", "true", "abc", None, "+ 7"]})
        result = FusedScanPass([DataType("s")]).run(t)[0]
        dist = result.analyzer.compute_metric_from(result.state_or_raise()).value.get()
        assert dist["Integral"].absolute == 2  # "1", "+ 7"
        assert dist["Fractional"].absolute == 1
        assert dist["Boolean"].absolute == 1
        assert dist["String"].absolute == 1
        assert dist["Unknown"].absolute == 1

    def test_pattern_match_via_uniques(self):
        from deequ_tpu_torch.analyzers.scan import PatternMatch, Patterns
        from deequ_tpu_torch.data.table import Table
        from deequ_tpu_torch.ops.fused import FusedScanPass

        t = Table.from_pydict(
            {"email": ["a@x.com", "bad", "b@y.org", None, "a@x.com"]}
        )
        result = FusedScanPass([PatternMatch("email", Patterns.EMAIL)]).run(t)[0]
        m = result.analyzer.compute_metric_from(result.state_or_raise())
        # reference denominator is conditionalCount(where): ALL 5 rows,
        # NULL included (reference: analyzers/PatternMatch.scala:48-54)
        assert m.value.get() == pytest.approx(3 / 5)

    def test_hll_string_estimate_within_rsd(self):
        from deequ_tpu_torch.analyzers import ApproxCountDistinct
        from deequ_tpu_torch.data.table import Table
        from deequ_tpu_torch.ops.fused import FusedScanPass

        n = 20_000
        values = [f"user-{i % 5000}" for i in range(n)]
        t = Table.from_pydict({"u": values})
        result = FusedScanPass([ApproxCountDistinct("u")]).run(t)[0]
        est = result.analyzer.compute_metric_from(result.state_or_raise()).value.get()
        assert est == pytest.approx(5000, rel=0.15)  # rsd=0.05, 3 sigma

    def test_string_numeric_values_parse(self):
        from deequ_tpu_torch.data.table import Table

        t = Table.from_pydict({"s": ["1", "2.5", "x", None, "1e2"]})
        vals, valid = t.column("s").numeric_values()
        assert valid.tolist() == [True, True, False, False, True]
        assert vals[1] == 2.5 and vals[4] == 100.0

    def test_expr_and_analyzers_agree_on_string_numerics(self):
        """A Compliance predicate and Mean must see the same rows as
        numeric (both route through ops/strings.parse_floats)."""
        from deequ_tpu_torch.analyzers import Compliance, Mean
        from deequ_tpu_torch.data.table import Table
        from deequ_tpu_torch.ops.fused import FusedScanPass

        t = Table.from_pydict({"s": ["10", "1_0", "٥", "30", "x"]})
        results = FusedScanPass(
            [Compliance("c", "s >= 0"), ]
        ).run(t)
        compliance = results[0].analyzer.compute_metric_from(
            results[0].state_or_raise()
        ).value.get()
        vals, valid = t.column("s").numeric_values()
        # identical verdicts: "1_0" and the unicode digit parse (or not)
        # the same way in both paths
        assert compliance == valid.sum() / 5
        assert valid.tolist() == [True, False, False, True, False]

    def test_hll_string_registers_batch_invariant(self):
        """Same values split across batches must produce the same HLL
        registers as one batch (hash must not depend on batch width)."""
        from deequ_tpu_torch.analyzers import ApproxCountDistinct
        from deequ_tpu_torch.data.table import Table
        from deequ_tpu_torch.ops.fused import FusedScanPass

        values = [f"v{i % 300}" + ("x" * (i % 23)) for i in range(4000)]
        t = Table.from_pydict({"s": values})
        one = FusedScanPass([ApproxCountDistinct("s")]).run(t)[0]
        many = FusedScanPass([ApproxCountDistinct("s")], batch_size=512).run(t)[0]
        assert np.array_equal(
            one.state_or_raise().registers, many.state_or_raise().registers
        )


class TestDecimalHalfUp:
    def test_exact_half_rounds_up_like_bigdecimal(self):
        from deequ_tpu_torch.data.table import Table
        from deequ_tpu_torch.schema.row_level_schema_validator import (
            RowLevelSchema,
            RowLevelSchemaValidator,
        )

        t = Table.from_pydict({"d": ["9.995", "2.675", "1.005", "-9.995"]})
        schema = RowLevelSchema().with_decimal_column(
            "d", is_nullable=False, precision=3, scale=2
        )
        res = RowLevelSchemaValidator.validate(t, schema)
        # BigDecimal("9.995") HALF_UP at scale 2 -> 10.00: 3 int digits
        # overflow precision 3 -> rejected (float rounding would accept)
        assert res.num_valid_rows == 2  # 2.675 -> 2.68, 1.005 -> 1.01
        assert res.num_invalid_rows == 2  # ±9.995 -> ±10.00 overflow
        kept = res.valid_rows.column("d").values
        assert sorted(np.round(kept, 2).tolist()) == [1.01, 2.68]
