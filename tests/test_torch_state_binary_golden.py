"""Golden byte-level tests for the binary state layouts — pins the
reference's per-type formats (reference: StateProvider.scala:85-174) so
a refactor can't silently change the wire/checkpoint format that
`runOnAggregatedStates`-style workflows and the multihost envelope
depend on.

Port-mapped from tests/test_state_binary_golden.py: the same cases
against deequ_tpu_torch, with every run on device="cpu" and the toy
tables of tests/fixtures.py as the port's tables
(tests/torch_fixtures.py).
"""

from __future__ import annotations

import struct

import numpy as np
import pytest

from deequ_tpu_torch.analyzers import (
    Completeness,
    Compliance,
    DataType,
    Maximum,
    Mean,
    Minimum,
    PatternMatch,
    Size,
    StandardDeviation,
    Sum,
    Correlation,
)
from deequ_tpu_torch.analyzers.state_provider import deserialize_state, serialize_state
from deequ_tpu_torch.analyzers.states import (
    CorrelationState,
    DataTypeHistogram,
    MaxState,
    MeanState,
    MinState,
    NumMatches,
    NumMatchesAndCount,
    StandardDeviationState,
    SumState,
)


class TestScalarStateGoldenBytes:
    """Big-endian fixed layouts, exactly as the reference writes them."""

    def test_size_is_one_long(self):
        # reference: StateProvider.scala Long layout for NumMatches
        blob = serialize_state(Size(), NumMatches(12345))
        assert blob == struct.pack(">q", 12345)
        assert len(blob) == 8

    @pytest.mark.parametrize(
        "analyzer",
        [Completeness("c"), Compliance("n", "c > 0"), PatternMatch("c", r"\d")],
        ids=lambda a: a.name,
    )
    def test_ratio_states_are_two_longs(self, analyzer):
        blob = serialize_state(analyzer, NumMatchesAndCount(7, 9))
        assert blob == struct.pack(">qq", 7, 9)
        assert len(blob) == 16

    def test_sum_min_max_are_one_double(self):
        assert serialize_state(Sum("c"), SumState(2.5)) == struct.pack(">d", 2.5)
        assert serialize_state(Minimum("c"), MinState(-1.5)) == struct.pack(
            ">d", -1.5
        )
        assert serialize_state(Maximum("c"), MaxState(9.25)) == struct.pack(
            ">d", 9.25
        )

    def test_mean_is_double_plus_long(self):
        blob = serialize_state(Mean("c"), MeanState(10.5, 4))
        assert blob == struct.pack(">dq", 10.5, 4)
        assert len(blob) == 16

    def test_stddev_is_three_doubles(self):
        blob = serialize_state(
            StandardDeviation("c"), StandardDeviationState(4.0, 2.5, 1.25)
        )
        assert blob == struct.pack(">ddd", 4.0, 2.5, 1.25)
        assert len(blob) == 24

    def test_correlation_is_six_doubles(self):
        state = CorrelationState(3.0, 1.0, 2.0, 0.5, 0.25, 0.125)
        blob = serialize_state(Correlation("a", "b"), state)
        assert blob == struct.pack(">dddddd", 3.0, 1.0, 2.0, 0.5, 0.25, 0.125)
        assert len(blob) == 48

    def test_datatype_is_length_prefixed_five_longs(self):
        # reference: 40-byte DataTypeHistogram (DataType.scala:58-100)
        state = DataTypeHistogram(1, 2, 3, 4, 5)
        blob = serialize_state(DataType("c"), state)
        (length,) = struct.unpack(">i", blob[:4])
        assert length == 40
        assert struct.unpack(">qqqqq", blob[4:]) == (1, 2, 3, 4, 5)

    def test_big_endianness_pinned(self):
        # a value whose little-endian bytes differ makes endianness explicit
        blob = serialize_state(Size(), NumMatches(1))
        assert blob == b"\x00\x00\x00\x00\x00\x00\x00\x01"

    def test_hand_derived_literal_goldens_per_format(self):
        """Literal byte goldens hand-derived from the reference layout
        spec (StateProvider.scala:85-174): big-endian Java primitives,
        IEEE-754 doubles written out by hand (2.5 = 0x4004<<48,
        10.5 = 0x4025<<48, 1.25 = 0x3FF4<<48, ...). Nothing here calls
        struct or the serializer to produce the expected side — these
        bytes were derived on paper, so a shared encoding bug in both
        producer and expectation cannot hide."""
        # Size → one big-endian long: 12345 = 0x3039
        assert serialize_state(Size(), NumMatches(12345)) == (
            b"\x00\x00\x00\x00\x00\x00\x30\x39"
        )
        # Completeness → (matches, count) two longs: (7, 9)
        assert serialize_state(
            Completeness("c"), NumMatchesAndCount(7, 9)
        ) == (
            b"\x00\x00\x00\x00\x00\x00\x00\x07"
            b"\x00\x00\x00\x00\x00\x00\x00\x09"
        )
        # Sum → one double: 2.5 = sign 0, exp 1024 (0x400), mantissa
        # .25 → 0x4004000000000000
        assert serialize_state(Sum("c"), SumState(2.5)) == (
            b"\x40\x04\x00\x00\x00\x00\x00\x00"
        )
        # Mean → double + long: 10.5 = 0x4025000000000000, count 4
        assert serialize_state(Mean("c"), MeanState(10.5, 4)) == (
            b"\x40\x25\x00\x00\x00\x00\x00\x00"
            b"\x00\x00\x00\x00\x00\x00\x00\x04"
        )
        # StdDev → three doubles (n, avg, m2) = (4.0, 2.5, 1.25):
        # 4.0 = 0x4010…, 2.5 = 0x4004…, 1.25 = 0x3FF4…
        assert serialize_state(
            StandardDeviation("c"), StandardDeviationState(4.0, 2.5, 1.25)
        ) == (
            b"\x40\x10\x00\x00\x00\x00\x00\x00"
            b"\x40\x04\x00\x00\x00\x00\x00\x00"
            b"\x3f\xf4\x00\x00\x00\x00\x00\x00"
        )
        # Correlation → six doubles (n,xAvg,yAvg,ck,xMk,yMk) =
        # (3.0, 1.0, 2.0, 0.5, 0.25, 0.125) = 0x4008…, 0x3FF0…,
        # 0x4000…, 0x3FE0…, 0x3FD0…, 0x3FC0…
        assert serialize_state(
            Correlation("a", "b"),
            CorrelationState(3.0, 1.0, 2.0, 0.5, 0.25, 0.125),
        ) == (
            b"\x40\x08\x00\x00\x00\x00\x00\x00"
            b"\x3f\xf0\x00\x00\x00\x00\x00\x00"
            b"\x40\x00\x00\x00\x00\x00\x00\x00"
            b"\x3f\xe0\x00\x00\x00\x00\x00\x00"
            b"\x3f\xd0\x00\x00\x00\x00\x00\x00"
            b"\x3f\xc0\x00\x00\x00\x00\x00\x00"
        )
        # DataType → int length prefix 40 (0x28) + five longs
        assert serialize_state(
            DataType("c"), DataTypeHistogram(1, 2, 3, 4, 5)
        ) == (
            b"\x00\x00\x00\x28"
            b"\x00\x00\x00\x00\x00\x00\x00\x01"
            b"\x00\x00\x00\x00\x00\x00\x00\x02"
            b"\x00\x00\x00\x00\x00\x00\x00\x03"
            b"\x00\x00\x00\x00\x00\x00\x00\x04"
            b"\x00\x00\x00\x00\x00\x00\x00\x05"
        )


class TestHllGoldenLayout:
    def test_words_are_length_prefixed_52_longs(self):
        """reference: 512 6-bit registers packed into NUM_WORDS=52 longs
        (StatefulHyperloglogPlus.scala:154)."""
        from deequ_tpu_torch.analyzers import ApproxCountDistinct
        from deequ_tpu_torch.analyzers.sketch import ApproxCountDistinctState
        from deequ_tpu_torch.ops.sketches import hll

        registers = np.zeros(hll.M, dtype=np.int32)
        registers[0] = 5
        registers[10] = 63
        blob = serialize_state(
            ApproxCountDistinct("c"), ApproxCountDistinctState(registers)
        )
        (length,) = struct.unpack(">i", blob[:4])
        assert length == 52 * 8
        words = struct.unpack(">52q", blob[4:])
        # register 0 lives in the low 6 bits of word 0
        assert words[0] & 0x3F == 5
        restored = deserialize_state(ApproxCountDistinct("c"), blob)
        assert np.array_equal(restored.registers, registers)

    def test_register_count_is_512(self):
        from deequ_tpu_torch.ops.sketches import hll

        assert hll.M == 512  # p=9, from RELATIVE_SD=0.05


class TestRoundTripIdentity:
    """serialize∘deserialize is the identity on every scalar state."""

    @pytest.mark.parametrize(
        "analyzer, state",
        [
            (Size(), NumMatches(0)),
            (Size(), NumMatches(2**40)),
            (Completeness("c"), NumMatchesAndCount(0, 0)),
            (Sum("c"), SumState(float("inf"))),
            (Minimum("c"), MinState(-0.0)),
            (Mean("c"), MeanState(-1e300, 2**31)),
            (StandardDeviation("c"), StandardDeviationState(1.0, 0.0, 0.0)),
            (
                Correlation("a", "b"),
                CorrelationState(2.0, 1e-300, -1e300, 0.0, 1.0, 2.0),
            ),
            (DataType("c"), DataTypeHistogram(0, 0, 0, 0, 2**62)),
        ],
        ids=lambda v: repr(v)[:40],
    )
    def test_round_trip(self, analyzer, state):
        blob = serialize_state(analyzer, state)
        restored = deserialize_state(analyzer, blob)
        assert type(restored) is type(state)
        assert restored == state
        # byte-level identity: re-serializing must reproduce the blob,
        # which pins sign bits (-0.0) and other ==-invisible detail
        assert serialize_state(analyzer, restored) == blob
