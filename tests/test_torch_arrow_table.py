"""The port's Arrow, pandas and Parquet surface of `Table` against the
JAX package's: the same Arrow tables, DataFrames and Parquet files go
through both, and every column must come out with the same name, type,
validity and values (bit for bit), for every ColumnType: timestamps,
decimals, all-null strings, sliced and multi-chunk arrays and dictionary
columns. Port-mapped cases of tests/test_table_and_expr.py ride along."""

from __future__ import annotations

import decimal
import math

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from deequ_tpu.data.table import Table as JTable
from deequ_tpu_torch.data import table as ptable
from deequ_tpu_torch.data.table import Column, ColumnType
from deequ_tpu_torch.data.table import Table as PTable


def arrow_table(n=97, seed=3):
    rng = np.random.default_rng(seed)
    words = np.array(["α", "beta", "", "Ωmega", "x y"], dtype=object)

    def nulls(values, every):
        return [None if i % every == 0 else v for i, v in enumerate(values)]

    stamps = (rng.integers(1_500_000_000, 1_700_000_000, n) * 1_000_000).astype("datetime64[us]")
    floats = rng.normal(0, 10, n)
    floats[::13] = np.nan
    return pa.table(
        {
            "i": pa.array(nulls(rng.integers(-50, 50, n).tolist(), 7), type=pa.int64()),
            "i8": pa.array(rng.integers(-100, 100, n), type=pa.int8()),
            "f": pa.array(nulls(floats.tolist(), 5), type=pa.float64()),
            "f32": pa.array(rng.normal(0, 1, n).astype(np.float32)),
            "b": pa.array(nulls([bool(v) for v in rng.integers(0, 2, n)], 4)),
            "s": pa.array(nulls(words[rng.integers(0, 5, n)].tolist(), 6), type=pa.string()),
            "ls": pa.array(words[rng.integers(0, 5, n)].tolist(), type=pa.large_string()),
            "d": pa.array(nulls(words[rng.integers(0, 5, n)].tolist(), 3)).dictionary_encode(),
            "di": pa.array(rng.integers(0, 4, n)).dictionary_encode(),
            "ts": pa.array(nulls(list(stamps), 9)),
            "tsms": pa.array(list(stamps)).cast(pa.timestamp("ms")),
            "dec": pa.array(
                nulls([decimal.Decimal(f"{v}.{v % 100:02d}") for v in rng.integers(0, 9999, n)], 8),
                type=pa.decimal128(12, 2),
            ),
            "nulls": pa.array([None] * n, type=pa.string()),
            "empty_dict": pa.array([None] * n, type=pa.string()).dictionary_encode(),
        }
    )


def same_value(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or np.float64(a).tobytes() == np.float64(b).tobytes()
    return a == b and type(a) is type(b)


def assert_same_table(jt, pt):
    assert pt.num_rows == jt.num_rows
    assert [(n, t.name) for n, t in pt.schema] == [(n, t.name) for n, t in jt.schema]
    for name in jt.column_names:
        jc, pc = jt.column(name), pt.column(name)
        np.testing.assert_array_equal(pc.valid, jc.valid)
        assert pc.null_count == jc.null_count
        jv, pv = np.asarray(jc.values), np.asarray(pc.values)
        assert pv.dtype == jv.dtype, name
        if pv.dtype.kind == "f":
            assert pv.tobytes() == jv.tobytes(), name
        else:
            assert pv.tolist() == jv.tolist(), name
        np.testing.assert_array_equal(pc.non_null_values(), jc.non_null_values())
        if pc.ctype not in (ColumnType.STRING,):
            assert pc.as_float().tobytes() == jc.as_float().tobytes(), name
        pcodes, puniques = pc.dict_encode()
        jcodes, juniques = jc.dict_encode()
        assert [puniques[c] if c >= 0 else None for c in pcodes] == [
            juniques[c] if c >= 0 else None for c in jcodes
        ], name


def test_from_arrow_equals_jax():
    at = arrow_table()
    assert_same_table(JTable.from_arrow(at), PTable.from_arrow(at))


@pytest.mark.parametrize("offset,length", [(0, 97), (5, 40), (60, 37), (96, 1), (10, 0)])
def test_from_arrow_sliced_equals_jax(offset, length):
    at = arrow_table().slice(offset, length)
    assert_same_table(JTable.from_arrow(at), PTable.from_arrow(at))


def test_from_arrow_multi_chunk_equals_jax():
    at = pa.concat_tables([arrow_table(40, 1), arrow_table(30, 2).slice(3), arrow_table(25, 3)])
    assert at.column("d").num_chunks == 3
    assert_same_table(JTable.from_arrow(at), PTable.from_arrow(at))


def test_string_dictionary_column_is_lazy():
    """A string dictionary column keeps its codes as its dictionary
    encode and builds per-row strings only when `values` is read."""
    at = arrow_table()
    col = PTable.from_arrow(at).column("d")
    assert col._values is None
    codes, uniques = col.dict_encode()
    assert col._values is None
    assert codes.dtype == np.int32 and col._dict_content_key is not None
    expected = [v if v is not None else "" for v in at.column("d").to_pylist()]
    assert col.values.tolist() == expected
    assert col.slice(3, 9).values.tolist() == expected[3:9]


def test_dictionary_derived_values_are_shared_across_equal_dictionaries():
    at = pa.table({"s": pa.array(["1", "2", None, "x"] * 5).dictionary_encode()})
    first, second = PTable.from_arrow(at).column("s"), PTable.from_arrow(at).column("s")
    assert first is not second and first._dict_content_key == second._dict_content_key
    assert ptable.parsed_dictionary(first) is ptable.parsed_dictionary(second)
    assert ptable.hashed_dictionary(first) is ptable.hashed_dictionary(second)


@pytest.mark.parametrize("encode", [False, True], ids=["plain", "dict"])
def test_to_arrow_equals_jax(encode):
    at = arrow_table()
    jout = JTable.from_arrow(at).to_arrow(dictionary_encode_strings=encode)
    pout = PTable.from_arrow(at).to_arrow(dictionary_encode_strings=encode)
    assert pout.schema == jout.schema
    assert pout.schema.field("dec").metadata == {b"deequ_tpu.logical_type": b"DecimalType"}
    assert pout.equals(jout)


@pytest.mark.parametrize("encode", [False, True], ids=["plain", "dict"])
def test_parquet_round_trip_equals_jax(tmp_path, encode):
    at = arrow_table()
    ppath, jpath = str(tmp_path / "port.parquet"), str(tmp_path / "jax.parquet")
    PTable.from_arrow(at).to_parquet(ppath, row_group_size=20, dictionary_encode_strings=encode)
    JTable.from_arrow(at).to_parquet(jpath, row_group_size=20, dictionary_encode_strings=encode)
    assert pq.read_table(ppath).equals(pq.read_table(jpath))
    back = PTable.from_parquet(ppath)
    assert_same_table(JTable.from_parquet(jpath), back)
    assert back.column("dec").ctype == ColumnType.DECIMAL
    assert_same_table(JTable.from_parquet(jpath, columns=["s", "ts"]), PTable.from_parquet(ppath, columns=["s", "ts"]))


def pandas_frame(n=50, seed=9):
    rng = np.random.default_rng(seed)
    return pd.DataFrame(
        {
            "i": rng.integers(0, 9, n),
            "ni": pd.array([None if i % 4 == 0 else int(i) for i in range(n)], dtype="Int64"),
            "f": np.where(rng.random(n) < 0.2, np.nan, rng.normal(0, 1, n)),
            "nf": pd.array([None if i % 5 == 0 else i / 3 for i in range(n)], dtype="Float64"),
            "b": rng.random(n) < 0.5,
            "nb": pd.array([None if i % 6 == 0 else bool(i % 2) for i in range(n)], dtype="boolean"),
            "ob": np.array([True, False, None], dtype=object)[rng.integers(0, 3, n)],
            "s": np.array(["a", "bb", None, "ç"], dtype=object)[rng.integers(0, 4, n)],
            "mixed": np.array([1, "a", 2.5, None], dtype=object)[rng.integers(0, 4, n)],
            "ts": pd.to_datetime(rng.integers(1_500_000_000, 1_700_000_000, n), unit="s"),
        }
    )


def test_from_pandas_equals_jax():
    df = pandas_frame()
    assert_same_table(JTable.from_pandas(df), PTable.from_pandas(df))


def test_to_pandas_round_trip_equals_jax():
    data = {"x": [1, 2, None], "y": ["a", None, "c"], "z": [0.5, None, 2.0], "b": [True, None, False]}
    jt, pt = JTable.from_pydict(data), PTable.from_pydict(data)
    jdf, pdf = jt.to_pandas(), pt.to_pandas()
    pd.testing.assert_frame_equal(pdf, jdf)
    t2 = PTable.from_pandas(pdf)
    assert_same_table(JTable.from_pandas(jdf), t2)
    assert t2.num_rows == 3 and t2["y"].null_count == 1


def test_infer_types_and_null_counts():
    t = PTable.from_pydict({"s": ["a", None], "i": [1, 2], "f": [1.0, None], "b": [True, False]})
    assert dict(t.schema) == {
        "s": ColumnType.STRING, "i": ColumnType.LONG, "f": ColumnType.DOUBLE, "b": ColumnType.BOOLEAN,
    }
    assert (t["s"].null_count, t["i"].null_count, t["f"].null_count) == (1, 0, 1)
    assert t["s"].non_null_values().tolist() == ["a"]
    assert t["f"].as_float().tolist() == [1.0, 0.0]


def test_arrow_parquet_round_trip_null_counts(tmp_path):
    at = pa.table({"a": [1, 2, None], "b": [1.5, None, 2.5], "c": ["x", "y", None]})
    path = str(tmp_path / "t.parquet")
    pq.write_table(at, path)
    t = PTable.from_parquet(path)
    assert t.num_rows == 3
    assert (t["a"].null_count, t["b"].null_count, t["c"].null_count) == (1, 1, 1)
    assert t["a"].ctype == ColumnType.LONG


def test_string_as_float_parses_like_jax():
    data = {"s": ["10", "1_0", "٥", "2.5", None, "x"]}
    assert PTable.from_pydict(data)["s"].as_float().tobytes() == (
        JTable.from_pydict(data)["s"].as_float().tobytes()
    )


def test_lazy_values_length_is_checked():
    col = Column("x", ColumnType.STRING, lambda: np.array(["a"], dtype=object), np.ones(2, bool))
    assert len(col) == 2
    with pytest.raises(ValueError, match="1 values but 2 mask entries"):
        col.values


def test_pool_empty_is_writable():
    out = ptable.pool_empty(16, np.float64)
    out[:] = 1.5
    assert out.dtype == np.float64 and out.sum() == 24.0
