"""The comparison that decides `correct`: the references against the
generators, the control (the reference in float32 in the program's
place) caught in every cell, and the harness with the program broken
underneath coming out not correct."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from bench_helpers import CELLS, TINY, tiny_run

from benchmark import core
from benchmark.gen import lineitem
from benchmark.reference import plain

CONFIG = {"rows": 2000, "row_group_rows": 512, "compression": "zstd", "scale_factor": 1,
          "text_pool_bytes": 1 << 16}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught(cell, tmp_path):
    entry = core.resolve(cell)
    gen = core.load_module("gen", entry.config["generator"])
    reference = core.load_module("reference", entry.traffic_name)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        data = gen.make(entry.config, seed, str(tmp_path / str(seed)), **TINY[cell])
        numbers = reference.control(core.Context(entry, data, seed, str(tmp_path), "cpu"))
        assert any(value > limit for _, value, limit in numbers), numbers


def test_lineitem_generator_follows_clause_4_2_3(tmp_path):
    """Row by row in Python: unique sparse keys with line numbers in
    sequence, the date, flag, supplier and price rules, comment lengths;
    and the file holds the arrays."""
    data = lineitem.make(CONFIG, 2**32 + 9, str(tmp_path))
    num = {k: v.tolist() for k, v in data.numeric.items()}
    day = {c: [lineitem.ALL_DAYS.tolist().index(s) for s in data.strings(c)]
           for c in ("l_shipdate", "l_commitdate", "l_receiptdate")}
    flags, status = data.strings("l_returnflag"), data.strings("l_linestatus")
    lines = {}
    for i in range(data.rows):
        key, line, part = num["l_orderkey"][i], num["l_linenumber"][i], num["l_partkey"][i]
        assert 1 <= key % 32 <= 7 or (key % 32 == 0 and key > 0)
        lines.setdefault(key, []).append(line)
        assert 1 <= day[c := "l_receiptdate"][i] - day["l_shipdate"][i] <= 30, c
        assert -91 + 1 <= day["l_shipdate"][i] - day["l_commitdate"][i] <= 121 - 30
        assert flags[i] == ("N" if day["l_receiptdate"][i] > lineitem.CURRENT_DAY else flags[i])
        assert flags[i] in (("A", "R") if day["l_receiptdate"][i] <= lineitem.CURRENT_DAY
                            else ("N",))
        assert status[i] == ("O" if day["l_shipdate"][i] > lineitem.CURRENT_DAY else "F")
        s = 10_000
        assert num["l_suppkey"][i] in {(part + j * (s // 4 + (part - 1) // s)) % s + 1
                                       for j in range(4)}
        cents = 90_000 + (part // 10) % 20_001 + 100 * (part % 1_000)
        assert num["l_extendedprice"][i] == num["l_quantity"][i] * cents / 100
    assert all(v == list(range(1, len(v) + 1)) and len(v) <= 7 for v in lines.values())
    assert sum(map(len, lines.values())) == data.rows == 2000

    import pyarrow.parquet as pq

    table = pq.read_table(data.path)
    assert table.column_names == list(lineitem.COLUMNS)
    assert table["l_shipmode"].to_pylist() == list(data.strings("l_shipmode"))
    comments = table["l_comment"].to_pylist()
    assert comments == list(data.strings("l_comment"))
    assert all(10 <= len(c) <= 43 for c in comments)
    assert np.array_equal(table["l_extendedprice"].to_numpy(), data.numeric["l_extendedprice"])
    meta = pq.ParquetFile(data.path).metadata
    assert meta.num_row_groups == 4
    assert "PLAIN" in meta.row_group(0).column(15).encodings
    again = lineitem.make(CONFIG, 2**32 + 9, str(tmp_path), write_file=False)
    assert all(np.array_equal(again.numeric[k], v) for k, v in data.numeric.items())


def test_comment_keys_count_distinct_texts():
    pool = np.frombuffer(b"ab ab ab abc ba" * 4, dtype=np.uint8)
    rng = np.random.default_rng(4)
    starts, lengths = rng.integers(0, len(pool) - 6, 400), rng.integers(1, 7, 400)
    comments = lineitem.Comments(pool, starts, lengths)
    assert plain.distinct_count(comments.keys()) == len(set(comments.values()))


def test_profile_reference_against_python_loops(tmp_path):
    data = lineitem.generate(400, 2**31 + 77, pool_bytes=1 << 16)
    exp = core.load_module("reference", "profile").expected(data)
    q = [int(v) for v in data.numeric["l_quantity"]]
    mean = sum(q) / len(q)
    assert exp.moments["l_quantity.sum"] == sum(q)
    assert math.isclose(exp.moments["l_quantity.mean"], mean, rel_tol=1e-15)
    assert math.isclose(exp.moments["l_quantity.stdDev"],
                        math.sqrt(sum((v - mean) ** 2 for v in q) / len(q)), rel_tol=1e-12)
    assert exp.distinct["l_quantity.approximateNumDistinctValues"] == len(set(q))
    flags = list(data.strings("l_returnflag"))
    assert exp.exact["l_returnflag.histogram"] == {f: flags.count(f) for f in set(flags)}
    assert exp.distinct["l_comment.approximateNumDistinctValues"] == len(
        set(data.strings("l_comment")))
    index, probabilities = exp.quantiles["l_quantity.approxPercentiles"]
    assert index.quantile(0.5) == sorted(q)[199]
    assert index.ranks(25) == (sum(v < 25 for v in q) / 400, sum(v <= 25 for v in q) / 400)


def test_verify_reference_against_python_loops():
    data = lineitem.generate(600, 2**31 + 78, pool_bytes=1 << 16)
    from benchmark.reference.constraints import metric
    from benchmark.reference.verify import columns

    cols, rows = columns(data), data.rows
    modes = list(data.strings("l_shipmode"))
    spec = {"kind": "contained_in", "column": "l_shipmode", "values": ["AIR", "RAIL"]}
    assert metric(spec, cols, np.float64)[2] == sum(m in ("AIR", "RAIL") for m in modes) / rows
    spec = {"kind": "pattern", "column": "l_shipdate", "pattern": r"-0[1-6]-"}
    dates = list(data.strings("l_shipdate"))
    assert metric(spec, cols, np.float64)[2] == sum("-0" + d[6] + "-" == d[4:8] and d[6] in
                                                    "123456" for d in dates) / rows
    spec = {"kind": "satisfies", "name": "q", "predicate": {"column": "l_quantity", "gt": 25}}
    quantity = data.numeric["l_quantity"].tolist()
    assert metric(spec, cols, np.float64)[2] == sum(q > 25 for q in quantity) / rows
    keys = list(zip(data.numeric["l_orderkey"].tolist(), data.numeric["l_linenumber"].tolist()))
    key_spec = {"kind": "primary_key", "columns": ["l_orderkey", "l_linenumber"]}
    assert metric(key_spec, cols, np.float64)[2] == sum(keys.count(k) == 1 for k in keys) / rows
    key_spec["columns"] = ["l_orderkey"]
    orders = [k for k, _ in keys]
    assert metric(key_spec, cols, np.float64)[2] == sum(orders.count(k) == 1
                                                        for k in orders) / rows
    assert metric({"kind": "complete", "column": "l_comment"}, cols, np.float64)[2] == 1.0


def test_rank_index_integers_and_floats_agree():
    rng = np.random.default_rng(3)
    ints = rng.integers(0, 20, 1000)
    a, b = plain.RankIndex(ints), plain.RankIndex(ints.astype(np.float64))
    for q in (-1, 0, 3, 3.5, 19, 25):
        assert a.ranks(q) == b.ranks(q)
    for p in (0.01, 0.5, 1.0):
        assert a.quantile(p) == b.quantile(p)


def _halve_batches(monkeypatch):
    """Half of every batch left out: the scan sees the first half alone."""
    from deequ_tpu_torch.data.source import ParquetSource

    original = ParquetSource._iter_tables

    def half(self, batch_size):
        for table in original(self, batch_size):
            yield table.slice(0, table.num_rows // 2)

    monkeypatch.setattr(ParquetSource, "_iter_tables", half)


def _alter_moments(monkeypatch):
    """An answer altered where it is produced: K1's sum off by 1e-9."""
    from deequ_tpu_torch.ops import cuda_kernels

    original = cuda_kernels.masked_moments

    def altered(x, m):
        out = original(x, m).clone()
        out[1] = out[1] * (1 + 1e-9)
        return out

    monkeypatch.setattr(cuda_kernels, "masked_moments", altered)


def _alter_predicates(monkeypatch):
    """An answer altered where it is produced: every predicate's first row flipped."""
    from deequ_tpu_torch.data.expr import Predicate

    original = Predicate.eval_mask

    def altered(self, table):
        mask = np.array(original(self, table), copy=True)
        if len(mask):
            mask[0] = not mask[0]
        return mask

    monkeypatch.setattr(Predicate, "eval_mask", altered)


FAULTS = {"half_batch": _halve_batches, "altered_moments": _alter_moments,
          "altered_predicates": _alter_predicates}
CELL_FAULTS = [(cell, fault) for cell in CELLS for fault in
               (("half_batch", "altered_predicates") if cell == "lineitem.verify"
                else ("half_batch", "altered_moments"))]


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_broken_program_is_not_correct(cell, fault, tmp_path, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = tiny_run(cell, tmp_path)
    assert result["correct"] is False, result["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught_on_the_card_at_cell_size(cell, tmp_path):
    """The control at the cell's own size, on three seeds (the machine
    with the card has the memory for it)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's size is for the card's host")
    from benchmark.control import control_numbers

    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        numbers = control_numbers(cell, seed, str(tmp_path / str(seed)))
        print(json.dumps({"control": cell, "seed": seed, "numbers": numbers}))  # the readings
        assert any(value > limit for _, value, limit in numbers), numbers


@pytest.mark.card
@pytest.mark.parametrize("cell", ("lineitem.profile", "lineitem.scan"))
def test_half_batch_is_caught_on_the_card_at_cell_size(cell, tmp_path, monkeypatch):
    """The fault that sets `distinct_rel_err`'s upper reading: half of
    every batch left out, at the cell's own size, on three seeds."""
    import time

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's size is for the card's host")
    _halve_batches(monkeypatch)
    for seed in (2**31 + 201, 2**31 + 202, 2**31 + 203):
        result = core.run_cell(cell, seed, 1.0, False, t0=time.perf_counter(),
                               workdir=str(tmp_path / str(seed)), log=lambda line: None)
        print(json.dumps({"fault": "half_batch", "cell": cell, "seed": seed,
                          "checks": result["checks"]}))  # the readings
        assert result["correct"] is False, result["checks"]


def test_verify_key_spills_past_the_configured_cap(tmp_path, monkeypatch):
    """The verify cell's group-by cap, cut with the rows in the
    configuration, makes the key's groups spill; the run stays correct."""
    from deequ_tpu_torch.analyzers import freq_spill

    spills = []
    original = freq_spill._SpillWriter.__init__

    def counted(self, *args, **kwargs):
        spills.append(1)
        original(self, *args, **kwargs)

    monkeypatch.setattr(freq_spill._SpillWriter, "__init__", counted)
    entry = core.resolve("lineitem.verify")
    assert int(entry.config["knobs"]["DEEQU_TPU_MAX_GROUPS_IN_MEMORY"]) < entry.config["rows"]
    cap = int(entry.config["knobs"]["DEEQU_TPU_MAX_GROUPS_IN_MEMORY"]) * TINY[
        "lineitem.verify"]["rows"] // entry.config["rows"]
    monkeypatch.setitem(entry.config, "knobs", {"DEEQU_TPU_MAX_GROUPS_IN_MEMORY": str(cap)})
    monkeypatch.setattr(core, "resolve", lambda *a, **k: entry)
    result = tiny_run("lineitem.verify", tmp_path)
    assert spills and result["correct"] is True, result["checks"]
