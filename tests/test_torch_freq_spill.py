"""Frequencies spilled to disk (analyzers/freq_spill.py): with
DEEQU_TPU_MAX_GROUPS_IN_MEMORY set low, the frequency analyzers and
Histogram over a streamed source spill their groups to hash partitions,
and must give the JAX package's spilled results and the port's
in-memory results: group counts, histograms and count ratios exactly,
entropy and mutual information (sums of logarithms, reduced partition by
partition in another order) within 1e-12. Port-mapped from
tests/test_freq_spill.py at a smaller size."""

from __future__ import annotations

import gc
import os

import numpy as np
import pytest

import deequ_tpu.analyzers as J
import deequ_tpu_torch.analyzers as P
from deequ_tpu.analyzers.frequency import compute_frequencies as jcompute
from deequ_tpu.data.table import Table as JTable
from deequ_tpu.runners.analysis_runner import AnalysisRunner as JRunner
from deequ_tpu_torch.analyzers.freq_spill import (
    GroupCountAccumulator,
    SpilledFrequencies,
    _SpillWriter,
)
from deequ_tpu_torch.analyzers.frequency import FrequenciesAndNumRows, compute_frequencies, top_n_order
from deequ_tpu_torch.data.table import Table as PTable
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner as PRunner
from torch_stream_helpers import assert_contexts_equal, plain_route, write_parquet

N_ROWS = 6000
CAP = 500
BATCH = 1000


@pytest.fixture(autouse=True)
def _small_cap(monkeypatch):
    plain_route(monkeypatch)
    monkeypatch.setenv("DEEQU_TPU_MAX_GROUPS_IN_MEMORY", str(CAP))


@pytest.fixture(scope="module")
def high_card_parquet(tmp_path_factory):
    rng = np.random.default_rng(11)
    ids = np.array([f"id_{i:06d}" for i in range(N_ROWS)], dtype=object)
    rng.shuffle(ids)
    ids[::100] = "dup_key"  # a few repeats, so uniqueness < 1
    cat = np.array(["x", "y", "z"], dtype=object)[rng.integers(0, 3, N_ROWS)]
    num = rng.integers(0, 2 * N_ROWS, N_ROWS)
    return write_parquet(
        tmp_path_factory.mktemp("spill"), "high_card.parquet", {"id": ids, "cat": cat, "num": num}, 800
    )


def grouping(m):
    return [
        m.Uniqueness(["id"]),
        m.Distinctness(["id"]),
        m.UniqueValueRatio(["id"]),
        m.CountDistinct(["id"]),
        m.Entropy("id"),
        m.Uniqueness(["num"]),
        m.Entropy("num"),
        m.Uniqueness(["id", "cat"]),
        m.CountDistinct(["id", "cat"]),
        m.UniqueValueRatio(["cat", "id"]),  # declared order differs from sorted
        m.MutualInformation("id", "cat"),
        m.Histogram("id", max_detail_bins=5),
        m.Histogram("num", max_detail_bins=9),
    ]


def test_spilled_metrics_equal_jax_and_in_memory(high_card_parquet):
    jan, pan = grouping(J), grouping(P)
    source = PTable.scan_parquet(high_card_parquet, batch_rows=BATCH)
    with runtime.monitored() as stats:
        pctx = PRunner.on_data(source, device="cpu").add_analyzers(pan).run()
    assert stats.group_passes == 5  # 3 column sets, 2 histograms
    jctx = JRunner.on_data(JTable.scan_parquet(high_card_parquet, batch_rows=BATCH)).with_engine(
        "single"
    ).add_analyzers(jan).run()
    assert_contexts_equal(jctx, pctx, jan, pan)
    memory = PRunner.on_data(PTable.from_parquet(high_card_parquet), device="cpu").add_analyzers(pan)
    assert_contexts_equal(memory.run(), pctx, pan, pan)


@pytest.mark.parametrize("columns", [["id"], ["cat", "id"], ["num"]], ids="+".join)
def test_streamed_state_spills_like_jax(high_card_parquet, columns):
    state = compute_frequencies(PTable.scan_parquet(high_card_parquet, batch_rows=BATCH), columns)
    jstate = jcompute(JTable.scan_parquet(high_card_parquet, batch_rows=BATCH), columns)
    assert isinstance(state, SpilledFrequencies) and state.is_spilled and jstate.is_spilled
    assert (state.num_rows, state.num_groups) == (jstate.num_rows, jstate.num_groups)
    if columns == ["id"]:
        # dup_key overwrote every 100th id: 60 ids gone, one key new
        assert state.num_groups == N_ROWS - N_ROWS // 100 + 1
    # the same hash routes every key to the same partition as the JAX
    # package's, with the same count
    mine = [dict(zip(zip(*[k.tolist() for k in p.key_columns]), p.counts.tolist())) for p in state.partitions()]
    theirs = [dict(zip(zip(*[k.tolist() for k in p.key_columns]), p.counts.tolist())) for p in jstate.partitions()]
    assert mine == theirs
    if len(columns) == 1:
        (pkeys,), pcounts = state.top_n(7)
        (jkeys,), jcounts = jstate.top_n(7)
        assert pkeys.tolist() == jkeys.tolist() and pcounts.tolist() == jcounts.tolist()


def test_histogram_over_spilled_state(high_card_parquet):
    analyzer = P.Histogram("id", max_detail_bins=5)
    state = analyzer.compute_state_from(PTable.scan_parquet(high_card_parquet, batch_rows=BATCH))
    assert isinstance(state, SpilledFrequencies) and state.num_rows == N_ROWS
    dist = analyzer.compute_metric_from(state).value.get()
    assert dist.values["dup_key"].absolute == N_ROWS // 100
    assert dist.number_of_bins == N_ROWS - N_ROWS // 100 + 1
    assert len(dist.values) == 5


def test_accumulator_resident_groups_stay_bounded(high_card_parquet):
    acc = GroupCountAccumulator(["id"], max_groups_in_memory=CAP)
    max_resident = 0
    for batch in PTable.scan_parquet(high_card_parquet, batch_rows=BATCH).batches(BATCH):
        acc.add(compute_frequencies(batch, ["id"]))
        if acc._buffer is not None:
            max_resident = max(max_resident, acc._buffer.num_groups)
    assert isinstance(acc.finalize(), SpilledFrequencies)
    assert max_resident <= CAP + BATCH


def test_below_the_cap_nothing_spills(high_card_parquet, monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_MAX_GROUPS_IN_MEMORY", str(10 * N_ROWS))
    state = compute_frequencies(PTable.scan_parquet(high_card_parquet, batch_rows=BATCH), ["id"])
    assert isinstance(state, FrequenciesAndNumRows)
    assert state == compute_frequencies(PTable.from_parquet(high_card_parquet), ["id"])


def test_spill_writer_cleans_up_on_abandonment():
    writer = _SpillWriter(["c"])
    writer.append(
        FrequenciesAndNumRows(["c"], [np.array(["a", "b"], dtype=object)], np.array([1, 2]), 2)
    )
    directory = writer.directory
    assert os.path.isdir(directory)
    del writer
    gc.collect()
    assert not os.path.exists(directory)


def test_spilled_state_removes_its_directory():
    acc = GroupCountAccumulator(["c"], max_groups_in_memory=1)
    acc.add(FrequenciesAndNumRows(["c"], [np.array(["a", "b"], dtype=object)], np.array([1, 2]), 3))
    state = acc.finalize()
    directory = state.directory
    assert os.path.isdir(directory)
    del state
    gc.collect()
    assert not os.path.exists(directory)


def test_top_n_tie_break_is_deterministic(tmp_path):
    keys = np.array(["b", "d", "a", "c", "e"], dtype=object)
    order = top_n_order(keys, np.array([2, 1, 2, 2, 1]), 4)
    assert list(keys[order]) == ["a", "b", "c", "d"]
    n = 3000  # all unique: every count ties at 1
    path = write_parquet(tmp_path, "ties.parquet", {"id": [f"k{i:06d}" for i in range(n)]}, 500)
    analyzer = P.Histogram("id", max_detail_bins=7)

    def details(data):
        ctx = PRunner.on_data(data, device="cpu").add_analyzers([analyzer]).run()
        return list(ctx.metric_map[analyzer].value.get().values)

    assert details(PTable.from_parquet(path)) == details(PTable.scan_parquet(path, batch_rows=BATCH))
    assert details(PTable.from_parquet(path)) == [f"k{i:06d}" for i in range(7)]


def test_spilled_merge_with_in_memory_partial():
    keys_a = np.array([f"k{i}" for i in range(3000)], dtype=object)
    keys_b = np.array([f"k{i}" for i in range(1500, 4500)], dtype=object)
    acc = GroupCountAccumulator(["c"], max_groups_in_memory=500)
    acc.add(FrequenciesAndNumRows(["c"], [keys_a], np.ones(len(keys_a), dtype=np.int64), len(keys_a)))
    acc.add(FrequenciesAndNumRows(["c"], [keys_b], np.ones(len(keys_b), dtype=np.int64), len(keys_b)))
    spilled = acc.finalize()
    assert isinstance(spilled, SpilledFrequencies)
    assert (spilled.num_groups, spilled.num_rows) == (4500, 6000)
    extra = FrequenciesAndNumRows(
        ["c"], [np.array(["k0", "new"], dtype=object)], np.array([7, 3], dtype=np.int64), 10
    )
    for merged in (spilled.merge(extra), extra.merge(spilled)):
        assert (merged.num_groups, merged.num_rows) == (4501, 6010)
        total = sum(
            int(c) for part in merged.partitions() for k, c in zip(part.key_columns[0], part.counts) if k == "k0"
        )
        assert total == 1 + 7
    assert extra.num_rows == 10 and spilled.num_rows == 6000  # operands unchanged
