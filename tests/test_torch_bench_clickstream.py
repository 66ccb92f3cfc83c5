"""The benchmark's `clickstream.mesh4` cell on the CPU at a small size:
NEXMark's bid generator against its rules, the `bid_report` reference
against Python loops, the cell's comparison (a sound run over a
four-shard CPU mesh correct, the float32 control and a fold that drops
a shard caught), and the mesh pass's spans, counters and the metric
readers that read them."""

from __future__ import annotations

import math
import time
import warnings

import numpy as np
import pytest

from benchmark import core
from benchmark.gen import nexmark
from benchmark.reference import bid_report

CELL = "clickstream.mesh4"
ROWS = 46_000  # 50,000 events
SEED = 2**31 + 25
SHARDS = 4
PER_DEVICE = 4096  # the traced runs' shard rows: 46,000 rows in 3 batches
BATCHES = -(-ROWS // (SHARDS * PER_DEVICE))


def _tiny_run(tmp_path, seed=SEED, trace=False, lines=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return core.run_cell(CELL, seed, 0.3, trace, t0=time.perf_counter(),
                             workdir=str(tmp_path), device="cpu", sizes={"rows": ROWS},
                             log=(lines.append if lines is not None else lambda line: None))


def _context(tmp_path, seed=SEED):
    cell = core.resolve(CELL)
    data = nexmark.make(cell.config, seed, str(tmp_path), rows=ROWS)
    return core.Context(cell, data, seed, str(tmp_path), "cpu")


def _small_shards(mp):
    """Shards of `PER_DEVICE` rows, so that the tiny table spans batches
    and every shard of a full batch holds rows (at the default 2^21 rows
    a shard, 46,000 rows are one batch and the fourth shard is padding)."""
    from deequ_tpu_torch.parallel import distributed

    class Small(distributed.DistributedScanPass):
        def __init__(self, analyzers, mesh=None, controller=None):
            super().__init__(analyzers, mesh=mesh, batch_size_per_device=PER_DEVICE,
                             controller=controller)

    mp.setattr(distributed, "DistributedScanPass", Small)


@pytest.fixture(scope="module")
def data():
    return nexmark.generate(nexmark.events_for(ROWS), SEED, flags=True)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A traced window of the cell's driver over a four-shard CPU mesh of
    `PER_DEVICE` rows a shard, with the engine counts of each request:
    (the run's record, [ExecutionStats a request])."""
    from deequ_tpu_torch.observe import counters

    driver = core.load_module("drivers", "table_loop")
    ctx = _context(tmp_path_factory.mktemp("traced"))
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _small_shards(mp)
        state = driver.setup(ctx)
        stats = []
        original = state["call"]

        def counted():
            with counters.monitored() as s:
                result = original()
            stats.append(s)
            return result

        state["call"] = counted
        iterations = core.run_window(driver, state, ctx, 0.3, True)
    assert iterations and all(it.ok for it in iterations)
    return core.RunRecord(0.0, iterations, (0.0, 1.0), 0, True), stats


def test_generator_makes_46_bids_of_every_50_events(data):
    assert data.events == 50_000 and data.rows == ROWS == nexmark.bids_in(50_000)
    events = nexmark.bid_events(0, data.rows)
    assert [int(i) for i in events[:92]] == [i for i in range(100) if i % 50 >= 4]
    assert np.all(events % 50 >= 4) and len(np.unique(events)) == data.rows
    assert nexmark.events_for(92_000_000) == 100_000_000
    assert nexmark.bids_in(100_000_000) == 92_000_000


def test_generator_hot_draws_hold_their_ratios(data):
    assert abs(data.hot_bidder.mean() - 0.75) <= 0.01
    assert abs(data.hot_auction.mean() - 0.5) <= 0.01


def test_generator_ids_lie_in_their_windows(data):
    """Row by row in Python: each bid's auction and bidder against the
    rules for its event number."""
    events = nexmark.bid_events(0, data.rows).tolist()
    auction, bidder = data.columns["auction"].tolist(), data.columns["bidder"].tolist()
    for r, i in enumerate(events):
        last_person, last_auction = i // 50, (i // 50) * 3 + 2
        a, b = auction[r] - 1000, bidder[r] - 1000
        if data.hot_auction[r]:
            assert a == (last_auction // 100) * 100
        else:
            assert max(last_auction - 100, 0) <= a <= last_auction + 10
        if data.hot_bidder[r]:
            assert b == (last_person // 100) * 100 + 1
        else:
            active = min(last_person + 1, 1000)
            assert last_person + 1 - active <= b <= last_person + 1 + 9


def test_generator_prices_fall_a_third_in_each_band_within_one_day(data):
    price, when = data.columns["price"], data.columns["date_time"]
    assert price.min() >= 100 and price.max() <= 100_000_000
    shares = [np.mean(price < 10_000), np.mean((price >= 10_000) & (price < 1_000_000)),
              np.mean(price >= 1_000_000)]
    assert all(abs(s - 1 / 3) <= 0.01 for s in shares), shares
    events = nexmark.bid_events(0, data.rows)
    assert np.array_equal(when, nexmark.BASE_TIME_MS + events // 10_000)
    assert when.max() - nexmark.BASE_TIME_MS < 86_400_000


def test_generator_channels_urls_and_extras_keep_the_suite_rules(data):
    """Half the bids on the four hot channels; a url is its channel's,
    made once per channel; extras pad a bid to 100 bytes on average."""
    channel, url, extra = data.columns["channel"], data.columns["url"], data.columns["extra"]
    assert abs(data.hot_channel.mean() - 0.5) <= 0.01
    codes = channel.indices.to_numpy()
    assert np.array_equal(codes, url.indices.to_numpy())
    assert np.array_equal(codes < 4, data.hot_channel)
    names, urls = nexmark.channels(SEED)
    assert channel.dictionary.to_pylist() == names and url.dictionary.to_pylist() == urls
    assert names[:4] == ["Google", "Facebook", "Baidu", "Apple"] and names[4 + 17] == "channel-17"
    assert len(set(urls)) == len(urls) == 10_004
    for c in (0, 1, 2, 3, 5, 9999):
        tail = urls[4 + c].split("item.htm?query=1")[1]
        reverse = int(f"{c:032b}"[::-1], 2)
        signed = reverse - 2**32 if reverse >= 2**31 else reverse
        assert tail in ("", f"&channel_id={signed if signed == -2**31 else abs(signed)}")
    named = [u for u in urls[4:] if "&channel_id=" in u]
    assert abs(len(named) / 10_000 - 0.9) <= 0.01
    lengths = np.diff(np.frombuffer(extra.buffers()[1], dtype=np.int64))
    assert lengths.min() == 54 and lengths.max() == 81 and abs(lengths.mean() - 67.5) <= 0.2
    letters = np.frombuffer(extra.buffers()[2], dtype=np.uint8)[: lengths.sum()]
    assert letters.min() == ord("a") and letters.max() == ord("z")


def test_reference_copy_makes_the_same_numbers_and_no_strings(data, tmp_path):
    cell = core.resolve(CELL)
    copy = nexmark.make(cell.config, SEED, str(tmp_path), rows=ROWS, write_file=False)
    assert sorted(copy.columns) == sorted(nexmark.NUMBERS)
    assert all(np.array_equal(copy.columns[c], data.columns[c]) for c in nexmark.NUMBERS)


def test_generator_is_the_same_on_any_thread_count(data, monkeypatch):
    monkeypatch.setattr(nexmark, "BLOCK", 1 << 12)
    monkeypatch.setattr(nexmark, "LETTER_BLOCK", 1 << 16)
    many = nexmark.generate(50_000, SEED)
    monkeypatch.setattr(nexmark.os, "cpu_count", lambda: 1)
    one = nexmark.generate(50_000, SEED)
    for c in nexmark.COLUMNS:
        a, b = many.columns[c], one.columns[c]
        assert np.array_equal(a, b) if c in nexmark.NUMBERS else a.equals(b), c
    assert not np.array_equal(many.columns["price"], data.columns["price"])  # other blocks


def test_bid_report_reference_against_python_loops(tmp_path):
    ctx = _context(tmp_path)
    exp = bid_report.expected(ctx.data, ctx.cell.traffic)
    cols = {c: ctx.data.columns[c].tolist() for c in nexmark.NUMBERS}
    bands = {"price < 10000": lambda p: p < 10_000,
             "price >= 10000 AND price < 1000000": lambda p: 10_000 <= p < 1_000_000,
             "price >= 1000000": lambda p: p >= 1_000_000}
    assert exp.exact["Size(*)"] == ROWS
    for where, keep in bands.items():
        rows = [r for r in range(ROWS) if keep(cols["price"][r])]
        assert exp.exact[f"Size(*) where {where}"] == len(rows)
        for column in ("bidder", "auction"):
            assert exp.distinct[f"ApproxCountDistinct({column}) where {where}"] == len(
                {cols[column][r] for r in rows})
    assert exp.distinct["ApproxCountDistinct(bidder)"] == len(set(cols["bidder"]))
    assert exp.exact["Minimum(date_time)"] == min(cols["date_time"])
    assert exp.exact["Maximum(price)"] == max(cols["price"])
    assert exp.exact["Completeness(auction)"] == 1.0
    assert math.isclose(exp.moments["Mean(price)"], sum(cols["price"]) / ROWS, rel_tol=1e-15)
    index, probabilities = exp.quantiles["ApproxQuantiles(price)"]
    assert probabilities == [0.5, 0.9, 0.99]
    assert index.quantile(0.5) == sorted(cols["price"])[ROWS // 2 - 1]
    assert len(exp.exact) + len(exp.moments) + len(exp.distinct) + len(exp.quantiles) == 22


@pytest.mark.parametrize("shards", ["default", "small"])
def test_cell_is_correct_over_a_four_shard_cpu_mesh(shards, tmp_path, monkeypatch):
    if shards == "small":
        _small_shards(monkeypatch)
    lines = []
    result = _tiny_run(tmp_path, lines=lines)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == {"missing", "exact_mismatch", "moment_rel_err",
                                     "distinct_rel_err", "quantile_rank_err", "failed_requests"}
    assert set(result["metrics"]) == {"setup_s", "rows_per_s", "peak_rss_mb"}
    assert '"engine": "mesh of 4"' in next(line for line in lines if '"setting"' in line)


def test_float32_control_is_caught(tmp_path):
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        numbers = bid_report.control(_context(tmp_path, seed))
        assert any(value > limit for _, value, limit in numbers), numbers


def test_fold_that_drops_the_last_shard_is_not_correct(tmp_path, monkeypatch):
    from deequ_tpu_torch.ops.fused import PipelinedAggFold

    original = PipelinedAggFold._merge

    def dropped(self, rows, meta):
        self.n_dev -= 1
        try:
            original(self, rows[:-1], meta)
        finally:
            self.n_dev += 1

    monkeypatch.setattr(PipelinedAggFold, "_merge", dropped)
    _small_shards(monkeypatch)
    result = _tiny_run(tmp_path)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["exact_mismatch"]["value"] > 0


def test_traced_run_has_a_ship_and_a_launch_span_per_shard_and_batch(traced):
    from benchmark.waits import walk

    record, _ = traced
    for it in record.done:
        spans = list(walk(it.roots))
        assert sum(s.name == "dispatch" for s in spans) == BATCHES
        for name in ("mesh_ship", "mesh_launch"):
            cards = sorted(s.attrs["card"] for s in spans if s.name == name)
            assert cards == sorted(list(range(SHARDS)) * BATCHES), name
        ships = [s for s in spans if s.name == "mesh_ship"]
        assert sum(s.attrs["rows"] for s in ships) == ROWS
        assert all(s.attrs["bytes"] > 0 and s.attrs["device"] == "cpu" for s in ships)
        gathers = [s for s in spans if s.name == "mesh_gather"]
        assert len(gathers) == BATCHES and all(s.attrs["shards"] == SHARDS for s in gathers)
        assert not any("device_ms" in s.attrs for s in spans)  # no card: no events


def test_counters_count_four_shard_launches_a_batch(traced):
    _, stats = traced
    assert stats
    for s in stats:
        assert s.mesh_passes == 1 and s.mesh_shards == SHARDS
        assert s.device_launches == SHARDS * BATCHES
        assert s.mesh_peer_bytes == 0  # one CPU device: no partial crosses devices


def test_mesh_metric_readers_read_the_traced_record(traced):
    from benchmark.waits import walk

    record, _ = traced
    read_here = {m["name"] for m in core.resolve(CELL).per_layer
                 if m["source"] != "device_trace"}
    assert read_here == {"mesh.ship_s.scan", "mesh.launch_s.scan", "mesh.gather_s.scan",
                         "fused.host_s.scan", "pipeline.build_s.scan", "lint.plan_s.scan",
                         "fused.merge_s.scan"}
    for name in sorted(read_here):
        value = core.load_module("metrics", name).read(record)
        assert value is not None and value > 0, name
    busy = core.load_module("metrics", "mesh.card_busy_s.scan")
    assert busy.read(record) is None  # no card, no device_ms
    for it in record.done:  # as the card would time each shard: 1 ms on card 0, 2 ms elsewhere
        for span in walk(it.roots):
            if span.name == "mesh_launch":
                span.attrs["device"] = f"cuda:{span.attrs['card']}"
                span.attrs["device_ms"] = 1.0 if span.attrs["card"] == 0 else 2.0
    try:
        assert busy.read(record) == pytest.approx(2.0 * BATCHES / 1000.0)
    finally:
        for it in record.done:
            for span in walk(it.roots):
                if span.name == "mesh_launch":
                    del span.attrs["device_ms"]
                    span.attrs["device"] = "cpu"


def test_mesh_metric_readers_find_nothing_in_a_single_device_run(tmp_path):
    """A run with no mesh pass (the parent program, or one card) gives
    None from every reader, never 0."""
    from deequ_tpu_torch import AnalysisRunner, Table, observe
    from deequ_tpu_torch.analyzers import Mean, Size

    table = Table.from_numpy({"x": np.arange(1000, dtype=np.int64)})
    with observe.tracing() as tracer:
        start = time.perf_counter()
        AnalysisRunner.on_data(table, device="cpu").add_analyzers([Size(), Mean("x")]).run()
        end = time.perf_counter()
    it = core.Iteration(start, end, 1000, end - start, True, roots=tracer.roots)
    record = core.RunRecord(0.0, [it], (start, end), 0, True)
    for name in ("mesh.ship_s.scan", "mesh.launch_s.scan", "mesh.gather_s.scan",
                 "mesh.card_busy_s.scan"):
        assert core.load_module("metrics", name).read(record) is None, name


def test_fold_reads_each_shard_timing_after_its_partials_land():
    """Each timed mesh shard's `device_ms` lands on its own span once the
    fold has waited for the batch: its end event synchronized first, then
    read, and the next batch's submit is what folds (and reads) it."""
    import torch

    from deequ_tpu_torch import observe
    from deequ_tpu_torch.ops.fused import PipelinedAggFold

    calls = []

    class Event:
        def __init__(self, name, ms=0.0):
            self.name, self.ms = name, ms

        def synchronize(self):
            calls.append(("sync", self.name))

        def elapsed_time(self, end):
            calls.append(("read", end.name))
            return end.ms - self.ms

    fold = PipelinedAggFold([], torch.device("cpu"), n_dev=2)
    with observe.tracing():
        spans = [observe.span("mesh_launch", card=d) for d in range(2)]
        timed = [(sp, (Event(f"start{d}"), Event(f"end{d}", 1.5 + d)))
                 for d, sp in enumerate(spans)]
        fold.submit(torch.zeros(0, dtype=torch.float64), [], timed)
        assert calls == [] and all("device_ms" not in sp.attrs for sp in spans)
        fold.finish()
    assert calls == [("sync", "end0"), ("read", "end0"), ("sync", "end1"), ("read", "end1")]
    assert [sp.attrs["device_ms"] for sp in spans] == [1.5, 2.5]
