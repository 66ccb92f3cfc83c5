"""K6 (`cuda_kernels.hist16_select`): a quantile member's decimated
sample selected in the device program, against the route it replaced.

Before K6, the device program shipped K4's 65536 counts and the fold
selected the sample on the host (`_parent_route` below: the host bins the
batch again, gathers the rows of the bins that own a rank, the two zero
bins together, stable-sorts them and reads the ranks off). Now
`device_batch` ships the sample itself, with its live count and level,
and `host_finish_batch` only cuts it to the kept ranks. The sample seeds
the batch's KLL compactor (`_batch_seed` hashes its bytes), so both
routes must give it bit for bit, -0.0 and +0.0 in row order, and equal
KLL states. On the CPU the device program runs the kernels' plain
versions; tests/test_torch_quantile_select_card.py holds the kernel to
the plain version on the card."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from deequ_tpu_torch import observe
from deequ_tpu_torch.analyzers.base import where_key
from deequ_tpu_torch.analyzers.sketch import ApproxQuantile as PQ
from deequ_tpu_torch.analyzers.sketch import ApproxQuantiles as PQS
from deequ_tpu_torch.data.table import Table as PTable
from deequ_tpu_torch.ops import cuda_kernels as ck
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.ops.fused import FusedScanPass as PPass
from deequ_tpu_torch.ops.fused import _pad_size, pack_outputs, unpack_outputs

QS = (0.1, 0.25, 0.5, 0.9)
WHERE = "w"  # the where clause's key stands for any filter's mask


def _parent_route(x: np.ndarray, live: np.ndarray, cap: int):
    """The parent's selection, verbatim: K4's counts, then the host's
    re-binning, wanted-bin gather, stable sort and rank read."""
    counts = ck.hist16_plain(torch.from_numpy(x), torch.from_numpy(live)).numpy()
    counts = counts.astype(np.float64)
    counts[65409:] = 0.0
    counts = counts.astype(np.int64)
    n = int(counts.sum())
    if n <= 0:
        return {"sample": np.zeros(0, dtype=np.float64), "n": 0, "level": 0}
    level = max(0, int(np.ceil(np.log2(max(n, 1) / cap))))
    stride = 1 << level
    offset = stride // 2
    kept = max(0, -(-(n - offset) // stride))
    ranks = offset + stride * np.arange(kept, dtype=np.int64)
    cum = np.cumsum(counts)
    bins_of_rank = np.searchsorted(cum, ranks, side="right")
    wanted = np.zeros(ck.HIST_BINS, dtype=bool)
    wanted[bins_of_rank] = True
    wanted[[0x7FFF, 0x8000]] = wanted[[0x7FFF, 0x8000]].any()
    bins = ck.f32_sortable_bin16_plain(
        torch.from_numpy(x).to(torch.float32), torch.from_numpy(live)
    ).numpy()
    gathered = np.sort(x[wanted[bins]], kind="stable")
    unwanted_cum = np.cumsum(counts * ~wanted)
    below = np.where(bins_of_rank > 0, unwanted_cum[bins_of_rank - 1], 0)
    return {"sample": gathered[ranks - below], "n": n, "level": level}


def _rng(seed):
    return np.random.default_rng(seed)


def _zeros_interleaved():
    rng = _rng(1)
    x = rng.choice(np.array([-0.0, 0.0, -0.0, 0.0, -2.0, 3.0]), 6000)
    return x, np.ones(len(x), bool), None, 0.01


def _subnormals_beside_zero_bins():
    rng = _rng(2)
    # float64 subnormals and tiny values round to float32 zeros or
    # subnormals: they share the zero bins with -0.0 and +0.0
    pool = np.array([1e-310, -1e-310, 5e-324, -5e-324, 1e-300, -1e-300, 1e-45, -1e-45,
                     1.4e-45, -1.4e-45, 1e-40, -1e-40, 0.0, -0.0, 1e-38, -1e-38, 2.0])
    x = rng.choice(pool, 7000)
    return x, np.ones(len(x), bool), None, 0.01


def _infinities():
    rng = _rng(3)
    x = rng.choice(np.array([np.inf, -np.inf, 1e300, -1e300, 1e39, -1e39, 3.4e38, 7.0]), 5000)
    x[::7] = rng.normal(0.0, 1e6, len(x[::7]))
    return x, np.ones(len(x), bool), None, 0.1


def _nulls_and_where():
    rng = _rng(4)
    x = rng.normal(3.0, 2.0, 9000)
    valid = rng.random(len(x)) < 0.8
    x[~valid] = 0.0  # a null slot holds 0.0, as numeric_values gives it
    return x, valid, rng.random(len(x)) < 0.6, 0.01


def _no_live_row():
    x = _rng(5).normal(0.0, 1.0, 3000)
    return x, np.zeros(len(x), bool), None, 0.01


def _empty_batch():
    return np.zeros(0), np.zeros(0, bool), None, 0.01


def _level_zero():
    x = _rng(6).normal(0.0, 1.0, 400)  # n <= cap = 460
    x[::9] = -0.0
    return x, np.ones(len(x), bool), None, 0.01


def _exactly(n_live):
    def case():
        rng = _rng(n_live)
        x = rng.normal(0.0, 5.0, n_live + 777)
        live = np.zeros(len(x), bool)
        live[rng.permutation(len(x))[:n_live]] = True
        return x, live, None, 0.01

    return case


def _one_float32_bin():
    # every value in [1, 1 + 2^-7): one float32 bin holds the whole batch
    x = 1.0 + _rng(7).random(20000) * (2.0 ** -7) * (1 - 2 ** -20)
    return x, np.ones(len(x), bool), None, 0.01


def _int64_column():
    rng = _rng(8)
    values = rng.integers(-(1 << 62), 1 << 62, 8000)
    values[::5] = rng.integers(-50, 50, len(values[::5]))
    # LONG's numeric_values: float64 of the ints (rounded past 2^53)
    return values.astype(np.float64), np.ones(len(values), bool), None, 0.01


CASES = {
    "signed-zeros-interleaved": _zeros_interleaved,
    "subnormals-beside-zero-bins": _subnormals_beside_zero_bins,
    "infinities": _infinities,
    "nulls-and-where": _nulls_and_where,
    "n=0": _no_live_row,
    "n=0-empty-batch": _empty_batch,
    "level-0": _level_zero,
    "n=cap*2^2": _exactly(460 * 4),
    "n=cap*2^2+1": _exactly(460 * 4 + 1),
    "n=cap*2^4": _exactly(460 * 16),
    "n=cap*2^4+1": _exactly(460 * 16 + 1),
    "one-float32-bin": _one_float32_bin,
    "int64": _int64_column,
    "mesh-uneven-shards": _nulls_and_where,
}


def _shards(case: str, n: int):
    """(lo, hi, padded rows) of each shard: the whole batch, or the mesh's
    three shards of `_pad_size` rows, the last one short."""
    if case != "mesh-uneven-shards":
        return [(0, n, n)]
    per_dev = _pad_size(-(-n // 3), 1 << 20)
    return [(min(d * per_dev, n), min((d + 1) * per_dev, n), per_dev) for d in range(3)]


def _shard_inputs(x, valid, where, lo, hi, padded):
    """A shard's device inputs, its padded rows masked out (their values
    are junk: the kernels must not read them)."""
    def pad(a, fill):
        out = np.full(padded, fill, dtype=a.dtype)
        out[: hi - lo] = a[lo:hi]
        return torch.from_numpy(out)

    mask = np.ones(len(x), bool) if where is None else where
    return {
        "num:x": pad(x, 123.0),
        "valid:x": pad(valid, False),
        _where_key(where): pad(mask, False),
    }


def _where_key(where):
    return where_key(None if where is None else WHERE)


@pytest.mark.parametrize("case", list(CASES))
def test_device_sample_is_the_parent_routes_bit_for_bit(case):
    x, valid, where, relative_error = CASES[case]()
    analyzer = (
        PQS("x", QS, relative_error) if where is None else PQ("x", 0.5, relative_error, where=WHERE)
    )
    cap = analyzer._sample_size()
    ours = theirs = None
    for lo, hi, padded in _shards(case, len(x)):
        inputs = _shard_inputs(x, valid, where, lo, hi, padded)
        out = analyzer.device_batch(inputs)
        assert out["sample"].shape == (cap,)  # a fixed buffer on the wire
        # through the packed wire, as the fold reads it
        flat, meta = pack_outputs([out], torch.device("cpu"))
        got = analyzer.host_finish_batch(unpack_outputs(flat.numpy(), meta, 1)[0])
        live = inputs["valid:x"].numpy() & inputs[_where_key(where)].numpy()
        want = _parent_route(inputs["num:x"].numpy(), live, cap)
        assert (got["n"], got["level"]) == (want["n"], want["level"])
        assert got["sample"].tobytes() == want["sample"].tobytes()
        assert not out["sample"][len(want["sample"]):].any()  # zero past the kept ranks
        ours = analyzer.host_consume(ours, got)
        theirs = analyzer.host_consume(theirs, want)
    assert ours == theirs
    if theirs is not None:
        for a, b in zip(ours.digest.to_arrays()[2], theirs.digest.to_arrays()[2]):
            assert a.tobytes() == b.tobytes()
    assert ck.launch_counts()["hist16_select"] == 0  # the CPU takes the plain version


def test_signed_zeros_keep_row_order_in_the_sample():
    """Every rank among the zeros: the sample's signs follow the rows."""
    x = np.array([0.0, -0.0, -0.0, 0.0, 0.0, -0.0, -0.0, -0.0, 0.0, -0.0])
    live = np.ones(len(x), bool)
    counts = ck.hist16_plain(torch.from_numpy(x), torch.from_numpy(live))
    sample, n, level = ck.hist16_select(torch.from_numpy(x), torch.from_numpy(live), counts, 16)
    assert (int(n), int(level)) == (10, 0)
    assert np.signbit(sample.numpy()[:10]).tolist() == np.signbit(x).tolist()


@pytest.mark.parametrize("cap", [16, 460, 4600, 2 * 65536])
def test_decimation_level_equals_the_hosts_log2_at_the_edges(cap):
    """The kernel's level (the smallest L with n <= cap * 2^L, in
    integers) against the parent host's ceil(log2(n / cap)), at every
    edge n = cap * 2^L and cap * 2^L + 1 below 2^32 rows, with the ranks
    kept."""
    top = 32 - int(math.log2(cap))
    for level in range(top + 1):
        for n in {cap << level, (cap << level) - 1, (cap << level) + 1} - {0}:
            if n > ck.HIST_MAX_ROWS:
                continue
            want = max(0, int(np.ceil(np.log2(max(n, 1) / cap))))
            got, kept = ck.decimation(n, cap)
            assert got == want, (n, cap)
            stride = 1 << want
            assert kept == max(0, -(-(n - stride // 2) // stride)) <= cap
    assert ck.decimation(0, cap) == (0, 0)


def test_wrapper_rejects_wrong_inputs():
    x = torch.zeros(8, dtype=torch.float64)
    live = torch.ones(8, dtype=torch.bool)
    counts = ck.hist16(x, live)
    with pytest.raises(ValueError):
        ck.hist16_select(x, live, counts[:100], 16)
    with pytest.raises(TypeError):
        ck.hist16_select(x, live, counts.long(), 16)
    with pytest.raises(ValueError):
        ck.hist16_select(x, live, counts, 0)
    with pytest.raises(TypeError):
        ck.hist16_select(x.float(), live, counts, 16)


# -- the counter -----------------------------------------------------------


def _table(rows=6000, seed=11):
    rng = np.random.default_rng(seed)
    return PTable.from_numpy({"x": rng.normal(3.0, 2.0, rows), "g": rng.integers(0, 4, rows)})


def _counted_run(analyzers, placement, monkeypatch, batch_size=1500):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", placement)
    with runtime.monitored() as stats, observe.tracing() as tracer:
        PPass(analyzers, batch_size=batch_size, device="cpu").run(_table())
    return stats, tracer


def test_device_quantile_samples_count_one_per_member_and_batch(monkeypatch):
    """Three quantile members over four batches: twelve samples, all from
    the device program; under "host-all" the same twelve, none from it;
    with no quantile member the counter stays 0 and out of the
    headline."""
    members = [PQ("x", 0.5), PQS("x", QS), PQ("x", 0.9, where="g >= 2")]
    stats, tracer = _counted_run(members, "device", monkeypatch)
    assert (stats.device_quantile_samples, stats.device_quantile_samples_total) == (12, 12)
    assert tracer.counters["device_quantile_samples"] == 12
    assert tracer.counters["device_quantile_samples_total"] == 12
    report = observe.render_report(tracer, counters=tracer.counters)
    assert "device_quantile_samples 12/12" in report

    stats, tracer = _counted_run(members, "host-all", monkeypatch)
    assert (stats.device_quantile_samples, stats.device_quantile_samples_total) == (0, 12)
    assert "device_quantile_samples 0/12" in observe.render_report(
        tracer, counters=tracer.counters
    )

    from deequ_tpu_torch.analyzers import Mean

    stats, tracer = _counted_run([Mean("x")], "device", monkeypatch)
    assert (stats.device_quantile_samples, stats.device_quantile_samples_total) == (0, 0)
    assert "device_quantile_samples" not in tracer.counters
    assert "device_quantile_samples" not in observe.render_report(
        tracer, counters=tracer.counters
    )


def test_device_and_host_folds_give_the_same_sketch(monkeypatch):
    """The device program's sample and the host fold's ("host-all", the C
    or numpy decimation) build the same KLL state."""
    members = [PQS("x", QS), PQ("x", 0.9, where="g >= 2")]
    states = {}
    for placement in ("device", "host-all"):
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", placement)
        results = PPass(members, batch_size=1700, device="cpu").run(_table())
        states[placement] = [r.state_or_raise() for r in results]
    assert states["device"] == states["host-all"]
