"""K6 (`cuda_kernels.hist16_select`) on the card against its plain
version, bit for bit: the sample's float64 bits, the live count and the
level, on TPC-H lineitem's value domains at one row group of 1,048,576
rows, on the worst case (every value in one float32 bin), on signed zeros,
subnormals and infinities, at the level's edges, with NULLs and a where
mask, with a sample as large as the batch, and on views whose bases are
not aligned. Then the fused pass on the card against the same pass on the
CPU: equal sketches, one K6 launch per K4 launch. A CUDA kernel has no CPU
mode, so these tests skip without a card. The directory's conftest
imports JAX, which the card's machine lacks; this file imports none:

    python -m pytest --noconftest -m card tests/test_torch_quantile_select_card.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deequ_tpu_torch.ops import cuda_kernels as ck

pytestmark = pytest.mark.card

ROW_GROUP = 1 << 20  # the benchmark's row group: one batch of its stream


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


def lineitem_like(name: str, rows: int, rng) -> np.ndarray:
    """A numeric lineitem column with Clause 4.2.3's value domain."""
    if name == "l_quantity":
        return rng.integers(1, 51, rows).astype(np.float64)
    if name == "l_discount":
        return rng.integers(0, 11, rows) / 100.0
    if name == "l_tax":
        return rng.integers(0, 9, rows) / 100.0
    if name == "l_partkey":
        return rng.integers(1, 200_001, rows).astype(np.float64)
    if name == "l_linenumber":
        return np.minimum(rng.geometric(0.25, rows), 7).astype(np.float64)
    if name == "l_extendedprice":
        cents = rng.integers(1, 51, rows) * rng.integers(90_000, 210_000, rows)
        return cents / 100.0
    if name == "l_orderkey":  # sorted, sparse
        return np.sort(rng.integers(1, 6_000_000, rows)).astype(np.float64)
    raise ValueError(name)


def worst_case(rows: int, rng) -> np.ndarray:
    """Every value in [1, 1 + 2^-7): one float32 bin holds the batch."""
    return 1.0 + rng.random(rows) * (2.0 ** -7) * (1 - 2 ** -20)


def same_on_card(x: np.ndarray, live: np.ndarray, cap: int, device, x_offset=0, live_offset=0):
    """K6 against its plain version, both on the card, on views offset by
    `x_offset` and `live_offset` elements from their allocations."""
    xs = torch.from_numpy(np.concatenate([np.zeros(x_offset), x])).to(device)[x_offset:]
    ls = torch.from_numpy(np.concatenate([np.zeros(live_offset, bool), live])).to(device)
    ls = ls[live_offset:]
    counts = ck.hist16(xs, ls)
    before = ck.hist16_select.launches
    sample, n, level = ck.hist16_select(xs, ls, counts, cap)
    torch.cuda.synchronize(device)
    assert ck.hist16_select.launches == before + 1
    want_sample, want_n, want_level = ck.hist16_select_plain(xs, ls, counts, cap)
    assert (float(n), float(level)) == (float(want_n), float(want_level))
    assert torch.equal(sample.view(torch.int64), want_sample.view(torch.int64))
    return sample, int(n), int(level)


COLUMNS = ("l_quantity", "l_discount", "l_tax", "l_partkey", "l_linenumber",
           "l_extendedprice", "l_orderkey")


@pytest.mark.parametrize("column", COLUMNS)
def test_lineitem_row_group_matches_plain(column, cuda):
    rng = np.random.default_rng(COLUMNS.index(column))
    x = lineitem_like(column, ROW_GROUP, rng)
    same_on_card(x, np.ones(ROW_GROUP, bool), 460, cuda)


@pytest.mark.parametrize("cap", [460, 4600])
def test_one_float32_bin_matches_plain(cap, cuda):
    rng = np.random.default_rng(cap)
    same_on_card(worst_case(ROW_GROUP, rng), np.ones(ROW_GROUP, bool), cap, cuda)


SPECIALS = np.array([0.0, -0.0, 0.0, -0.0, 1e-310, -1e-310, 5e-324, -5e-324, 1e-300, -1e-300,
                     1e-45, -1e-45, np.inf, -np.inf, 1e300, -1e300, 1e39, -1e39, 2.0, -3.0])


@pytest.mark.parametrize("rows", [100_000, ROW_GROUP])
def test_special_values_match_plain(rows, cuda):
    rng = np.random.default_rng(rows)
    x = rng.choice(SPECIALS, rows)
    sample, n, level = same_on_card(x, np.ones(rows, bool), 460, cuda)
    assert n == rows and level > 0


@pytest.mark.parametrize("n_live", [0, 1, 2, 3, 459, 460, 461, 1840, 1841, 7360, 7361])
def test_level_edges_match_plain(n_live, cuda):
    rng = np.random.default_rng(n_live)
    x = rng.normal(0.0, 3.0, n_live + 1000)
    x[::5] = -0.0
    live = np.zeros(len(x), bool)
    live[rng.permutation(len(x))[:n_live]] = True
    _, n, _ = same_on_card(x, live, 460, cuda)
    assert n == n_live


@pytest.mark.parametrize("cap", [16, 131072])
def test_nulls_where_and_sample_sizes_match_plain(cap, cuda):
    """A sample smaller than a warp and one larger than the live rows
    (relative error 0: every live row is a rank)."""
    rng = np.random.default_rng(cap)
    x = rng.normal(3.0, 2.0, 100_003)
    live = (rng.random(len(x)) < 0.8) & (rng.random(len(x)) < 0.6)
    same_on_card(x, live, cap, cuda)


@pytest.mark.parametrize("x_offset, live_offset", [(1, 0), (1, 3), (0, 1)])
def test_unaligned_views_match_plain(x_offset, live_offset, cuda):
    rng = np.random.default_rng(x_offset * 10 + live_offset)
    x = lineitem_like("l_extendedprice", ROW_GROUP - 37, rng)
    live = rng.random(len(x)) < 0.9
    same_on_card(x, live, 460, cuda, x_offset, live_offset)


def test_fused_pass_on_card_equals_cpu(cuda, monkeypatch):
    """The fused pass on the card selects every sample with K6, and its
    sketches equal the CPU pass's (the plain versions)."""
    from deequ_tpu_torch.analyzers.sketch import ApproxQuantile, ApproxQuantiles
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.ops.fused import FusedScanPass

    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    rng = np.random.default_rng(17)
    rows = 3 * ROW_GROUP + 12345
    x = rng.normal(3.0, 2.0, rows)
    x[::13] = np.nan
    table = Table.from_numpy({
        "x": x,
        "q": lineitem_like("l_quantity", rows, rng),
        "g": rng.integers(0, 4, rows),
    })
    members = [ApproxQuantiles("x", (0.1, 0.5, 0.9)), ApproxQuantile("q", 0.5),
               ApproxQuantile("x", 0.25, where="g >= 2")]
    states = {}
    for device in ("cuda", "cpu"):
        ck.reset_launch_counts()
        with runtime.monitored() as stats:
            results = FusedScanPass(members, batch_size=ROW_GROUP, device=device).run(table)
        states[device] = [r.state_or_raise() for r in results]
        launches = ck.launch_counts()
        if device == "cuda":
            assert launches["hist16_select"] == launches["hist16"] == 3 * 4
            assert (stats.device_quantile_samples, stats.device_quantile_samples_total) == (12, 12)
    assert states["cuda"] == states["cpu"]
