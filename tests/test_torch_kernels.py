"""The port's plain kernel versions against the JAX package's kernels.

Block-aligned lengths run the Pallas kernels in interpret mode, as
tests/test_pallas_kernels.py does, on float32 inputs; ragged lengths
(which the Pallas kernels do not take) run the JAX package's XLA fold in
float64. Count, min, max and registers must match exactly. Sums match
within 1e-5 against the Pallas kernels, which sum in float32 in a
blocked order, and within 1e-12 against the float64 XLA fold. On the
CPU the wrappers take the plain versions and launch nothing."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deequ_tpu.ops import pallas_kernels
from deequ_tpu.ops.sketches import hll as jax_hll
from deequ_tpu_torch.ops import cuda_kernels as ck

ALIGNED = [1024, 4096, 16384]
RAGGED = [0, 1, 1024 + 37]


def _data(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * 100.0).astype(dtype)
    m = rng.random(n) < 0.8
    return x, m


def _codes(n, seed):
    rng = np.random.default_rng(seed)
    return jax_hll.pack_codes(rng.integers(0, 50_000, n), np.ones(n, dtype=bool))


@pytest.fixture(autouse=True)
def _zero_counts():
    ck.reset_launch_counts()
    yield
    # every call in this file is on the CPU: no kernel may have launched
    assert ck.launch_counts() == {
        "masked_moments": 0, "masked_centered_sumsq": 0, "hll_register_max": 0,
        "hist16": 0,
    }


@pytest.mark.parametrize("n", ALIGNED)
def test_masked_moments_vs_pallas(n):
    x, m = _data(n, seed=n)
    ref = [
        float(np.asarray(v))
        for v in pallas_kernels.masked_moments(
            jnp.asarray(x), jnp.asarray(m.astype(np.float32)), interpret=True
        )
    ]
    got = ck.masked_moments(torch.from_numpy(x), torch.from_numpy(m)).tolist()
    assert got[0] == ref[0]
    assert got[2] == ref[2] and got[3] == ref[3]
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5)


@pytest.mark.parametrize("n", ALIGNED)
def test_centered_sumsq_vs_pallas(n):
    x, m = _data(n, seed=n + 1)
    avg = np.float32(x[m].mean())
    ref = float(
        np.asarray(
            pallas_kernels.masked_centered_sumsq(
                jnp.asarray(x), jnp.asarray(m.astype(np.float32)), avg, interpret=True
            )
        )
    )
    got = ck.masked_centered_sumsq(
        torch.from_numpy(x), torch.from_numpy(m), torch.tensor(float(avg), dtype=torch.float64)
    ).item()
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("n", ALIGNED)
def test_hll_register_max_vs_pallas(n):
    codes = _codes(n, seed=n)
    _x, m = _data(n, seed=n + 2)
    ref = np.asarray(
        pallas_kernels.hll_register_max(jnp.asarray(np.where(m, codes, 0)), interpret=True)
    )
    got = ck.hll_register_max(torch.from_numpy(codes), torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", RAGGED)
def test_masked_moments_vs_xla_fold(n):
    x, m = _data(n, seed=n + 3, dtype=np.float64)
    xj, mj = jnp.asarray(x), jnp.asarray(m.astype(np.float64))
    ref = [
        float(jnp.sum(mj)),
        float(jnp.sum(xj * mj)),
        float(jnp.min(jnp.where(mj > 0, xj, jnp.inf), initial=jnp.inf)),
        float(jnp.max(jnp.where(mj > 0, xj, -jnp.inf), initial=-jnp.inf)),
    ]
    got = ck.masked_moments(torch.from_numpy(x), torch.from_numpy(m)).tolist()
    assert got[0] == ref[0]
    assert got[2] == ref[2] and got[3] == ref[3]
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-12)


@pytest.mark.parametrize("n", RAGGED)
def test_centered_sumsq_vs_xla_fold(n):
    x, m = _data(n, seed=n + 4, dtype=np.float64)
    avg = float(x[m].mean()) if m.any() else 0.0
    ref = float(jnp.sum(((jnp.asarray(x) - avg) * jnp.asarray(m.astype(np.float64))) ** 2))
    got = ck.masked_centered_sumsq(
        torch.from_numpy(x), torch.from_numpy(m), torch.tensor(avg, dtype=torch.float64)
    ).item()
    np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize("n", RAGGED)
def test_hll_register_max_vs_xla_scatter(n):
    codes = _codes(n, seed=n + 5)
    _x, m = _data(n, seed=n + 6)
    rank = jnp.where(jnp.asarray(m), jnp.asarray(codes) & 0x3F, 0)
    ref = np.asarray(
        jnp.zeros(jax_hll.M, dtype=rank.dtype).at[jnp.asarray(codes) >> 6].max(rank)
    )
    got = ck.hll_register_max(torch.from_numpy(codes), torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, ref)


def _rising_one_register(n):
    """Every code in register 300, its rank rising 1..63 in row order:
    each row raises the register, the worst case for the card's
    test-before-atomic."""
    return ((300 << 6) | (1 + (np.arange(n) * 63) // n)).astype(np.int32)


def _all_registers(n, seed):
    """Codes that cover all 512 registers, with ranks 1..63."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n) % jax_hll.M
    return ((idx << 6) | rng.integers(1, 64, n)).astype(np.int32)


CODE_CASES = {"rising-one-register": lambda n: _rising_one_register(n),
              "all-registers": lambda n: _all_registers(n, seed=n)}


@pytest.mark.parametrize("n", [4096, 16384])
@pytest.mark.parametrize("case", sorted(CODE_CASES))
def test_hll_register_max_edge_codes_vs_pallas(case, n):
    codes = CODE_CASES[case](n)
    _x, m = _data(n, seed=n + 7)
    ref = np.asarray(
        pallas_kernels.hll_register_max(jnp.asarray(np.where(m, codes, 0)), interpret=True)
    )
    got = ck.hll_register_max(torch.from_numpy(codes), torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, ref)
    if case == "all-registers":
        assert (got > 0).all()
    else:
        assert got[300] == 63 and np.count_nonzero(got) == 1


@pytest.mark.parametrize("n", RAGGED[1:] + [4096 + 3])
@pytest.mark.parametrize("case", sorted(CODE_CASES))
def test_hll_register_max_edge_codes_vs_xla_scatter(case, n):
    codes = CODE_CASES[case](n)
    _x, m = _data(n, seed=n + 8)
    rank = jnp.where(jnp.asarray(m), jnp.asarray(codes) & 0x3F, 0)
    ref = np.asarray(
        jnp.zeros(jax_hll.M, dtype=rank.dtype).at[jnp.asarray(codes) >> 6].max(rank)
    )
    got = ck.hll_register_max(torch.from_numpy(codes), torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("offset", [0, 4, 8, 12])
def test_hll_plan_aligns_codes(sms, offset):
    ptr = (1 << 20) + offset
    for n in [0, 1, 2, 3, 4, 7, 4096, (1 << 22) - 37, 1 << 31]:
        head, grid = ck.hll_plan(n, sms, ptr)
        assert head == min(n, (16 - offset) % 16 // 4)
        assert (ptr + 4 * head) % 16 == 0 or head == n
        assert 1 <= grid <= 2 * sms


def test_code_zero_and_masked_rows_are_noops():
    codes = np.full(64, (511 << 6) | 56, dtype=np.int32)
    codes[::2] = 0
    m = np.ones(64, dtype=bool)
    m[1] = False
    got = ck.hll_register_max(torch.from_numpy(codes), torch.from_numpy(m)).numpy()
    assert got[511] == 56 and got[:511].sum() == 0
    m[:] = False
    got = ck.hll_register_max(torch.from_numpy(codes), torch.from_numpy(m)).numpy()
    assert got.sum() == 0


@pytest.mark.parametrize(
    "call",
    [
        lambda: ck.masked_moments(torch.zeros(4, dtype=torch.float64), torch.ones(3, dtype=torch.bool)),
        lambda: ck.masked_moments(torch.zeros(4, dtype=torch.float64), torch.ones(4)),
        lambda: ck.masked_moments(torch.zeros((2, 2), dtype=torch.float64), torch.ones(4, dtype=torch.bool)),
        lambda: ck.masked_centered_sumsq(
            torch.zeros(4, dtype=torch.float64), torch.ones(4, dtype=torch.bool), 0.0
        ),
        lambda: ck.hll_register_max(torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.bool)),
    ],
    ids=["shape", "mask-dtype", "rank", "avg-float", "codes-dtype"],
)
def test_wrappers_reject_bad_inputs(call):
    with pytest.raises((TypeError, ValueError)):
        call()


# ---------------------------------------------------------------------------
# NaN in min and max: the card's kernel must propagate it as these do
# ---------------------------------------------------------------------------


def test_live_nan_makes_min_max_and_sum_nan_on_both_sides():
    x = np.arange(1024, dtype=np.float32)
    x[[5, 1021]] = np.nan
    m = np.ones(1024, dtype=bool)
    ref = [
        float(np.asarray(v))
        for v in pallas_kernels.masked_moments(
            jnp.asarray(x), jnp.asarray(m.astype(np.float32)), interpret=True
        )
    ]
    got = ck.masked_moments(torch.from_numpy(x), torch.from_numpy(m)).tolist()
    blocked = ck.masked_moments_blocked(torch.from_numpy(x), torch.from_numpy(m)).tolist()
    assert got[0] == ref[0] == blocked[0] == 1024
    assert np.isnan(got[1:]).all() and np.isnan(ref[1:]).all() and np.isnan(blocked[1:]).all()


def test_nan_on_a_masked_row_changes_nothing():
    """The port selects live rows, so a masked NaN is never added. The
    Pallas kernel's count, min and max agree; its sum multiplies x by the
    mask (NaN * 0 is NaN), so only the port's sum is held to the rows
    without the NaN."""
    x = np.arange(1024, dtype=np.float32)
    m = np.ones(1024, dtype=bool)
    m[5] = False
    clean = ck.masked_moments(torch.from_numpy(x), torch.from_numpy(m)).tolist()
    x[5] = np.nan
    got = ck.masked_moments(torch.from_numpy(x), torch.from_numpy(m)).tolist()
    blocked = ck.masked_moments_blocked(torch.from_numpy(x), torch.from_numpy(m)).tolist()
    ref = [
        float(np.asarray(v))
        for v in pallas_kernels.masked_moments(
            jnp.asarray(x), jnp.asarray(m.astype(np.float32)), interpret=True
        )
    ]
    assert got == clean == blocked == [1023.0, 523771.0, 0.0, 1023.0]
    assert [ref[0], ref[2], ref[3]] == [got[0], got[2], got[3]]
    avg = torch.tensor(511.0, dtype=torch.float64)
    assert not np.isnan(ck.masked_centered_sumsq(torch.from_numpy(x), torch.from_numpy(m), avg).item())


# ---------------------------------------------------------------------------
# The card's K1/K2 plan and summation order, emulated on the CPU
# ---------------------------------------------------------------------------

# n from 0 to 3 * 4096 + 7: every n up to 70 (head and tail alone, one
# block), then around each multiple of a block's first step (512 threads
# x 2 quads = 4096 rows) and every 97th n between
EMULATED_N = sorted(
    set(range(71))
    | {k * 4096 + d for k in range(1, 4) for d in range(-9, 8)}
    | set(range(71, 3 * 4096 + 8, 97))
)
HEADS = [(np.float64, h) for h in (0, 1)] + [(np.float32, h) for h in (0, 1, 2, 3)]


@pytest.mark.parametrize("dtype, head", HEADS, ids=[f"{d.__name__}-head{h}" for d, h in HEADS])
def test_blocked_emulation_covers_every_row_once(dtype, head):
    """On integer values every sum is exact in any order, so the blocked
    emulation equals the plain version exactly iff the kernel's plan
    (head, quads grid-stride, tail, trees, the fold of the partials) adds
    each live row once."""
    rng = np.random.default_rng(head)
    for n in EMULATED_N:
        x = torch.from_numpy(rng.integers(-1000, 1000, n).astype(dtype))
        m = torch.from_numpy(rng.random(n) < 0.8)
        avg = torch.tensor(7.0, dtype=torch.float64)
        h = min(head, n)
        assert torch.equal(ck.masked_moments_blocked(x, m, h), ck.masked_moments_plain(x, m)), n
        assert torch.equal(
            ck.masked_centered_sumsq_blocked(x, m, avg, h), ck.masked_centered_sumsq_plain(x, m, avg)
        ), n


@pytest.mark.parametrize("n", [0, 7, 4096 + 3, 3 * 4096 + 7, 1 << 17, (1 << 20) + 5])
def test_blocked_emulation_agrees_with_plain_on_normal_data(n):
    x, m = _data(n, seed=n + 9, dtype=np.float64)
    xt, mt = torch.from_numpy(x), torch.from_numpy(m)
    avg = torch.tensor(float(x[m].mean()) if m.any() else 0.0, dtype=torch.float64)
    got = ck.masked_moments_blocked(xt, mt)
    want = ck.masked_moments_plain(xt, mt)
    assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3]
    np.testing.assert_allclose(got[1].item(), want[1].item(), rtol=1e-12)
    np.testing.assert_allclose(
        ck.masked_centered_sumsq_blocked(xt, mt, avg).item(),
        ck.masked_centered_sumsq_plain(xt, mt, avg).item(),
        rtol=1e-12,
    )


def test_blocked_emulation_sums_in_the_kernels_order():
    """Not the plain order: with values that lose bits when added in
    another order, the emulation's sum differs from a flat left fold
    while it equals a hand-built fold of two threads' rows."""
    x = torch.tensor([1e16, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0], dtype=torch.float64)
    m = torch.ones(8, dtype=torch.bool)
    # one block; thread 0 adds quad 0 (1e16), thread 1 quad 1 (2); the
    # trees add 1e16 + 2, which float64 holds exactly
    assert ck.masked_moments_blocked(x, m, 0)[1].item() == 1e16 + 2
    flat = 0.0
    for v in x.tolist():
        flat += v  # 1e16 + 1 rounds back to 1e16, twice
    assert flat == 1e16


N_TO_2_31 = [0, 1, 2, 3, 4, 5, 7, 8, 4095, 4096, 4097, 4099, (1 << 22) - 37, 1 << 22,
             264 * 4096, 264 * 4096 + 4, 1 << 24, (1 << 31) - 1, 1 << 31]


@pytest.mark.parametrize("itemsize, offset", [(8, 0), (8, 8), (4, 0), (4, 4), (4, 8), (4, 12)])
def test_moments_plan_aligns_x_and_sizes_the_grid(itemsize, offset):
    ptr = (1 << 20) + offset  # a 16-byte boundary plus the view's offset
    for n in N_TO_2_31:
        head, grid = ck.moments_plan(n, ptr, itemsize)
        assert head == min(n, (16 - offset) % 16 // itemsize)
        assert (ptr + itemsize * head) % 16 == 0 or head == n
        # a function of n alone, one partial a thread for the fold
        assert 1 <= grid <= ck.MOMENTS_MAX_GRID <= ck.MOMENTS_THREADS
        quads = (n - head) // 4
        # two quads a thread before the grid grows, all of them when it is full
        assert grid == ck.MOMENTS_MAX_GRID or grid * ck.MOMENTS_THREADS * 2 >= quads
        assert grid == 1 or (grid - 1) * ck.MOMENTS_THREADS * 2 < quads


def test_moments_plan_rejects_unaligned_values():
    with pytest.raises(ValueError):
        ck.moments_plan(10, (1 << 20) + 4, 8)
    with pytest.raises(ValueError):
        ck.moments_plan(10, (1 << 20) + 2, 4)
    with pytest.raises(ValueError):
        ck.moments_plan(10, 1 << 20, 2)
