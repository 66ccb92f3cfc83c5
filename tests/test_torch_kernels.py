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
