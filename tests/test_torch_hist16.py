"""K4: the port's plain hist16 against the JAX package's Pallas hist16.

Block-aligned lengths run the Pallas kernel in interpret mode over the
JAX package's own binning (`f32_sortable_bin16` of the float32 cast), as
tests/test_pallas_kernels.py does; ragged lengths, which the Pallas
kernel does not take, compare with numpy's bincount of the same bins.
Counts are integers: they must match exactly, bin 65535 (the excluded
rows) included. On the CPU the wrapper takes the plain version and
launches nothing."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deequ_tpu.ops import pallas_kernels
from deequ_tpu_torch.ops import cuda_kernels as ck

ALIGNED = [1024, 4096, 8192]
RAGGED = [0, 1, 1024 + 37]
SPECIALS = np.array(
    [0.0, -0.0, np.inf, -np.inf, 1e-310, -1e-310, 1e-45, -1e-45, 1e39, -1e39, 3.4e38, 5.0]
)


def _data(n, seed):
    """Normal values with the special values sprinkled in, and a mask."""
    rng = np.random.default_rng(seed)
    x = rng.normal(3.0, 2.0, n)
    spots = rng.integers(0, max(n, 1), min(n, 64))
    x[spots] = SPECIALS[np.arange(len(spots)) % len(SPECIALS)]
    live = rng.random(n) < 0.85
    return x, live


def _jax_bins(x, live):
    with np.errstate(over="ignore"):  # beyond the float32 range: +-inf
        x32 = x.astype(np.float32)
    return pallas_kernels.f32_sortable_bin16(jnp.asarray(x32), jnp.asarray(live))


@pytest.fixture(autouse=True)
def _zero_counts():
    ck.reset_launch_counts()
    yield
    assert ck.launch_counts()["hist16"] == 0


@pytest.mark.parametrize("n", ALIGNED)
def test_hist16_plain_equals_pallas_hist16(n):
    x, live = _data(n, seed=n)
    ref = np.asarray(pallas_kernels.hist16(_jax_bins(x, live), interpret=True)).reshape(65536)
    got = ck.hist16(torch.from_numpy(x), torch.from_numpy(live)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    assert got[ck.HIST_SENTINEL] == (~live).sum()


@pytest.mark.parametrize("n", RAGGED)
def test_hist16_plain_ragged_equals_bincount(n):
    x, live = _data(n, seed=n + 5)
    bins = np.asarray(_jax_bins(x, live)).astype(np.int64)
    ref = np.bincount(bins, minlength=65536)
    got = ck.hist16(torch.from_numpy(x), torch.from_numpy(live)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize(
    "n, every_live", [(66560, True), (73728, False)], ids=["all-live", "every-11th-excluded"]
)
def test_hist16_one_value_beyond_16_bit_counters(n, every_live):
    """More than 65535 live rows in one bin: the card counts a bin in
    16-bit shared counters and must flush them before they overflow; the
    plain version and the Pallas kernel count it exactly."""
    x = np.full(n, 2.5)
    live = np.ones(n, dtype=bool)
    if not every_live:
        live[::11] = False
    assert live.sum() > 65535
    ref = np.asarray(pallas_kernels.hist16(_jax_bins(x, live), interpret=True)).reshape(65536)
    got = ck.hist16(torch.from_numpy(x), torch.from_numpy(live)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    assert got[0xC020] == live.sum()  # float32(2.5)'s bin


N_BEYOND_2_31 = [0, 1, 2, 3, 4, 5, 1023, 65531, 65532, 65533, 1 << 22, (1 << 22) - 37,
                 (1 << 24) + 1, 132 * 65532, 132 * 65532 + 1, (1 << 31) - 1, 1 << 31,
                 (1 << 31) + 12345, ck.HIST_MAX_ROWS - 1, ck.HIST_MAX_ROWS]


@pytest.mark.parametrize("sms", [1, 78, 114, 132])
@pytest.mark.parametrize("x_offset", [0, 8])
def test_hist16_plan_windows_fit_16_bit_counters(sms, x_offset):
    """No flush window of the card's launch plan exceeds 65535 rows, for
    any n from 0 to beyond 2^31, and the blocks share the rows evenly."""
    ptr = 1 << 20  # a 16-byte boundary, like every CUDA allocation
    rng = np.random.default_rng(sms + x_offset)
    ns = N_BEYOND_2_31 + [int(v) for v in rng.integers(0, ck.HIST_MAX_ROWS, 200)]
    for n in ns:
        head, window, grid = ck.hist16_plan(n, sms, ptr + x_offset)
        assert 0 < window <= 65535 and window % 4 == 0
        assert head == min(n, x_offset // 8)  # brings x to 16 bytes
        assert (ptr + x_offset + 8 * head) % 16 == 0 or head == n
        assert 1 <= grid <= sms
        body = n - head
        windows = -(-body // window)
        assert windows <= grid or grid == sms  # no block idles while another has two
        if body:
            # no block counts more than its share by a quad per window
            assert -(-windows // grid) * (window - 4) < body / grid


def test_plans_reject_unaligned_elements_and_too_many_rows():
    with pytest.raises(ValueError):
        ck.hist16_plan(ck.HIST_MAX_ROWS + 1, 132, 1 << 20)
    with pytest.raises(ValueError):
        ck.hist16_plan(10, 132, (1 << 20) + 4)
    with pytest.raises(ValueError):
        ck.hll_plan(10, 132, (1 << 20) + 2)


def test_special_values_land_in_their_bins():
    x = torch.tensor([-0.0, 0.0, np.inf, -np.inf, 1e-310, 1e39, 1.0], dtype=torch.float64)
    live = torch.ones(len(x), dtype=torch.bool)
    bins = ck.f32_sortable_bin16_plain(x.float(), live).tolist()
    # -0.0 and +0.0 in adjacent bins; overflow to +-inf with the infinities
    assert bins[:6] == [0x7FFF, 0x8000, 65408, 127, 0x8000, 65408]
    assert bins[6] == 0xBF80


def test_bin_order_is_value_order():
    """Rounding to float32 never reverses two values: the host selection
    relies on it to take a rank's row from its bin."""
    rng = np.random.default_rng(3)
    # distinct values only: -0.0 == +0.0, yet they bin apart (the
    # quantile tests cover that case)
    x = np.unique(np.concatenate([rng.normal(0, 1e3, 5000), SPECIALS[SPECIALS != 0]]))
    live = torch.ones(len(x), dtype=torch.bool)
    bins = ck.f32_sortable_bin16_plain(torch.from_numpy(x).float(), live).numpy()
    assert np.all(np.diff(bins) >= 0)


def test_rejects_wrong_inputs():
    x = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(TypeError):
        ck.hist16(x.float(), torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError):
        ck.hist16(x, torch.ones(7, dtype=torch.bool))
