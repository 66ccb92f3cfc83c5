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
