"""HLL++ accuracy sweep: estimates must stay inside the declared
rsd=0.05 envelope across the cardinality range, including the mid-range
regime the bias tables exist for
(reference: catalyst/HLLConstants.scala:25, StatefulHyperloglogPlus.scala:210-297).

Port-mapped from tests/test_hll_accuracy.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import numpy as np
import pytest

from deequ_tpu_torch.ops.sketches import hll
from deequ_tpu_torch.ops.sketches.hll_bias import BIAS_P9, RAW_ESTIMATE_P9, THRESHOLD_P9

pytestmark = pytest.mark.usefixtures("cpu_default")


def estimate_for_cardinality(n: int, seed: int) -> float:
    rng = np.random.default_rng(seed)
    # distinct 64-bit values; hash through the engine's numeric path
    values = rng.permutation(np.arange(1, n + 1, dtype=np.int64)) + (
        np.int64(seed) << 32
    )
    registers = np.zeros(hll.M, dtype=np.int32)
    hashes = hll.xxhash64_u64(values)
    idx, rank = hll.registers_from_hashes(hashes)
    hll.update_registers(registers, idx, rank)
    return hll.estimate(registers)


class TestAccuracySweep:
    @pytest.mark.parametrize(
        "cardinality",
        [100, 300, 700, 1_500, 3_000, 6_000, 12_000, 25_000,
         50_000, 100_000, 300_000, 1_000_000],
    )
    def test_relative_error_within_rsd(self, cardinality):
        errors = []
        for seed in (1, 2, 3):
            est = estimate_for_cardinality(cardinality, seed)
            errors.append(abs(est - cardinality) / cardinality)
        # rsd = 0.05; mean of 3 runs within 2 sigma
        assert np.mean(errors) <= 0.10, (cardinality, errors)

    def test_small_cardinalities_near_exact(self):
        # linear counting regime: exact until register collisions appear
        # (n=50 over 512 registers already expects ~2 collisions — the
        # reference's estimator has the identical behavior)
        for n in (1, 2, 5, 10):
            est = estimate_for_cardinality(n, 9)
            assert est == n, (n, est)
        for n in (50, 200, 500):
            est = estimate_for_cardinality(n, 9)
            assert abs(est - n) <= max(2, 0.1 * n), (n, est)

    def test_tables_well_formed(self):
        assert len(RAW_ESTIMATE_P9) == len(BIAS_P9) == 201
        assert np.all(np.diff(RAW_ESTIMATE_P9) > 0)  # sorted for searchsorted
        assert THRESHOLD_P9 == 400.0

    def test_bias_interpolation_window(self):
        # below the first table point: uses the first K entries
        b = hll.estimate_bias(float(RAW_ESTIMATE_P9[0]) - 100)
        assert b == pytest.approx(float(np.mean(BIAS_P9[:6])))
        # above the last point the reference's clamping yields a 5-entry
        # window: nearest=201 -> low=196, high=min(202, 201)=201
        b = hll.estimate_bias(float(RAW_ESTIMATE_P9[-1]) + 100)
        assert b == pytest.approx(float(np.mean(BIAS_P9[196:201])))

    def test_mid_range_improved_by_bias_correction(self):
        """In the 2.5m..5m regime (m=512: ~1280..2560) the raw estimate
        is known to overestimate; the corrected estimator must not."""
        errs = []
        for n in (1_400, 1_800, 2_200, 2_600, 3_200):
            for seed in (11, 12, 13, 14):
                est = estimate_for_cardinality(n, seed)
                errs.append((est - n) / n)
        # mean signed error near zero: no systematic overestimate
        assert abs(float(np.mean(errs))) <= 0.05, errs
