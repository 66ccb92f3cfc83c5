"""KLL bulk-insertion accuracy: the one-sort stride-decimation path must
keep rank error inside the relative_error=0.01 contract
(reference: analyzers/ApproxQuantile.scala:49).

Port-mapped from tests/test_kll_bulk.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import numpy as np
import pytest

from deequ_tpu_torch.ops.sketches.kll import KLLSketch, k_for_error

pytestmark = pytest.mark.usefixtures("cpu_default")


class TestBulkInsert:
    @pytest.mark.parametrize("dist", ["uniform", "lognormal", "sorted"])
    def test_rank_error_within_contract(self, dist):
        rng = np.random.default_rng(5)
        n = 1_000_000
        if dist == "uniform":
            values = rng.random(n)
        elif dist == "lognormal":
            values = rng.lognormal(0, 2, n)
        else:
            values = np.arange(n, dtype=np.float64)
        sketch = KLLSketch(k=k_for_error(0.01), seed=11)
        # several large batches: exercises bulk insert + level merging
        for chunk in np.array_split(values, 7):
            sketch.update_batch(chunk)
        exact_sorted = np.sort(values)
        for q in (0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99):
            estimate = sketch.quantile(q)
            # rank of the estimate must be within eps of q
            rank = np.searchsorted(exact_sorted, estimate, side="right") / n
            assert abs(rank - q) <= 0.01, (dist, q, rank)

    def test_bulk_then_merge_parity(self):
        rng = np.random.default_rng(6)
        a, b = rng.normal(0, 1, 500_000), rng.normal(3, 1, 500_000)
        sa = KLLSketch(k=512, seed=1).update_batch(a)
        sb = KLLSketch(k=512, seed=2).update_batch(b)
        merged = sa.merge(sb)
        exact = np.sort(np.concatenate([a, b]))
        for q in (0.1, 0.5, 0.9):
            rank = np.searchsorted(exact, merged.quantile(q), side="right") / len(exact)
            assert abs(rank - q) <= 0.01, (q, rank)

    def test_device_assisted_rank_error_within_contract(self):
        """The fused-pass quantile path (device sort + stride decimation,
        host KLL level-inserts) must satisfy the same rank-error contract
        across many batches."""
        import pytest

        from deequ_tpu_torch.analyzers import ApproxQuantiles
        from deequ_tpu_torch.data.table import Table
        from deequ_tpu_torch.ops.fused import FusedScanPass

        rng = np.random.default_rng(17)
        values = rng.lognormal(0.0, 1.5, 600_000)
        t = Table.from_numpy({"v": values})
        analyzer = ApproxQuantiles("v", (0.01, 0.1, 0.5, 0.9, 0.99))
        result = FusedScanPass([analyzer], batch_size=1 << 16).run(t)[0]  # 10 batches
        metric = analyzer.compute_metric_from(result.state_or_raise())
        exact_sorted = np.sort(values)
        for q, estimate in metric.value.get().items():
            rank = np.searchsorted(exact_sorted, estimate, side="right") / len(values)
            assert abs(rank - float(q)) <= 0.01, (q, rank)

    def test_device_assisted_with_where_filter(self):
        from deequ_tpu_torch.analyzers import ApproxQuantile
        from deequ_tpu_torch.data.table import Table
        from deequ_tpu_torch.ops.fused import FusedScanPass

        t = Table.from_numpy(
            {"v": np.arange(10_000, dtype=np.float64),
             "g": np.arange(10_000) % 2}
        )
        analyzer = ApproxQuantile("v", 0.5, where="g = 0")
        result = FusedScanPass([analyzer]).run(t)[0]
        metric = analyzer.compute_metric_from(result.state_or_raise())
        # evens only: median ~ 5000 +- sketch error
        assert abs(metric.value.get() - 5000) <= 150

    def test_small_batches_unaffected(self):
        # below the bulk threshold the buffered path still runs
        sketch = KLLSketch(k=64, seed=3)
        values = np.arange(1000, dtype=np.float64)
        for chunk in np.array_split(values, 50):
            sketch.update_batch(chunk)
        assert sketch.n == 1000
        assert abs(sketch.quantile(0.5) - 500) <= 40  # eps ~ 2.3/64
