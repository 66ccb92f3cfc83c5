"""The port's shard planner (deequ_tpu_torch/parallel/shard.py) against
the JAX package's: the same fingerprints give the same assignment, and
the planner's own properties (each partition once, order kept, minimal
movement when a shard is excluded) hold."""

from __future__ import annotations

import pytest

from deequ_tpu.parallel import shard as jshard
from deequ_tpu_torch.parallel.shard import ShardPlan, plan_shards, rendezvous_weight


class FakePartition:
    def __init__(self, i, salt=""):
        self.name = f"part-{i:03d}.parquet"
        self.path = f"/data/{self.name}"
        self.fingerprint = f"fp{salt}-{i:03d}-{i * 2654435761 % 997:x}"


def parts(n, salt=""):
    return [FakePartition(i, salt) for i in range(n)]


@pytest.mark.parametrize("n_parts", [0, 1, 9, 40])
@pytest.mark.parametrize("num_shards", [1, 2, 3, 5])
def test_assignment_equals_jax(n_parts, num_shards):
    ps = parts(n_parts, salt=f"{n_parts}x{num_shards}")
    got = plan_shards(ps, num_shards)
    want = jshard.plan_shards(ps, num_shards)
    assert got.order == want.order
    for k in range(num_shards):
        assert got.assignment(k).names == want.assignment(k).names
        assert got.assignment(k).paths == want.assignment(k).paths
        assert got.assignment(k).fingerprints == want.assignment(k).fingerprints


@pytest.mark.parametrize("exclude", [(0,), (1,), (1, 3)])
def test_exclusion_equals_jax(exclude):
    ps = parts(30)
    got = plan_shards(ps, 4, exclude=exclude)
    want = jshard.plan_shards(ps, 4, exclude=exclude)
    for k in range(4):
        assert got.assignment(k).names == want.assignment(k).names


def test_weight_equals_jax():
    for fp in ("fp-a", "", "ß-unicode", "a" * 200):
        for s in range(6):
            assert rendezvous_weight(fp, s) == jshard.rendezvous_weight(fp, s)
    assert rendezvous_weight("fp-a", 0) != rendezvous_weight("fp-a", 1)


def test_every_partition_assigned_exactly_once():
    plan = plan_shards(parts(23), 4)
    seen = [n for k in range(4) for n in plan.assignment(k).names]
    assert sorted(seen) == [p.name for p in parts(23)]


def test_global_order_preserved():
    plan = plan_shards(parts(12), 3)
    assert [n for n, _p, _f in plan.order] == [p.name for p in parts(12)]
    for k in range(3):
        names = plan.assignment(k).names
        assert list(names) == [n for n, _p, _f in plan.order if n in set(names)]


def test_minimal_movement_on_exclusion():
    ps = parts(40)
    before = plan_shards(ps, 4)
    after = plan_shards(ps, 4, exclude=(1,))
    assert after.assignment(1).names == ()
    gained = set()
    for k in (0, 2, 3):
        assert set(before.assignment(k).names) <= set(after.assignment(k).names)
        gained |= set(after.assignment(k).names) - set(before.assignment(k).names)
    assert gained == set(before.assignment(1).names)


def test_single_shard_and_empty_dataset():
    plan = plan_shards(parts(9), 1)
    assert plan.assignment(0).num_partitions == 9
    empty = plan_shards([], 3)
    assert empty.order == () and all(empty.assignment(k).names == () for k in range(3))
    assert isinstance(empty, ShardPlan)


def test_rejects_bad_inputs():
    with pytest.raises(ValueError):
        plan_shards(parts(4), 0)
    with pytest.raises(ValueError):
        plan_shards(parts(4), 2, exclude=(0, 1))


@pytest.mark.parametrize("n_parts", [0, 1, 9, 40])
@pytest.mark.parametrize("num_shards", [1, 3, 5])
def test_plan_summaries_equal_jax(n_parts, num_shards):
    """owner_of, the largest and smallest shard, and the skew: exactly
    the JAX package's, and the skew EXPLAIN's `shards:` line renders."""
    from deequ_tpu_torch.lint.cost import PlanCost

    ps = parts(n_parts, salt="summary")
    got = plan_shards(ps, num_shards)
    want = jshard.plan_shards(ps, num_shards)
    for p in ps:
        assert got.owner_of(p.name) == want.owner_of(p.name)
    with pytest.raises(KeyError):
        got.owner_of("absent.parquet")
    assert (got.max_partitions, got.min_partitions, got.skew) == (
        want.max_partitions, want.min_partitions, want.skew
    )
    cost = PlanCost(
        placement="device", compute_dtype="float64", engine="single", num_rows=None,
        batch_size=None, num_shards=num_shards,
        shard_partitions=tuple(got.assignment(k).num_partitions for k in range(num_shards)),
    )
    assert cost.shard_partitions_max == got.max_partitions
    assert cost.shard_skew == pytest.approx(got.skew, rel=1e-15)


def test_explain_renders_the_shards_line(tmp_path):
    """EXPLAIN of a sharded scan: `shards: N processes × K partitions each
    (max skew S)`, from the planner's own split."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from deequ_tpu_torch.analyzers import Mean
    from deequ_tpu_torch.data.source import PartitionedParquetSource
    from deequ_tpu_torch.lint import explain_plan

    for i in range(6):
        pq.write_table(pa.table({"x": np.arange(10.0) + i}), str(tmp_path / f"p-{i}.parquet"))
    src = PartitionedParquetSource(str(tmp_path))
    plan = plan_shards(list(src.partitions()), 4)
    counts = [plan.assignment(k).num_partitions for k in range(4)]
    text = str(explain_plan(src, [Mean("x")], num_shards=4, shard_partitions=counts, device="cpu"))
    assert f"shards: 4 processes × 2 partitions each (max skew {plan.skew:.2f})" in text
