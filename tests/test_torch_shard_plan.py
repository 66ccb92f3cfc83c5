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
