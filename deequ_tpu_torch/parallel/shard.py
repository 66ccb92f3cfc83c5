"""Deterministic partition -> shard planning for the sharded streaming
scan (parallel/multihost.py:run_sharded_analysis).

  * Deterministic: every process computes the same plan from the same
    partition list with no coordination: a partition's owner is a pure
    function of its content fingerprint (data/source.py:
    partition_fingerprint, the key the state cache stores it under) and
    the shard count.
  * Minimal movement: ownership is a rendezvous (highest-random-weight)
    hash. Each (fingerprint, shard) pair hashes to a weight of its own,
    and the live shard with the highest weight owns the partition, so
    removing a shard moves only the partitions it owned and adding one
    takes only those it now wins.
  * Order-preserving: within a shard, partitions keep their dataset
    (name) order, and the plan records the whole order, in which the
    merge folds the states, as a solo partitioned run does.

A lost shard is planned around by listing it in `exclude`: its
partitions fall to the surviving shards. The JAX counterpart is
deequ_tpu/parallel/shard.py, and both give the same plan.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from deequ_tpu_torch.testing import faults


def rendezvous_weight(fingerprint: str, shard: int) -> int:
    """The (partition, shard) weight: the first 8 bytes of
    sha256("<fingerprint>:<shard>") as a big-endian integer."""
    digest = hashlib.sha256(f"{fingerprint}:{shard}".encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big")


@dataclass(frozen=True)
class ShardAssignment:
    """One shard's slice of the dataset, in dataset order."""

    shard: int
    names: Tuple[str, ...]
    paths: Tuple[str, ...]
    fingerprints: Tuple[str, ...]

    @property
    def num_partitions(self) -> int:
        return len(self.names)


@dataclass(frozen=True)
class ShardPlan:
    """One `ShardAssignment` per shard id (an excluded or empty shard gets
    an empty one), and the dataset order the merge folds in."""

    num_shards: int
    assignments: Tuple[ShardAssignment, ...]
    #: (name, path, fingerprint) of every partition, in dataset order
    order: Tuple[Tuple[str, str, str], ...]

    def assignment(self, shard: int) -> ShardAssignment:
        return self.assignments[shard]

    def owner_of(self, name: str) -> int:
        for a in self.assignments:
            if name in a.names:
                return a.shard
        raise KeyError(name)

    @property
    def max_partitions(self) -> int:
        return max(a.num_partitions for a in self.assignments)

    @property
    def min_partitions(self) -> int:
        live = [a.num_partitions for a in self.assignments if a.num_partitions]
        return min(live) if live else 0

    @property
    def skew(self) -> float:
        """The largest shard over the even split (total / num_shards):
        1.0 is a perfectly even split. EXPLAIN's `shards:` line reports it
        (lint/cost.py:PlanCost.shard_skew over the same counts)."""
        total = len(self.order)
        if total == 0 or self.num_shards == 0:
            return 1.0
        ideal = total / float(self.num_shards)
        return self.max_partitions / ideal if ideal > 0 else 1.0


def plan_shards(partitions: Sequence, num_shards: int, exclude: Sequence[int] = ()) -> ShardPlan:
    """Assign `partitions` (with `.name`, `.path` and `.fingerprint`, in
    dataset order) to `num_shards` shards by rendezvous hash over the
    fingerprints. Shards in `exclude` receive nothing: their partitions
    fall to the highest-weight survivor, and only theirs move."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    excluded = {int(s) for s in exclude}
    alive = [s for s in range(num_shards) if s not in excluded]
    if not alive:
        raise ValueError(f"all {num_shards} shards excluded: nothing can own the data")
    faults.fault_point("shard.assign")
    owned: Dict[int, List] = {s: [] for s in range(num_shards)}
    order: List[Tuple[str, str, str]] = []
    for part in partitions:
        fingerprint = part.fingerprint
        order.append((part.name, part.path, fingerprint))
        # ties go to the higher shard id, so the plan is total
        owner = max(alive, key=lambda s: (rendezvous_weight(fingerprint, s), s))
        owned[owner].append(part)
    assignments = tuple(
        ShardAssignment(
            shard=s,
            names=tuple(p.name for p in owned[s]),
            paths=tuple(p.path for p in owned[s]),
            fingerprints=tuple(p.fingerprint for p in owned[s]),
        )
        for s in range(num_shards)
    )
    return ShardPlan(num_shards=num_shards, assignments=assignments, order=tuple(order))


__all__ = ["ShardAssignment", "ShardPlan", "plan_shards", "rendezvous_weight"]
