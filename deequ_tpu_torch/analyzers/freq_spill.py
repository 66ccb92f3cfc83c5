"""Disk-spilled group frequencies: a group-by of bounded memory.

The reference keeps its frequencies table as a Spark DataFrame cached at
MEMORY_AND_DISK (reference: runners/AnalysisRunner.scala:75,479-483), so
Uniqueness or Entropy over a near-unique key of a billion rows spills
instead of running out of memory. Here:

  * `GroupCountAccumulator` merges a streamed source's per-batch
    `FrequenciesAndNumRows` in memory until the group count passes a cap
    (``DEEQU_TPU_MAX_GROUPS_IN_MEMORY``, default 2M groups), then routes
    each batch's groups by a stable 64-bit key hash into one of N
    partition files;
  * `finalize()` compacts each partition once (a partition holds about
    groups/N distinct keys, so memory is O(cap + batch + groups/N)) and
    returns a `SpilledFrequencies` state;
  * `SpilledFrequencies` serves every consumer that can stream: the
    shared aggregation partition by partition (ops/freq_agg.py),
    Histogram's exact top-N, MutualInformation's marginals, and `merge`,
    without building the whole key set.

Every `freq_reduce` of the frequency family is a sum over groups of
f(count, num_rows), so streaming it partition by partition is exact.

The JAX counterpart is deequ_tpu/analyzers/freq_spill.py; the port keeps
its hash, so both packages route a key to the same partition.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import weakref
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deequ_tpu_torch.analyzers.states import State


def default_max_groups_in_memory() -> int:
    """Groups held in memory before the fold spills to disk
    (``DEEQU_TPU_MAX_GROUPS_IN_MEMORY``)."""
    return int(os.environ.get("DEEQU_TPU_MAX_GROUPS_IN_MEMORY", 2_000_000))


N_SPILL_PARTITIONS = 64
# routing works in row chunks so the hash temporaries stay O(chunk)
_ROUTE_CHUNK = 1 << 18


def _hash_key_rows(key_columns: Sequence[np.ndarray]) -> np.ndarray:
    """A stable uint64 hash per group row over all its key columns: the
    same key lands in the same partition in every batch and process."""
    from deequ_tpu_torch.ops.strings import hash_strings

    acc = np.full(len(key_columns[0]), np.uint64(0x9E3779B97F4A7C15))
    for kc in key_columns:
        h = hash_strings(np.asarray(kc).astype(str).astype(object))
        acc = (acc * np.uint64(0xC2B2AE3D27D4EB4F)) ^ h
    return acc


class _SpillWriter:
    """Appends (key columns, counts) chunks, hash-partitioned, to a
    temporary directory that it owns until `finalize`."""

    def __init__(self, columns: List[str], n_partitions: int = N_SPILL_PARTITIONS):
        self.columns = list(columns)
        self.n_partitions = n_partitions
        self.directory = tempfile.mkdtemp(prefix="deequ_tpu_spill_")
        self._seq = 0
        self.num_rows = 0
        # a fold that dies mid-stream must not leak its chunks
        self._cleanup = weakref.finalize(self, shutil.rmtree, self.directory, ignore_errors=True)

    def append(self, partial, include_rows: bool = True) -> None:
        """Route a partial's groups to their partitions and write one file
        per partition touched. `include_rows=False` leaves `num_rows` to
        the caller. The partial is not changed."""
        if include_rows:
            self.num_rows += partial.num_rows
        if partial.num_groups == 0:
            return
        key_columns = partial.key_columns
        if partial.columns != self.columns:
            key_columns = [partial.key_columns[partial.columns.index(c)] for c in self.columns]
        per_part_keys: List[List[List[np.ndarray]]] = [[] for _ in range(self.n_partitions)]
        per_part_counts: List[List[np.ndarray]] = [[] for _ in range(self.n_partitions)]
        for start in range(0, len(partial.counts), _ROUTE_CHUNK):
            stop = min(start + _ROUTE_CHUNK, len(partial.counts))
            kcs = [kc[start:stop] for kc in key_columns]
            counts = partial.counts[start:stop]
            parts = (_hash_key_rows(kcs) % np.uint64(self.n_partitions)).astype(np.int64)
            order = np.argsort(parts, kind="stable")
            boundaries = np.searchsorted(parts[order], np.arange(self.n_partitions + 1))
            for p in range(self.n_partitions):
                lo, hi = boundaries[p], boundaries[p + 1]
                if lo == hi:
                    continue
                sel = order[lo:hi]
                per_part_keys[p].append([kc[sel] for kc in kcs])
                per_part_counts[p].append(counts[sel])
        self._seq += 1
        for p in range(self.n_partitions):
            if not per_part_counts[p]:
                continue
            chunk = (
                [
                    np.concatenate([kcs[j] for kcs in per_part_keys[p]])
                    for j in range(len(key_columns))
                ],
                np.concatenate(per_part_counts[p]),
            )
            path = os.path.join(self.directory, f"p{p:03d}_{self._seq:06d}.pkl")
            with open(path, "wb") as f:
                pickle.dump(chunk, f, protocol=pickle.HIGHEST_PROTOCOL)

    def finalize(self) -> "SpilledFrequencies":
        """Compact each partition to one file and count the groups
        exactly; the directory passes to the returned state."""
        from deequ_tpu_torch.analyzers.frequency import FrequenciesAndNumRows

        num_groups = 0
        by_partition: dict = {}
        for fn in os.listdir(self.directory):
            if fn.startswith("p") and fn.endswith(".pkl") and "_" in fn:
                by_partition.setdefault(fn[: fn.index("_")], []).append(fn)
        for p in range(self.n_partitions):
            chunk_files = sorted(by_partition.get(f"p{p:03d}", []))
            if not chunk_files:
                continue
            key_chunks: List[List[np.ndarray]] = []
            count_chunks: List[np.ndarray] = []
            for fn in chunk_files:
                with open(os.path.join(self.directory, fn), "rb") as f:
                    kcs, counts = pickle.load(f)
                key_chunks.append(kcs)
                count_chunks.append(counts)
            merged = FrequenciesAndNumRows(
                self.columns,
                [np.concatenate([kc[j] for kc in key_chunks]) for j in range(len(self.columns))],
                np.concatenate(count_chunks),
                0,
            )
            if len(chunk_files) > 1:
                merged = merged.compacted()
            num_groups += merged.num_groups
            with open(os.path.join(self.directory, f"part{p:03d}.pkl"), "wb") as f:
                pickle.dump((merged.key_columns, merged.counts), f, protocol=pickle.HIGHEST_PROTOCOL)
            for fn in chunk_files:
                os.unlink(os.path.join(self.directory, fn))
        self._cleanup.detach()
        return SpilledFrequencies(
            self.columns, self.directory, self.n_partitions, self.num_rows, num_groups
        )


class SpilledFrequencies(State):
    """Disk-backed group frequencies, hash-partitioned and compacted.

    Serves the consumers of `FrequenciesAndNumRows` that can stream; it
    deliberately has no whole-table ``counts`` array."""

    is_spilled = True

    def __init__(
        self, columns: List[str], directory: str, n_partitions: int, num_rows: int, num_groups: int
    ):
        self.columns = list(columns)
        self.directory = directory
        self.n_partitions = n_partitions
        self.num_rows = int(num_rows)
        self.num_groups = int(num_groups)
        self._cleanup = weakref.finalize(self, shutil.rmtree, directory, ignore_errors=True)

    def partitions(self) -> Iterator["object"]:
        """Each partition as an in-memory FrequenciesAndNumRows (num_rows
        0); no key is in two partitions."""
        from deequ_tpu_torch.analyzers.frequency import FrequenciesAndNumRows

        for p in range(self.n_partitions):
            path = os.path.join(self.directory, f"part{p:03d}.pkl")
            if not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                key_columns, counts = pickle.load(f)
            yield FrequenciesAndNumRows(self.columns, key_columns, counts, 0)

    def top_n(self, n: int) -> Tuple[List[np.ndarray], np.ndarray]:
        """The exact global top-n groups by (count desc, key asc): each
        partition's top-n, then the top-n of their union (a partition
        holds its keys' full counts). Single-column states only, as the
        tie-break is over the one key column."""
        from deequ_tpu_torch.analyzers.frequency import top_n_order

        if len(self.columns) != 1:
            raise ValueError(
                "top_n's deterministic tie-break is defined for "
                f"single-column states, got {self.columns}"
            )
        best_keys: List[np.ndarray] = []
        best_counts: List[np.ndarray] = []
        for part in self.partitions():
            order = top_n_order(part.key_columns[0], part.counts, n)
            best_keys.append(part.key_columns[0][order])
            best_counts.append(part.counts[order])
        if not best_counts:
            return [np.array([], dtype=object)], np.array([], dtype=np.int64)
        keys = np.concatenate(best_keys)
        counts = np.concatenate(best_counts)
        order = top_n_order(keys, counts, n)
        return [keys[order]], counts[order]

    def merge(self, other) -> "SpilledFrequencies":
        """Merge with either kind of state into a fresh spill (compaction
        stays partition-local). Neither operand changes."""
        writer = _SpillWriter(self.columns, self.n_partitions)
        for part in self.partitions():
            writer.append(part, include_rows=False)
        if getattr(other, "is_spilled", False):
            for part in other.partitions():
                writer.append(part, include_rows=False)
        else:
            writer.append(_reorder(other, self.columns), include_rows=False)
        writer.num_rows = self.num_rows + other.num_rows
        return writer.finalize()

    def __repr__(self) -> str:
        return (
            f"SpilledFrequencies({self.columns}, groups={self.num_groups}, "
            f"num_rows={self.num_rows}, partitions={self.n_partitions})"
        )


def _reorder(state, columns: List[str]):
    from deequ_tpu_torch.analyzers.frequency import FrequenciesAndNumRows

    if state.columns == list(columns):
        return state
    if sorted(state.columns) != sorted(columns):
        raise ValueError(f"cannot merge frequencies over {state.columns} with {columns}")
    return FrequenciesAndNumRows(
        list(columns),
        [state.key_columns[state.columns.index(c)] for c in columns],
        state.counts,
        state.num_rows,
    )


class GroupCountAccumulator:
    """The cross-batch fold of frequency partials under a group cap:
    below it the plain in-memory merge, above it a hash-partitioned spill
    whose merging waits for the per-partition compaction of `finalize`."""

    def __init__(
        self,
        columns: Sequence[str],
        max_groups_in_memory: Optional[int] = None,
        n_partitions: int = N_SPILL_PARTITIONS,
    ):
        self.columns = list(columns)
        self.max_groups = (
            default_max_groups_in_memory() if max_groups_in_memory is None else max_groups_in_memory
        )
        self.n_partitions = n_partitions
        self._buffer = None
        self._writer: Optional[_SpillWriter] = None

    def add(self, partial) -> None:
        if self._writer is not None:
            self._writer.append(partial)
            return
        combined = partial.num_groups + (0 if self._buffer is None else self._buffer.num_groups)
        if combined > self.max_groups:
            # spill both sides unmerged: merging a buffer about to spill
            # would hold about three times the cap at its peak; the
            # per-partition compaction deduplicates instead
            self._writer = _SpillWriter(self.columns, self.n_partitions)
            if self._buffer is not None:
                self._writer.append(self._buffer)
                self._buffer = None
            self._writer.append(partial)
            return
        self._buffer = partial if self._buffer is None else self._buffer.merge(partial)

    def finalize(self):
        from deequ_tpu_torch.analyzers.frequency import FrequenciesAndNumRows

        if self._writer is not None:
            return self._writer.finalize()
        if self._buffer is None:
            return FrequenciesAndNumRows(
                self.columns,
                [np.array([], dtype=object) for _ in self.columns],
                np.array([], dtype=np.int64),
                0,
            )
        return self._buffer
