"""KLL quantile sketch: mergeable, bounded-memory rank queries.

The port's own copy of deequ_tpu/ops/sketches/kll.py (pure numpy), so
that a sketch built here equals the JAX package's bit for bit.

Replaces the reference's Greenwald-Khanna digest fork
(reference: catalyst/StatefulApproxQuantile.scala:28 — forked so `eval`
returns the serialized, mergeable digest). KLL fits the TPU engine better:
updates are batched sorts/decimations over dense arrays (vectorized, no
per-item pointer chasing) and merge is concatenate+compact, so per-batch
partial sketches stream from device-filtered values and fold on the host.

Rank error: eps ~ 2.3/k with the default k chosen for the reference's
relativeError=0.01 contract (reference: analyzers/ApproxQuantile.scala:49).
Quantile answers pick the smallest item whose cumulative weight reaches
q*n, matching percentile-of-dataset-element semantics (exact below k items,
like the reference's digest on small data).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

DEFAULT_K = 512  # eps ≈ 2.3/k ≈ 0.0045 < 0.01 default contract


def k_for_error(relative_error: float) -> int:
    if relative_error <= 0:
        return 1 << 16
    return max(8, int(np.ceil(2.3 / relative_error)))


class KLLSketch:
    """Levels of sorted buffers; level i items carry weight 2^i."""

    __slots__ = ("k", "levels", "n", "_rng", "_buffer")

    def __init__(self, k: int = DEFAULT_K, seed: int = 0):
        self.k = int(k)
        self.levels: List[np.ndarray] = [np.empty(0, dtype=np.float64)]
        self.n = 0
        self._rng = np.random.default_rng(seed)
        self._buffer: List[np.ndarray] = []

    # -- updates -------------------------------------------------------------

    def update_batch(self, values: np.ndarray) -> "KLLSketch":
        values = np.asarray(values, dtype=np.float64)
        m = len(values)
        if m == 0:
            return self
        if m >= 8 * self.k:
            return self._bulk_insert(values)
        self.n += m
        self._buffer.append(values)
        buffered = sum(len(b) for b in self._buffer)
        if buffered >= self._capacity(0):
            self._flush()
        return self

    def _bulk_insert(self, values: np.ndarray) -> "KLLSketch":
        """Large batch: ONE sort, then stride-2^L decimation straight into
        level L — equivalent to L cascaded pairwise compactions collapsed
        into a single step (one random offset instead of L independent
        ones; the introduced rank error stays O(2^L), the same order as
        the cascade's). Turns per-batch cost from ~2 sorts of m into one."""
        m = len(values)
        target_level = max(0, int(np.ceil(np.log2(m / (2.0 * self.k)))))
        stride = 1 << target_level
        sorted_vals = np.sort(values)
        offset = int(self._rng.integers(0, stride))
        promoted = sorted_vals[offset::stride]
        return self.insert_level(promoted, target_level, true_count=m)

    def insert_level(
        self,
        sorted_values: np.ndarray,
        level: int,
        true_count: Optional[int] = None,
    ) -> "KLLSketch":
        """Insert an already-decimated SORTED sample whose items carry
        weight 2^level (the device-sort path hands these over: the device
        sorts and stride-decimates, the host only merges). `true_count`
        is the exact number of underlying rows the sample summarizes."""
        self.n += int(true_count) if true_count is not None else (
            len(sorted_values) << level
        )
        if len(sorted_values) == 0:
            return self
        while len(self.levels) <= level:
            self.levels.append(np.empty(0, dtype=np.float64))
        # both sides sorted: timsort exploits the runs (linear merge)
        self.levels[level] = np.sort(
            np.concatenate(
                [self.levels[level], np.asarray(sorted_values, dtype=np.float64)]
            ),
            kind="stable",
        )
        self._compress()
        return self

    def _flush(self) -> None:
        if self._buffer:
            merged = np.concatenate([self.levels[0]] + self._buffer)
            self.levels[0] = np.sort(merged)
            self._buffer = []
        self._compress()

    def _capacity(self, level: int) -> int:
        # geometrically shrinking capacities toward lower levels (c = 2/3)
        depth = len(self.levels)
        c = 2.0 / 3.0
        return max(8, int(np.ceil(self.k * (c ** (depth - 1 - level)))))

    def _compress(self) -> None:
        level = 0
        while level < len(self.levels):
            if len(self.levels[level]) > self._capacity(level):
                buf = self.levels[level]
                if len(buf) % 2 == 1:
                    # hold one item back to keep pairs aligned
                    keep, buf = buf[:1], buf[1:]
                else:
                    keep = np.empty(0, dtype=np.float64)
                offset = int(self._rng.integers(0, 2))
                promoted = buf[offset::2]
                if level + 1 >= len(self.levels):
                    self.levels.append(np.empty(0, dtype=np.float64))
                self.levels[level + 1] = np.sort(
                    np.concatenate([self.levels[level + 1], promoted]),
                    kind="stable",  # two sorted runs: linear merge
                )
                self.levels[level] = keep
            level += 1

    # -- merge ---------------------------------------------------------------

    def merge(self, other: "KLLSketch") -> "KLLSketch":
        result = KLLSketch(k=min(self.k, other.k), seed=int(self._rng.integers(1 << 31)))
        result.n = self.n + other.n
        self._flush()
        other._flush()
        depth = max(len(self.levels), len(other.levels))
        result.levels = []
        for i in range(depth):
            a = self.levels[i] if i < len(self.levels) else np.empty(0)
            b = other.levels[i] if i < len(other.levels) else np.empty(0)
            result.levels.append(np.sort(np.concatenate([a, b])))
        result._compress()
        return result

    # -- queries -------------------------------------------------------------

    def _weighted_items(self) -> tuple[np.ndarray, np.ndarray]:
        self._flush()
        items = []
        weights = []
        for level, buf in enumerate(self.levels):
            if len(buf):
                items.append(buf)
                weights.append(np.full(len(buf), 1 << level, dtype=np.int64))
        if not items:
            return np.empty(0), np.empty(0, dtype=np.int64)
        all_items = np.concatenate(items)
        all_weights = np.concatenate(weights)
        order = np.argsort(all_items, kind="stable")
        return all_items[order], all_weights[order]

    def quantile(self, q: float) -> float:
        if self.n == 0:
            raise ValueError("empty sketch")
        items, weights = self._weighted_items()
        total = weights.sum()
        target = q * total
        cum = np.cumsum(weights)
        idx = int(np.searchsorted(cum, target, side="left"))
        idx = min(idx, len(items) - 1)
        return float(items[idx])

    def quantiles(self, qs) -> List[float]:
        if self.n == 0:
            raise ValueError("empty sketch")
        items, weights = self._weighted_items()
        total = weights.sum()
        cum = np.cumsum(weights)
        out = []
        for q in qs:
            idx = int(np.searchsorted(cum, q * total, side="left"))
            out.append(float(items[min(idx, len(items) - 1)]))
        return out

    def rank(self, value: float) -> float:
        """Approximate fraction of items <= value."""
        if self.n == 0:
            return 0.0
        items, weights = self._weighted_items()
        idx = int(np.searchsorted(items, value, side="right"))
        return float(weights[:idx].sum()) / float(weights.sum())

    # -- serde ---------------------------------------------------------------

    def to_arrays(self) -> tuple[int, int, List[np.ndarray]]:
        self._flush()
        return self.k, self.n, self.levels

    @staticmethod
    def from_arrays(k: int, n: int, levels: List[np.ndarray]) -> "KLLSketch":
        sketch = KLLSketch(k=k)
        sketch.n = n
        sketch.levels = [np.asarray(lv, dtype=np.float64) for lv in levels]
        return sketch

    # `merge` seeds its result from self._rng, so a sketch's future merge
    # behaviour depends on the generator's position, not just (k, n,
    # levels). Round-tripping that position is what lets a deserialized
    # partial (state cache, DCN envelope) merge bit-identically to the
    # live sketch it was saved from.

    RNG_STATE_LEN = 37

    def rng_state_bytes(self) -> bytes:
        """PCG64 generator position as a fixed 37-byte blob."""
        st = self._rng.bit_generator.state
        inner = st["state"]
        return (
            int(inner["state"]).to_bytes(16, "big")
            + int(inner["inc"]).to_bytes(16, "big")
            + int(st["has_uint32"]).to_bytes(1, "big")
            + int(st["uinteger"]).to_bytes(4, "big")
        )

    def set_rng_state_bytes(self, raw: bytes) -> None:
        """Inverse of rng_state_bytes; raises ValueError on a bad blob."""
        if len(raw) != self.RNG_STATE_LEN:
            raise ValueError(f"expected 37-byte rng state, got {len(raw)}")
        self._rng.bit_generator.state = {
            "bit_generator": "PCG64",
            "state": {
                "state": int.from_bytes(raw[:16], "big"),
                "inc": int.from_bytes(raw[16:32], "big"),
            },
            "has_uint32": raw[32],
            "uinteger": int.from_bytes(raw[33:37], "big"),
        }
