"""Window specifications over partition time.

A partitioned dataset's time axis is derived from its layout: partition
basenames carrying a date (`part-2026-08-01.parquet`, `20260801.pq`)
map to epoch-day *buckets*; datasets without a recognizable date fall
back to positional buckets (partition index in name order). An explicit
``extractor`` overrides both. Every window below compiles to a
half-open bucket range ``[lo, hi)`` plus the member partition indices —
the unit `windows/segments.py` decomposes into power-of-two spans.

Bucket order must agree with partition *name* order (the engine's
deterministic merge order): a timeline whose buckets decrease along the
name-sorted layout is rejected, because a window over it would not be a
contiguous name-order range and the merge could not be bit-identical to
a rescan.

The JAX counterpart is deequ_tpu/windows/spec.py (stdlib only; the port
keeps its own copy).
"""

from __future__ import annotations

import datetime
import re
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

__all__ = [
    "LastN",
    "Sliding",
    "Timeline",
    "Tumbling",
    "WindowFrame",
    "WindowSpec",
    "default_bucket_for",
]

#: dataset-layout date forms, tried in order: ISO `YYYY-MM-DD`, then a
#: bare `YYYYMMDD` run of 8 digits
_DATE_RES = (
    re.compile(r"(\d{4})-(\d{2})-(\d{2})"),
    re.compile(r"(?<!\d)(\d{4})(\d{2})(\d{2})(?!\d)"),
)


def default_bucket_for(name: str) -> Optional[int]:
    """Epoch-day bucket from a partition basename, or None when the
    name carries no valid date. Proleptic-Gregorian ordinal days
    (`datetime.date.toordinal`), so "last 7 days" is exact calendar
    arithmetic with no timezone involved."""
    for pattern in _DATE_RES:
        m = pattern.search(name)
        if m is None:
            continue
        try:
            year, month, day = (int(g) for g in m.groups())
            return datetime.date(year, month, day).toordinal()
        except ValueError:
            continue
    return None


@dataclass(frozen=True)
class WindowFrame:
    """One resolved window: a half-open bucket range plus the member
    partition indices (positions into the timeline, name order)."""

    label: str
    lo: int  # inclusive bucket
    hi: int  # exclusive bucket
    indices: Tuple[int, ...]

    def shifted(self, delta: int, timeline: "Timeline") -> "WindowFrame":
        """The same window `delta` buckets earlier (week-over-week
        baselines: `frame.shifted(7, timeline)`)."""
        return timeline.frame(
            self.lo - delta, self.hi - delta,
            label=f"{self.label} shifted -{delta}",
        )


@dataclass(frozen=True)
class Timeline:
    """The dataset's partition→bucket assignment, in partition name
    order. `axis` records where the buckets came from: 'date' (layout
    or extractor yields calendar days) or 'index' (positional)."""

    names: Tuple[str, ...]
    buckets: Tuple[int, ...]
    axis: str = "date"

    def __post_init__(self) -> None:
        if len(self.names) != len(self.buckets):
            raise ValueError("timeline names and buckets differ in length")
        for prev, cur in zip(self.buckets, self.buckets[1:]):
            if cur < prev:
                raise ValueError(
                    "partition buckets must be non-decreasing in name "
                    "order (windows are contiguous name-order ranges); "
                    f"got {prev} then {cur} in {self.names!r}"
                )

    @classmethod
    def derive(
        cls,
        partitions: Sequence,
        extractor: Optional[Callable[[str], Optional[int]]] = None,
    ) -> "Timeline":
        """Timeline from `Partition` objects (anything with `.name`).
        An explicit `extractor` must bucket every partition (error
        otherwise); the layout-derived default degrades to positional
        buckets when any name lacks a date."""
        names = tuple(p.name for p in partitions)
        if extractor is not None:
            buckets = []
            for name in names:
                b = extractor(name)
                if b is None:
                    raise ValueError(
                        f"window bucket extractor returned None for "
                        f"partition {name!r}"
                    )
                buckets.append(int(b))
            return cls(names, tuple(buckets), axis="date")
        derived = [default_bucket_for(name) for name in names]
        if names and all(b is not None for b in derived):
            return cls(names, tuple(int(b) for b in derived), axis="date")
        return cls(names, tuple(range(len(names))), axis="index")

    def __len__(self) -> int:
        return len(self.names)

    @property
    def min_bucket(self) -> int:
        return self.buckets[0] if self.buckets else 0

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1] if self.buckets else 0

    def indices_in(self, lo: int, hi: int) -> Tuple[int, ...]:
        """Partition indices whose bucket falls in ``[lo, hi)``."""
        return tuple(
            i for i, b in enumerate(self.buckets) if lo <= b < hi
        )

    def frame(self, lo: int, hi: int, *, label: str = "") -> WindowFrame:
        return WindowFrame(
            label=label or f"buckets [{lo}, {hi})",
            lo=int(lo),
            hi=int(hi),
            indices=self.indices_in(lo, hi),
        )


class WindowSpec:
    """A window family over a timeline. `resolve` yields the LATEST
    window (the one a per-ingest-tick suite watches); `series` yields
    every window the timeline holds, ascending."""

    def describe(self) -> str:
        raise NotImplementedError

    def resolve(self, timeline: Timeline) -> WindowFrame:
        raise NotImplementedError

    def series(self, timeline: Timeline) -> List[WindowFrame]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return self.describe()


@dataclass(frozen=True, repr=False)
class Tumbling(WindowSpec):
    """Non-overlapping windows of `size` buckets aligned at `origin`
    (+ k·size). A daily layout with size=7, origin on a Monday gives
    calendar weeks."""

    size: int
    origin: int = 0

    def __post_init__(self) -> None:
        if self.size < 1:
            raise ValueError(f"tumbling window size must be >= 1, got {self.size}")

    def describe(self) -> str:
        return f"tumbling({self.size})"

    def _aligned_lo(self, bucket: int) -> int:
        return self.origin + ((bucket - self.origin) // self.size) * self.size

    def series(self, timeline: Timeline) -> List[WindowFrame]:
        if not len(timeline):
            return []
        frames = []
        lo = self._aligned_lo(timeline.min_bucket)
        while lo <= timeline.max_bucket:
            frame = timeline.frame(
                lo, lo + self.size, label=f"{self.describe()}[{lo}]"
            )
            if frame.indices:
                frames.append(frame)
            lo += self.size
        return frames

    def resolve(self, timeline: Timeline) -> WindowFrame:
        lo = self._aligned_lo(timeline.max_bucket)
        return timeline.frame(
            lo, lo + self.size, label=f"{self.describe()}[{lo}]"
        )


@dataclass(frozen=True, repr=False)
class Sliding(WindowSpec):
    """Windows of `size` buckets advancing by `step`, anchored so the
    latest window ENDS at the newest bucket (a 7-day sliding window is
    always "the last 7 days as of the latest partition")."""

    size: int
    step: int = 1

    def __post_init__(self) -> None:
        if self.size < 1 or self.step < 1:
            raise ValueError(
                f"sliding window needs size/step >= 1, got "
                f"size={self.size} step={self.step}"
            )

    def describe(self) -> str:
        return f"sliding({self.size}, step={self.step})"

    def resolve(self, timeline: Timeline) -> WindowFrame:
        hi = timeline.max_bucket + 1
        return timeline.frame(
            hi - self.size, hi, label=f"{self.describe()}[{hi - self.size}]"
        )

    def series(self, timeline: Timeline) -> List[WindowFrame]:
        if not len(timeline):
            return []
        frames = []
        ends = []
        end = timeline.max_bucket + 1
        while end > timeline.min_bucket:
            ends.append(end)
            end -= self.step
        for end in reversed(ends):
            frame = timeline.frame(
                end - self.size, end,
                label=f"{self.describe()}[{end - self.size}]",
            )
            if frame.indices:
                frames.append(frame)
        return frames


@dataclass(frozen=True, repr=False)
class LastN(WindowSpec):
    """The trailing window: the last `n` days (bucket arithmetic) or
    the last `n` partitions (positional, layout-agnostic)."""

    n: int
    unit: str = "days"  # 'days' | 'partitions'

    def __post_init__(self) -> None:
        if self.n < 1:
            raise ValueError(f"last-N window needs n >= 1, got {self.n}")
        if self.unit not in ("days", "partitions"):
            raise ValueError(f"last-N unit must be 'days' or 'partitions', got {self.unit!r}")

    def describe(self) -> str:
        return f"last({self.n} {self.unit})"

    def resolve(self, timeline: Timeline) -> WindowFrame:
        if self.unit == "days":
            hi = timeline.max_bucket + 1
            return timeline.frame(
                hi - self.n, hi, label=self.describe()
            )
        indices = tuple(range(max(0, len(timeline) - self.n), len(timeline)))
        if not indices:
            return WindowFrame(self.describe(), 0, 0, ())
        lo = timeline.buckets[indices[0]]
        hi = timeline.buckets[indices[-1]] + 1
        return WindowFrame(self.describe(), lo, hi, indices)

    def series(self, timeline: Timeline) -> List[WindowFrame]:
        return [self.resolve(timeline)] if len(timeline) else []
