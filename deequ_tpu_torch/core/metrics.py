"""Typed metric values.

Reference: metrics/Metric.scala:19-68, metrics/HistogramMetric.scala:18-60.
Pure data layer — no engine dependency.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Generic, List, Sequence, TypeVar

from deequ_tpu_torch.core.maybe import Failure, Success, Try

T = TypeVar("T")


class Entity(enum.Enum):
    """What a metric is about. The serialized name of MULTICOLUMN keeps the
    reference's load-bearing typo ("Mutlicolumn", metrics/Metric.scala:21)."""

    DATASET = "Dataset"
    COLUMN = "Column"
    MULTICOLUMN = "Mutlicolumn"


@dataclass(frozen=True)
class Metric(Generic[T]):
    entity: Entity
    name: str
    instance: str
    value: Try[T]

    def flatten(self) -> Sequence["DoubleMetric"]:
        raise NotImplementedError


@dataclass(frozen=True)
class DoubleMetric(Metric[float]):
    def flatten(self) -> Sequence["DoubleMetric"]:
        return [self]


@dataclass(frozen=True)
class KeyedDoubleMetric(Metric[Dict[str, float]]):
    """Many named values from one analyzer (e.g. ApproxQuantiles).
    Flatten emits `name-$key` (reference: metrics/Metric.scala:56-66)."""

    def flatten(self) -> Sequence[DoubleMetric]:
        if self.value.is_success:
            return [
                DoubleMetric(self.entity, f"{self.name}-{k}", self.instance, Success(v))
                for k, v in self.value.get().items()
            ]
        return [DoubleMetric(self.entity, self.name, self.instance, self.value)]


@dataclass(frozen=True)
class DistributionValue:
    absolute: int
    ratio: float


@dataclass(frozen=True)
class Distribution:
    values: Dict[str, DistributionValue]
    number_of_bins: int

    def __getitem__(self, key: str) -> DistributionValue:
        return self.values[key]

    def argmax(self) -> str:
        # reference: metrics/HistogramMetric.scala argmax — key of max absolute
        max_count = max(v.absolute for v in self.values.values())
        for k, v in self.values.items():
            if v.absolute == max_count:
                return k
        raise ValueError("empty distribution")


@dataclass(frozen=True)
class HistogramMetric(Metric[Distribution]):
    """Flatten emits Histogram.bins, Histogram.abs.<v>, Histogram.ratio.<v>
    (reference: metrics/HistogramMetric.scala:37-60)."""

    def flatten(self) -> Sequence[DoubleMetric]:
        if not self.value.is_success:
            return [DoubleMetric(self.entity, self.name, self.instance, self.value)]
        dist = self.value.get()
        result: List[DoubleMetric] = [
            DoubleMetric(
                self.entity,
                f"{self.name}.bins",
                self.instance,
                Success(float(dist.number_of_bins)),
            )
        ]
        for k, v in dist.values.items():
            result.append(
                DoubleMetric(
                    self.entity,
                    f"{self.name}.abs.{k}",
                    self.instance,
                    Success(float(v.absolute)),
                )
            )
            result.append(
                DoubleMetric(
                    self.entity,
                    f"{self.name}.ratio.{k}",
                    self.instance,
                    Success(v.ratio),
                )
            )
        return result


def metric_from_value(
    value: float, name: str, instance: str, entity: Entity
) -> DoubleMetric:
    return DoubleMetric(entity, name, instance, Success(value))


def metric_from_failure(
    exception: BaseException, name: str, instance: str, entity: Entity
) -> DoubleMetric:
    return DoubleMetric(entity, name, instance, Failure(exception))
