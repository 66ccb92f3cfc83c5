"""Anomaly-detection data model.

reference: anomalydetection/AnomalyDetectionStrategy.scala:20-27,
anomalydetection/DetectionResult.scala:19-56 (equality ignores detail).
The JAX counterpart is deequ_tpu/anomaly/base.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


@dataclass
class Anomaly:
    value: Optional[float]
    confidence: float
    detail: Optional[str] = None

    def __eq__(self, other) -> bool:
        # reference: equality ignores detail (DetectionResult.scala:19-56)
        return (
            isinstance(other, Anomaly)
            and self.value == other.value
            and self.confidence == other.confidence
        )

    def __hash__(self) -> int:
        return hash((self.value, self.confidence))


@dataclass
class DetectionResult:
    anomalies: List[Tuple[int, Anomaly]] = field(default_factory=list)


class AnomalyDetectionStrategy:
    def detect(
        self, data_series: Sequence[float], search_interval: Tuple[int, int]
    ) -> List[Tuple[int, Anomaly]]:
        """Indices of anomalies in [a, b) and their wrapper objects."""
        raise NotImplementedError
