"""Anomaly detection over a metric's history in a metrics repository
(reference: anomalydetection/). The JAX counterpart is
deequ_tpu/anomaly/."""

from deequ_tpu_torch.anomaly.base import (
    Anomaly,
    AnomalyDetectionStrategy,
    DetectionResult,
)
from deequ_tpu_torch.anomaly.detector import AnomalyDetector, DataPoint
from deequ_tpu_torch.anomaly.strategies import (
    BatchNormalStrategy,
    OnlineNormalStrategy,
    RateOfChangeStrategy,
    SimpleThresholdStrategy,
)
from deequ_tpu_torch.anomaly.holt_winters import HoltWinters, MetricInterval, SeriesSeasonality

__all__ = [
    "Anomaly",
    "AnomalyDetectionStrategy",
    "DetectionResult",
    "AnomalyDetector",
    "DataPoint",
    "SimpleThresholdStrategy",
    "RateOfChangeStrategy",
    "OnlineNormalStrategy",
    "BatchNormalStrategy",
    "HoltWinters",
    "MetricInterval",
    "SeriesSeasonality",
]
