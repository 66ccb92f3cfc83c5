"""AnomalyDetector: time-series preprocessing around a strategy.

reference: anomalydetection/AnomalyDetector.scala:29-102,
anomalydetection/HistoryUtils.scala:24-48. The JAX counterpart is
deequ_tpu/anomaly/detector.py.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from deequ_tpu_torch.anomaly.base import AnomalyDetectionStrategy, DetectionResult

_LONG_MAX = (1 << 63) - 1
_LONG_MIN = -(1 << 63)


@dataclass
class DataPoint:
    time: int
    metric_value: Optional[float]


@dataclass
class AnomalyDetector:
    strategy: AnomalyDetectionStrategy

    def is_new_point_anomalous(
        self,
        historical_data_points: Sequence[DataPoint],
        new_point,
    ) -> DetectionResult:
        """reference: AnomalyDetector.scala:39-66. `new_point` may be a
        DataPoint or a bare value (then stamped after the newest history
        time, as the repository-backed check closure needs)."""
        if not historical_data_points:
            raise ValueError("historicalDataPoints must not be empty!")

        sorted_points = sorted(historical_data_points, key=lambda p: p.time)
        first_time = sorted_points[0].time
        last_time = sorted_points[-1].time

        if not isinstance(new_point, DataPoint):
            new_point = DataPoint(last_time + 1, float(new_point))

        if last_time >= new_point.time:
            raise ValueError(
                "Can't decide which range to use for anomaly detection. New "
                f"data point with time {new_point.time} is in history range "
                f"({first_time} - {last_time})!"
            )

        all_points = list(sorted_points) + [new_point]
        anomalies = self.detect_anomalies_in_history(
            all_points, (new_point.time, _LONG_MAX)
        ).anomalies
        return DetectionResult(anomalies)

    def detect_anomalies_in_history(
        self,
        data_series: Sequence[DataPoint],
        search_interval: Tuple[int, int] = (_LONG_MIN, _LONG_MAX),
    ) -> DetectionResult:
        """reference: AnomalyDetector.scala:68-102: drop missing values,
        sort by time, binary-search the time bounds into index bounds,
        delegate to the strategy, map indices back to timestamps."""
        search_start, search_end = search_interval
        if search_start > search_end:
            raise ValueError(
                "The first interval element has to be smaller or equal to the last."
            )
        present = [p for p in data_series if p.metric_value is not None]
        sorted_series = sorted(present, key=lambda p: p.time)
        timestamps = [p.time for p in sorted_series]

        lower = bisect.bisect_left(timestamps, search_start)
        upper = bisect.bisect_left(timestamps, search_end)

        values = [p.metric_value for p in sorted_series]
        anomalies = self.strategy.detect(values, (lower, upper))
        return DetectionResult(
            [(timestamps[index], anomaly) for index, anomaly in anomalies]
        )
