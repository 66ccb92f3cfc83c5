"""Non-seasonal anomaly-detection strategies — vectorized numpy.

reference: anomalydetection/SimpleThresholdStrategy.scala:25,
RateOfChangeStrategy.scala:35-104, OnlineNormalStrategy.scala:39-155,
BatchNormalStrategy.scala:33-95. Detail strings mirror the reference.
A copy of deequ_tpu/anomaly/strategies.py, which imports no JAX.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from deequ_tpu_torch.anomaly.base import Anomaly, AnomalyDetectionStrategy

# the reference uses Double.MinValue/MaxValue, NOT infinities — the
# distinction matters: a one-sided normal strategy multiplies the
# missing side's factor by the stddev, and `inf * 0.0` is nan (which
# poisons the bounds check and flags every point of a zero-variance
# series), while `MaxValue * 0.0` is 0.
_DBL_MIN = -sys.float_info.max
_DBL_MAX = sys.float_info.max


@dataclass
class SimpleThresholdStrategy(AnomalyDetectionStrategy):
    """Out-of-[lower, upper] bounds."""

    upper_bound: float
    lower_bound: float = _DBL_MIN

    def __post_init__(self):
        if self.lower_bound > self.upper_bound:
            raise ValueError(
                "The lower bound must be smaller or equal to the upper bound."
            )

    def detect(self, data_series, search_interval) -> List[Tuple[int, Anomaly]]:
        start, end = search_interval
        if start > end:
            raise ValueError("The start of the interval can't be larger than the end.")
        out = []
        for index in range(start, min(end, len(data_series))):
            value = data_series[index]
            if value < self.lower_bound or value > self.upper_bound:
                detail = (
                    f"[SimpleThresholdStrategy]: Value {value} is not in "
                    f"bounds [{self.lower_bound}, {self.upper_bound}]"
                )
                out.append((index, Anomaly(value, 1.0, detail)))
        return out


@dataclass
class RateOfChangeStrategy(AnomalyDetectionStrategy):
    """Order-k discrete differences out of bounds."""

    max_rate_decrease: Optional[float] = None
    max_rate_increase: Optional[float] = None
    order: int = 1

    def __post_init__(self):
        if self.max_rate_decrease is None and self.max_rate_increase is None:
            raise ValueError(
                "At least one of the two limits (maxRateDecrease or "
                "maxRateIncrease) has to be specified."
            )
        lower = self.max_rate_decrease if self.max_rate_decrease is not None else _DBL_MIN
        upper = self.max_rate_increase if self.max_rate_increase is not None else _DBL_MAX
        if lower > upper:
            raise ValueError(
                "The maximal rate of increase has to be bigger than the "
                "maximal rate of decrease."
            )
        if self.order < 0:
            raise ValueError("Order of derivative cannot be negative.")

    def detect(self, data_series, search_interval) -> List[Tuple[int, Anomaly]]:
        start, end = search_interval
        if start > end:
            raise ValueError("The start of the interval cannot be larger than the end.")
        lower = self.max_rate_decrease if self.max_rate_decrease is not None else _DBL_MIN
        upper = self.max_rate_increase if self.max_rate_increase is not None else _DBL_MAX

        start_point = max(start - self.order, 0)
        data = np.asarray(data_series[start_point : min(end, len(data_series))], dtype=float)
        diffed = np.diff(data, n=self.order) if len(data) else data
        out = []
        for i, change in enumerate(diffed):
            if change < lower or change > upper:
                index = i + start_point + self.order
                detail = (
                    f"[RateOfChangeStrategy]: Change of {change} is not in bounds ["
                    f"{lower}, {upper}]. Order={self.order}"
                )
                out.append((index, Anomaly(data_series[index], 1.0, detail)))
        return out


@dataclass
class OnlineNormalStrategy(AnomalyDetectionStrategy):
    """Streaming Welford mean/stddev, optionally excluding detected
    anomalies from the stats, with a warm-up fraction."""

    lower_deviation_factor: Optional[float] = 3.0
    upper_deviation_factor: Optional[float] = 3.0
    ignore_start_percentage: float = 0.1
    ignore_anomalies: bool = True

    def __post_init__(self):
        if self.lower_deviation_factor is None and self.upper_deviation_factor is None:
            raise ValueError("At least one factor has to be specified.")
        if (self.lower_deviation_factor or 1.0) < 0 or (
            self.upper_deviation_factor or 1.0
        ) < 0:
            raise ValueError("Factors cannot be smaller than zero.")
        if not (0.0 <= self.ignore_start_percentage <= 1.0):
            raise ValueError(
                "Percentage of start values to ignore must be in interval [0, 1]."
            )

    def compute_stats_and_anomalies(
        self, data_series, search_interval=(0, 1 << 62)
    ) -> List[Tuple[float, float, bool]]:
        """reference: OnlineNormalStrategy.scala:70-121 — returns
        (mean, stddev, is_anomaly) per point."""
        results: List[Tuple[float, float, bool]] = []
        current_mean = 0.0
        current_variance = 0.0
        sn = 0.0
        num_to_skip = len(data_series) * self.ignore_start_percentage
        search_start, search_end = search_interval
        upper_factor = (
            self.upper_deviation_factor
            if self.upper_deviation_factor is not None
            else _DBL_MAX
        )
        lower_factor = (
            self.lower_deviation_factor
            if self.lower_deviation_factor is not None
            else _DBL_MAX
        )

        for index, value in enumerate(data_series):
            last_mean, last_variance, last_sn = current_mean, current_variance, sn
            if index == 0:
                current_mean = value
            else:
                current_mean = last_mean + (1.0 / (index + 1)) * (value - last_mean)
            sn += (value - last_mean) * (value - current_mean)
            current_variance = sn / (index + 1)
            std_dev = math.sqrt(current_variance)

            upper_bound = current_mean + upper_factor * std_dev
            lower_bound = current_mean - lower_factor * std_dev

            if (
                index < num_to_skip
                or index < search_start
                or index >= search_end
                or (lower_bound <= value <= upper_bound)
            ):
                results.append((current_mean, std_dev, False))
            else:
                if self.ignore_anomalies:
                    current_mean, current_variance, sn = last_mean, last_variance, last_sn
                results.append((current_mean, std_dev, True))
        return results

    def detect(self, data_series, search_interval) -> List[Tuple[int, Anomaly]]:
        start, end = search_interval
        if start > end:
            raise ValueError("The start of the interval can't be larger than the end.")
        upper_factor = (
            self.upper_deviation_factor
            if self.upper_deviation_factor is not None
            else _DBL_MAX
        )
        lower_factor = (
            self.lower_deviation_factor
            if self.lower_deviation_factor is not None
            else _DBL_MAX
        )
        stats = self.compute_stats_and_anomalies(data_series, search_interval)
        out = []
        for index in range(start, min(end, len(data_series))):
            mean, std_dev, is_anomaly = stats[index]
            if is_anomaly:
                lower_bound = mean - lower_factor * std_dev
                upper_bound = mean + upper_factor * std_dev
                detail = (
                    f"[OnlineNormalStrategy]: Value {data_series[index]} is not in "
                    f"bounds [{lower_bound}, {upper_bound}]."
                )
                out.append((index, Anomaly(data_series[index], 1.0, detail)))
        return out


@dataclass
class BatchNormalStrategy(AnomalyDetectionStrategy):
    """mean ± k·stddev computed from points outside (or including) the
    search interval."""

    lower_deviation_factor: Optional[float] = 3.0
    upper_deviation_factor: Optional[float] = 3.0
    include_interval: bool = False

    def __post_init__(self):
        if self.lower_deviation_factor is None and self.upper_deviation_factor is None:
            raise ValueError("At least one factor has to be specified.")
        if (self.lower_deviation_factor or 1.0) < 0 or (
            self.upper_deviation_factor or 1.0
        ) < 0:
            raise ValueError("Factors cannot be smaller than zero.")

    def detect(self, data_series, search_interval) -> List[Tuple[int, Anomaly]]:
        start, end = search_interval
        if start > end:
            raise ValueError("The start of the interval can't be larger than the end.")
        if len(data_series) == 0:
            raise ValueError("Data series is empty. Can't calculate mean/ stdDev.")
        interval_length = end - start
        if not self.include_interval and interval_length >= len(data_series):
            raise ValueError(
                "Excluding values in searchInterval from calculation but not "
                "enough values remain to calculate mean and stdDev."
            )
        series = np.asarray(data_series, dtype=float)
        if self.include_interval:
            basis = series
        else:
            basis = np.concatenate([series[:start], series[min(end, len(series)):]])
        mean = float(np.mean(basis))
        # sample stddev like breeze's meanAndVariance
        std_dev = float(np.std(basis, ddof=1)) if len(basis) > 1 else 0.0

        upper_factor = (
            self.upper_deviation_factor
            if self.upper_deviation_factor is not None
            else _DBL_MAX
        )
        lower_factor = (
            self.lower_deviation_factor
            if self.lower_deviation_factor is not None
            else _DBL_MAX
        )
        upper_bound = mean + upper_factor * std_dev
        lower_bound = mean - lower_factor * std_dev

        out = []
        for index in range(start, min(end, len(series))):
            value = float(series[index])
            if value > upper_bound or value < lower_bound:
                detail = (
                    f"[BatchNormalStrategy]: Value {value} is not in "
                    f"bounds [{lower_bound}, {upper_bound}]."
                )
                out.append((index, Anomaly(value, 1.0, detail)))
        return out
