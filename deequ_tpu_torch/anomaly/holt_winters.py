"""Holt-Winters seasonal anomaly detection: additive triple exponential
smoothing ETS(A,A).

reference: anomalydetection/seasonal/HoltWinters.scala:60-249. The
smoothing recursion runs in torch, float64, on the strategy's device
(CUDA unless the caller passes ``device="cpu"``), and the (alpha, beta,
gamma) fit minimizes the residual sum of squares with scipy's L-BFGS-B
over [0,1]^3 on exact gradients from autograd, where the reference
needed breeze's ApproximateGradientFunction.

The JAX counterpart (deequ_tpu/anomaly/holt_winters.py) runs the
recursion as two `jax.lax.scan`s under `jax.jit`. Here every step is a
handful of ops on 0-d tensors, so on the card one objective evaluation
is a chain of small launches: the season buffer is a ring of 0-d tensors
indexed by step, never a concatenation per step. The JAX float32 branch
(for engines without float64) has no counterpart: the port's compute
dtype is always float64 (ops/runtime.compute_dtype).
"""

from __future__ import annotations

import enum
from typing import List, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch.anomaly.base import Anomaly, AnomalyDetectionStrategy
from deequ_tpu_torch.ops import runtime


class MetricInterval(enum.Enum):
    DAILY = "Daily"
    MONTHLY = "Monthly"


class SeriesSeasonality(enum.Enum):
    WEEKLY = "Weekly"
    YEARLY = "Yearly"


def _holt_winters_fit(
    series: torch.Tensor, periodicity: int, num_forecasts: int, params: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the ETS(A,A) recursion; returns (forecasts, residuals), both on
    the series' device.

    reference: HoltWinters.scala:86-135 — initial level = mean of first
    period, initial trend = (mean2 - mean1)/periodicity, initial seasonal
    components = first period minus level. `season[t % periodicity]` is
    the component of step t, and step t's update replaces it."""
    alpha, beta, gamma = params[0], params[1], params[2]
    first = series[:periodicity].mean()
    second = series[periodicity : 2 * periodicity].mean()
    level = first
    trend = (second - first) / periodicity
    season = list((series[:periodicity] - level).unbind())

    fitted = []
    for t, y_t in enumerate(series.unbind()):
        slot = t % periodicity
        s_t = season[slot]
        fitted.append(level + trend + s_t)
        new_level = alpha * (y_t - s_t) + (1 - alpha) * (level + trend)
        new_trend = beta * (new_level - level) + (1 - beta) * trend
        season[slot] = gamma * (y_t - level - trend) + (1 - gamma) * s_t
        level, trend = new_level, new_trend
    residuals = series - torch.stack(fitted)

    # out-of-sample forecasts
    forecasts = []
    for t in range(len(fitted), len(fitted) + num_forecasts):
        slot = t % periodicity
        s_t = season[slot]
        y_hat = level + trend + s_t
        forecasts.append(y_hat)
        new_level = alpha * (y_hat - s_t) + (1 - alpha) * (level + trend)
        new_trend = beta * (new_level - level) + (1 - beta) * trend
        season[slot] = gamma * (y_hat - level - trend) + (1 - gamma) * s_t
        level, trend = new_level, new_trend
    return torch.stack(forecasts), residuals


class HoltWinters(AnomalyDetectionStrategy):
    """`device` is where the fit runs: CUDA unless the caller asks for
    the CPU. After `detect`, `evaluations` holds the number of objective
    evaluations the fit took and `params` the fitted (alpha, beta,
    gamma)."""

    def __init__(
        self,
        metrics_interval: MetricInterval,
        seasonality: SeriesSeasonality,
        device: runtime.DeviceLike = None,
    ):
        key = (seasonality, metrics_interval)
        periodicity = {
            (SeriesSeasonality.WEEKLY, MetricInterval.DAILY): 7,
            (SeriesSeasonality.YEARLY, MetricInterval.MONTHLY): 12,
        }.get(key)
        if periodicity is None:
            raise ValueError(
                f"Unsupported seasonality/interval combination: {key}"
            )
        self.series_periodicity = periodicity
        self.device = runtime.resolve_device(device)
        self.evaluations = 0
        self.params = None

    def _fit_params(self, series: torch.Tensor, num_forecasts: int) -> np.ndarray:
        """L-BFGS-B over RSS with exact autograd gradients
        (reference: HoltWinters.scala:138-174)."""
        from scipy.optimize import minimize

        evaluations = 0

        def objective(p: np.ndarray):
            nonlocal evaluations
            evaluations += 1
            params = torch.tensor(p, dtype=torch.float64, device=self.device, requires_grad=True)
            _, residuals = _holt_winters_fit(
                series, self.series_periodicity, num_forecasts, params
            )
            rss = torch.sum(residuals**2)
            (grad,) = torch.autograd.grad(rss, params)
            return float(rss.detach()), grad.cpu().numpy()

        result = minimize(
            objective,
            x0=np.array([0.3, 0.1, 0.1]),
            jac=True,
            method="L-BFGS-B",
            bounds=[(0.0, 1.0)] * 3,
        )
        self.evaluations = evaluations
        return result.x

    def detect(
        self, data_series: Sequence[float], search_interval: Tuple[int, int] = (0, 1 << 62)
    ) -> List[Tuple[int, Anomaly]]:
        if len(data_series) == 0:
            raise ValueError("Provided data series is empty")
        start, end = search_interval
        if start >= end:
            raise ValueError("Start must be before end")
        if start < 0 or end < 0:
            raise ValueError("The search interval needs to be strictly positive")
        if start < self.series_periodicity * 2:
            raise ValueError("Need at least two full cycles of data to estimate model")

        if start >= len(data_series):
            num_forecasts = 1
        else:
            num_forecasts = min(end, len(data_series)) - start

        training = torch.as_tensor(
            np.asarray(data_series[:start], dtype=np.float64), device=self.device
        )
        params = self._fit_params(training, num_forecasts)
        self.params = params

        with torch.no_grad():
            forecasts, residuals = _holt_winters_fit(
                training,
                self.series_periodicity,
                num_forecasts,
                torch.as_tensor(params, dtype=torch.float64, device=self.device),
            )
        forecasts = forecasts.cpu().numpy()
        # reference: stddev of |residuals| (HoltWinters.scala:236-237),
        # breeze stddev = sample stddev
        abs_residuals = np.abs(residuals.cpu().numpy())
        residual_sd = float(np.std(abs_residuals, ddof=1)) if len(abs_residuals) > 1 else 0.0

        test_series = np.asarray(data_series[start:], dtype=np.float64)
        out: List[Tuple[int, Anomaly]] = []
        for i in range(min(len(test_series), len(forecasts))):
            observed = float(test_series[i])
            forecasted = float(forecasts[i])
            if abs(observed - forecasted) > 1.96 * residual_sd:
                out.append(
                    (
                        i + start,
                        Anomaly(
                            observed,
                            1.0,
                            f"Forecasted {forecasted} for observed value {observed}",
                        ),
                    )
                )
        return out
