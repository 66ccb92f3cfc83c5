"""Typed metric-calculation failures.

Reference: analyzers/runners/MetricCalculationException.scala:19-78.
Failure messages are part of the framework contract (they surface inside
failed metrics and constraint results), so the texts mirror the reference.
"""

from __future__ import annotations


class MetricCalculationException(Exception):
    pass


class MetricCalculationRuntimeException(MetricCalculationException):
    pass


class NoSuchColumnException(MetricCalculationRuntimeException):
    pass


class WrongColumnTypeException(MetricCalculationRuntimeException):
    pass


class NoColumnsSpecifiedException(MetricCalculationRuntimeException):
    pass


class NumberOfSpecifiedColumnsException(MetricCalculationRuntimeException):
    pass


class IllegalAnalyzerParameterException(MetricCalculationRuntimeException):
    pass


class EmptyStateException(MetricCalculationRuntimeException):
    pass


def wrap_if_necessary(exception: BaseException) -> MetricCalculationException:
    """reference: MetricCalculationException.scala wrapIfNecessary."""
    if isinstance(exception, MetricCalculationException):
        return exception
    wrapped = MetricCalculationRuntimeException(str(exception))
    wrapped.__cause__ = exception
    return wrapped
