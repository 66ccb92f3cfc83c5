"""Success/Failure result values.

Every metric carries its value as a ``Try``: computation failures are data,
not control flow (reference: metrics/Metric.scala:19-40 — `value: Try[T]`).
"""

from __future__ import annotations

from typing import Callable, Generic, TypeVar

T = TypeVar("T")
U = TypeVar("U")


class Try(Generic[T]):
    """Base of Success/Failure. Mirrors scala.util.Try semantics."""

    @property
    def is_success(self) -> bool:
        raise NotImplementedError

    @property
    def is_failure(self) -> bool:
        return not self.is_success

    def get(self) -> T:
        raise NotImplementedError

    def get_or_else(self, default: T) -> T:
        return self.get() if self.is_success else default

    def map(self, fn: Callable[[T], U]) -> "Try[U]":
        raise NotImplementedError

    def flat_map(self, fn: Callable[[T], "Try[U]"]) -> "Try[U]":
        raise NotImplementedError

    def recover(self, fn: Callable[[BaseException], T]) -> "Try[T]":
        raise NotImplementedError

    @staticmethod
    def of(fn: Callable[[], T]) -> "Try[T]":
        try:
            return Success(fn())
        except Exception as e:  # noqa: BLE001 - Try captures any exception
            return Failure(e)


class Success(Try[T]):
    __slots__ = ("value",)

    def __init__(self, value: T):
        self.value = value

    @property
    def is_success(self) -> bool:
        return True

    def get(self) -> T:
        return self.value

    def map(self, fn):
        return Try.of(lambda: fn(self.value))

    def flat_map(self, fn):
        try:
            return fn(self.value)
        except Exception as e:  # noqa: BLE001
            return Failure(e)

    def recover(self, fn):
        return self

    def __repr__(self):
        return f"Success({self.value!r})"

    def __eq__(self, other):
        return isinstance(other, Success) and self.value == other.value

    def __hash__(self):
        return hash(("Success", self.value))


class Failure(Try[T]):
    __slots__ = ("exception",)

    def __init__(self, exception: BaseException):
        self.exception = exception

    @property
    def is_success(self) -> bool:
        return False

    def get(self) -> T:
        raise self.exception

    def map(self, fn):
        return self

    def flat_map(self, fn):
        return self

    def recover(self, fn):
        return Try.of(lambda: fn(self.exception))

    def __repr__(self):
        return f"Failure({self.exception!r})"

    def __eq__(self, other):
        # failures compare by exception class + message (the contract the
        # reference's AssertionUtils tests: utils/AssertionUtils.scala)
        return (
            isinstance(other, Failure)
            and type(self.exception) is type(other.exception)
            and str(self.exception) == str(other.exception)
        )

    def __hash__(self):
        return hash(("Failure", type(self.exception).__name__, str(self.exception)))
