"""Fluent builder for verification runs.

reference: VerificationRunBuilder.scala:28-308.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Sequence

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.checks.check import Check
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.verification.result import VerificationResult
from deequ_tpu_torch.verification.suite import VerificationSuite

if TYPE_CHECKING:
    from deequ_tpu_torch.data.table import Table


class VerificationRunBuilder:
    def __init__(self, data: "Table", device: runtime.DeviceLike = None):
        self._data = data
        self._device = device
        self._checks: List[Check] = []
        self._required_analyzers: List[Analyzer] = []
        self._controller = None
        self._deadline_s: Optional[float] = None

    def with_controller(self, controller) -> "VerificationRunBuilder":
        """Attach a `RunController` (core/controller.py) whose `cancel()`
        any thread may call: the run raises `RunCancelled` at its next
        batch or partition boundary, after every stage thread joined."""
        self._controller = controller
        return self

    def with_deadline(self, seconds: float) -> "VerificationRunBuilder":
        """Bound the run's wall time: past `seconds` the next batch check
        raises `RunCancelled` (DQ402)."""
        self._deadline_s = float(seconds)
        return self

    def add_check(self, check: Check) -> "VerificationRunBuilder":
        self._checks.append(check)
        return self

    def add_checks(self, checks: Sequence[Check]) -> "VerificationRunBuilder":
        self._checks.extend(checks)
        return self

    def add_required_analyzer(self, analyzer: Analyzer) -> "VerificationRunBuilder":
        self._required_analyzers.append(analyzer)
        return self

    def add_required_analyzers(self, analyzers: Sequence[Analyzer]) -> "VerificationRunBuilder":
        self._required_analyzers.extend(analyzers)
        return self

    def run(self) -> VerificationResult:
        return VerificationSuite.do_verification_run(
            self._data,
            self._checks,
            self._required_analyzers,
            self._device,
            controller=self._controller,
            deadline_s=self._deadline_s,
        )
