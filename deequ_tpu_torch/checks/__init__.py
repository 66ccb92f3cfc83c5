from deequ_tpu_torch.checks.check import (
    Check,
    CheckLevel,
    CheckResult,
    CheckStatus,
    CheckWithLastConstraintFilterable,
)
from deequ_tpu_torch.checks.drift import (
    DriftCheck,
    DriftCheckResult,
    DriftConstraint,
    DriftConstraintResult,
)

__all__ = [
    "Check",
    "CheckLevel",
    "CheckResult",
    "CheckStatus",
    "CheckWithLastConstraintFilterable",
    "DriftCheck",
    "DriftCheckResult",
    "DriftConstraint",
    "DriftConstraintResult",
]
