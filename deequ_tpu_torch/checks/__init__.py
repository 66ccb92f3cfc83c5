from deequ_tpu_torch.checks.check import (
    Check,
    CheckLevel,
    CheckResult,
    CheckStatus,
    CheckWithLastConstraintFilterable,
)

__all__ = ["Check", "CheckLevel", "CheckResult", "CheckStatus", "CheckWithLastConstraintFilterable"]
