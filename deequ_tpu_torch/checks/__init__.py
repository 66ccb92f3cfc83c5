from deequ_tpu_torch.checks.check import Check, CheckLevel, CheckResult, CheckStatus

__all__ = ["Check", "CheckLevel", "CheckResult", "CheckStatus"]
