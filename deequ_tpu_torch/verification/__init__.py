from deequ_tpu_torch.verification.result import VerificationResult
from deequ_tpu_torch.verification.suite import VerificationSuite

__all__ = ["VerificationResult", "VerificationSuite"]
