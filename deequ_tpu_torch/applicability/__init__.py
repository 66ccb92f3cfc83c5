from deequ_tpu_torch.applicability.applicability import (
    Applicability,
    AnalyzersApplicability,
    CheckApplicability,
    generate_random_data,
)

__all__ = [
    "Applicability",
    "AnalyzersApplicability",
    "CheckApplicability",
    "generate_random_data",
]
