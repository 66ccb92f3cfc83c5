from deequ_tpu_torch.constraints.constraint import (
    AnalysisBasedConstraint,
    Constraint,
    ConstraintDecorator,
    ConstraintResult,
    ConstraintStatus,
    NamedConstraint,
)

__all__ = [
    "AnalysisBasedConstraint",
    "Constraint",
    "ConstraintDecorator",
    "ConstraintResult",
    "ConstraintStatus",
    "NamedConstraint",
]
