from deequ_tpu_torch.constraints.constrainable_data_types import ConstrainableDataTypes
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
    "ConstrainableDataTypes",
    "Constraint",
    "ConstraintDecorator",
    "ConstraintResult",
    "ConstraintStatus",
    "NamedConstraint",
]
