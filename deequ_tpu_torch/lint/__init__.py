"""Static analysis of a plan. The port has the schema model
(lint/schema.py) and the row-group statistics records (lint/pushdown.py)
so far; the rest of the JAX package's deequ_tpu/lint comes with the
platform services."""

from deequ_tpu_torch.lint.schema import FieldInfo, SchemaInfo

__all__ = ["FieldInfo", "SchemaInfo"]
