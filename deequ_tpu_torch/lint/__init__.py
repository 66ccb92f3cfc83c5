"""Static analysis of a plan. The port has the schema model so far
(lint/schema.py); the rest of the JAX package's deequ_tpu/lint comes with
the platform services."""

from deequ_tpu_torch.lint.schema import FieldInfo, SchemaInfo

__all__ = ["FieldInfo", "SchemaInfo"]
