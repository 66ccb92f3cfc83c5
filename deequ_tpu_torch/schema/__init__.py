from deequ_tpu_torch.schema.row_level_schema_validator import (
    RowLevelSchema,
    RowLevelSchemaValidationResult,
    RowLevelSchemaValidator,
)

__all__ = [
    "RowLevelSchema",
    "RowLevelSchemaValidationResult",
    "RowLevelSchemaValidator",
]
