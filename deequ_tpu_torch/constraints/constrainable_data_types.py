"""reference: constraints/ConstrainableDataTypes.scala:19."""

import enum


class ConstrainableDataTypes(enum.Enum):
    NULL = "Null"
    FRACTIONAL = "Fractional"
    INTEGRAL = "Integral"
    BOOLEAN = "Boolean"
    STRING = "String"
    NUMERIC = "Numeric"
