from deequ_tpu_torch.profiles.column_profile import (
    ColumnProfile,
    ColumnProfiles,
    NumericColumnProfile,
    StandardColumnProfile,
)
from deequ_tpu_torch.profiles.column_profiler import ColumnProfiler
from deequ_tpu_torch.profiles.runner import ColumnProfilerRunner

__all__ = [
    "ColumnProfile",
    "ColumnProfiles",
    "NumericColumnProfile",
    "StandardColumnProfile",
    "ColumnProfiler",
    "ColumnProfilerRunner",
]
