"""Column profile model + JSON export.

reference: profiles/ColumnProfile.scala:24-147.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from deequ_tpu_torch.core.metrics import Distribution


@dataclass
class ColumnProfile:
    column: str
    completeness: float
    approximate_num_distinct_values: int
    data_type: str
    is_data_type_inferred: bool
    type_counts: Dict[str, int] = field(default_factory=dict)
    histogram: Optional[Distribution] = None


@dataclass
class StandardColumnProfile(ColumnProfile):
    pass


@dataclass
class NumericColumnProfile(ColumnProfile):
    mean: Optional[float] = None
    maximum: Optional[float] = None
    minimum: Optional[float] = None
    sum: Optional[float] = None
    std_dev: Optional[float] = None
    approx_percentiles: Optional[List[float]] = None


@dataclass
class ColumnProfiles:
    profiles: Dict[str, ColumnProfile]
    num_records: int

    def to_json(self) -> str:
        """reference: ColumnProfiles.toJson (ColumnProfile.scala:66+)."""
        columns = []
        for profile in self.profiles.values():
            entry: Dict[str, object] = {
                "column": profile.column,
                "dataType": profile.data_type,
                "isDataTypeInferred": str(profile.is_data_type_inferred).lower(),
                "completeness": profile.completeness,
                "approximateNumDistinctValues": profile.approximate_num_distinct_values,
            }
            if profile.type_counts:
                entry["typeCounts"] = dict(profile.type_counts)
            if profile.histogram is not None:
                entry["histogram"] = [
                    {
                        "value": value,
                        "count": dv.absolute,
                        "ratio": dv.ratio,
                    }
                    for value, dv in profile.histogram.values.items()
                ]
            if isinstance(profile, NumericColumnProfile):
                for key, value in [
                    ("mean", profile.mean),
                    ("maximum", profile.maximum),
                    ("minimum", profile.minimum),
                    ("sum", profile.sum),
                    ("stdDev", profile.std_dev),
                ]:
                    if value is not None:
                        entry[key] = value
                if profile.approx_percentiles:
                    entry["approxPercentiles"] = list(profile.approx_percentiles)
            columns.append(entry)
        return json.dumps({"columns": columns}, indent=2)
