"""JSON (de)serialization of analysis results — format-compatible with the
reference's Gson serializers.

reference: repository/AnalysisResultSerde.scala:38-614. Field names, the
per-analyzer dispatch on `analyzerName`, metric serialization by
`metricName`, and the refusal to serialize failed metrics / binning-udf
histograms all mirror the reference so JSON written by either
implementation loads in the other.

Documented deviation: a non-finite DoubleMetric value (NaN/Inf) is stored
as JSON null here so the history file stays RFC-8259 parseable, whereas
the reference's Gson would throw when *writing* such a value and throws on
JsonNull when *reading* — i.e. histories containing non-finite metrics are
writable only by this implementation and loadable only by it.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    ApproxQuantiles,
    Completeness,
    Compliance,
    Correlation,
    CountDistinct,
    DataType,
    Distinctness,
    Entropy,
    Histogram,
    Maximum,
    Mean,
    Minimum,
    MutualInformation,
    PatternMatch,
    Size,
    StandardDeviation,
    Sum,
    UniqueValueRatio,
    Uniqueness,
)
from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.core.maybe import Success
from deequ_tpu_torch.core.metrics import (
    Distribution,
    DistributionValue,
    DoubleMetric,
    Entity,
    HistogramMetric,
    KeyedDoubleMetric,
    Metric,
)
from deequ_tpu_torch.repository.base import AnalysisResult, ResultKey
from deequ_tpu_torch.runners.context import AnalyzerContext

ANALYZER_FIELD = "analyzer"
ANALYZER_NAME_FIELD = "analyzerName"
WHERE_FIELD = "where"
COLUMN_FIELD = "column"
COLUMNS_FIELD = "columns"
METRIC_MAP_FIELD = "metricMap"
METRIC_FIELD = "metric"
DATASET_DATE_FIELD = "dataSetDate"
TAGS_FIELD = "tags"
RESULT_KEY_FIELD = "resultKey"
ANALYZER_CONTEXT_FIELD = "analyzerContext"


# ---------------------------------------------------------------------------
# Analyzer <-> json (reference: AnalysisResultSerde.scala:220-480)
# ---------------------------------------------------------------------------


def serialize_analyzer(analyzer: Analyzer) -> Dict[str, Any]:
    if isinstance(analyzer, Size):
        return {ANALYZER_NAME_FIELD: "Size", WHERE_FIELD: analyzer.where}
    if isinstance(analyzer, Completeness):
        return {
            ANALYZER_NAME_FIELD: "Completeness",
            COLUMN_FIELD: analyzer.column,
            WHERE_FIELD: analyzer.where,
        }
    if isinstance(analyzer, Compliance):
        return {
            ANALYZER_NAME_FIELD: "Compliance",
            WHERE_FIELD: analyzer.where,
            "instance": analyzer.instance_name,
            "predicate": analyzer.predicate,
        }
    if isinstance(analyzer, PatternMatch):
        return {
            ANALYZER_NAME_FIELD: "PatternMatch",
            COLUMN_FIELD: analyzer.column,
            WHERE_FIELD: analyzer.where,
            "pattern": analyzer.pattern,
        }
    if isinstance(analyzer, Sum):
        return {
            ANALYZER_NAME_FIELD: "Sum",
            COLUMN_FIELD: analyzer.column,
            WHERE_FIELD: analyzer.where,
        }
    if isinstance(analyzer, Mean):
        return {
            ANALYZER_NAME_FIELD: "Mean",
            COLUMN_FIELD: analyzer.column,
            WHERE_FIELD: analyzer.where,
        }
    if isinstance(analyzer, Minimum):
        return {
            ANALYZER_NAME_FIELD: "Minimum",
            COLUMN_FIELD: analyzer.column,
            WHERE_FIELD: analyzer.where,
        }
    if isinstance(analyzer, Maximum):
        return {
            ANALYZER_NAME_FIELD: "Maximum",
            COLUMN_FIELD: analyzer.column,
            WHERE_FIELD: analyzer.where,
        }
    if isinstance(analyzer, CountDistinct):
        return {ANALYZER_NAME_FIELD: "CountDistinct", COLUMNS_FIELD: list(analyzer.columns)}
    if isinstance(analyzer, Distinctness):
        return {ANALYZER_NAME_FIELD: "Distinctness", COLUMNS_FIELD: list(analyzer.columns)}
    if isinstance(analyzer, Entropy):
        return {ANALYZER_NAME_FIELD: "Entropy", COLUMN_FIELD: analyzer.columns[0]}
    if isinstance(analyzer, MutualInformation):
        return {
            ANALYZER_NAME_FIELD: "MutualInformation",
            COLUMNS_FIELD: list(analyzer.columns),
        }
    if isinstance(analyzer, UniqueValueRatio):
        return {
            ANALYZER_NAME_FIELD: "UniqueValueRatio",
            COLUMNS_FIELD: list(analyzer.columns),
        }
    if isinstance(analyzer, Uniqueness):
        return {ANALYZER_NAME_FIELD: "Uniqueness", COLUMNS_FIELD: list(analyzer.columns)}
    if isinstance(analyzer, Histogram):
        if analyzer.binning_udf is not None:
            # reference: AnalysisResultSerde.scala:300-306
            raise ValueError(f"Unable to serialize analyzer {analyzer!r}.")
        return {
            ANALYZER_NAME_FIELD: "Histogram",
            COLUMN_FIELD: analyzer.column,
            "maxDetailBins": analyzer.max_detail_bins,
        }
    if isinstance(analyzer, DataType):
        return {
            ANALYZER_NAME_FIELD: "DataType",
            COLUMN_FIELD: analyzer.column,
            WHERE_FIELD: analyzer.where,
        }
    if isinstance(analyzer, ApproxCountDistinct):
        return {
            ANALYZER_NAME_FIELD: "ApproxCountDistinct",
            COLUMN_FIELD: analyzer.column,
            WHERE_FIELD: analyzer.where,
        }
    if isinstance(analyzer, Correlation):
        return {
            ANALYZER_NAME_FIELD: "Correlation",
            "firstColumn": analyzer.first_column,
            "secondColumn": analyzer.second_column,
            WHERE_FIELD: analyzer.where,
        }
    if isinstance(analyzer, StandardDeviation):
        return {
            ANALYZER_NAME_FIELD: "StandardDeviation",
            COLUMN_FIELD: analyzer.column,
            WHERE_FIELD: analyzer.where,
        }
    if isinstance(analyzer, ApproxQuantile):
        data = {
            ANALYZER_NAME_FIELD: "ApproxQuantile",
            COLUMN_FIELD: analyzer.column,
            "quantile": analyzer.quantile,
            "relativeError": analyzer.relative_error,
        }
        if analyzer.where is not None:  # our extension field
            data[WHERE_FIELD] = analyzer.where
        return data
    if isinstance(analyzer, ApproxQuantiles):
        return {
            ANALYZER_NAME_FIELD: "ApproxQuantiles",
            COLUMN_FIELD: analyzer.column,
            "quantiles": ",".join(str(q) for q in analyzer.quantiles),
            "relativeError": analyzer.relative_error,
        }
    from deequ_tpu_torch.repository.engine import EngineMetric

    if isinstance(analyzer, EngineMetric):
        return {
            ANALYZER_NAME_FIELD: "EngineMetric",
            "metric": analyzer.metric,
            "instance": analyzer.instance,
        }
    from deequ_tpu_torch.repository.audit import AuditRecord

    if isinstance(analyzer, AuditRecord):
        return {
            ANALYZER_NAME_FIELD: "ForensicsAudit",
            "payload": analyzer.payload,
            "instance": analyzer.instance,
        }
    raise ValueError(f"Unable to serialize analyzer {analyzer!r}.")


def deserialize_analyzer(data: Dict[str, Any]) -> Analyzer:
    name = data[ANALYZER_NAME_FIELD]
    where = data.get(WHERE_FIELD)

    if name == "Size":
        return Size(where)
    if name == "Completeness":
        return Completeness(data[COLUMN_FIELD], where)
    if name == "Compliance":
        return Compliance(data["instance"], data["predicate"], where)
    if name == "PatternMatch":
        return PatternMatch(data[COLUMN_FIELD], data["pattern"], where)
    if name == "Sum":
        return Sum(data[COLUMN_FIELD], where)
    if name == "Mean":
        return Mean(data[COLUMN_FIELD], where)
    if name == "Minimum":
        return Minimum(data[COLUMN_FIELD], where)
    if name == "Maximum":
        return Maximum(data[COLUMN_FIELD], where)
    if name == "CountDistinct":
        return CountDistinct(data[COLUMNS_FIELD])
    if name == "Distinctness":
        return Distinctness(data[COLUMNS_FIELD])
    if name == "Entropy":
        return Entropy(data[COLUMN_FIELD])
    if name == "MutualInformation":
        return MutualInformation(data[COLUMNS_FIELD])
    if name == "UniqueValueRatio":
        return UniqueValueRatio(data[COLUMNS_FIELD])
    if name == "Uniqueness":
        return Uniqueness(data[COLUMNS_FIELD])
    if name == "Histogram":
        return Histogram(data[COLUMN_FIELD], None, data["maxDetailBins"])
    if name == "DataType":
        return DataType(data[COLUMN_FIELD], where)
    if name == "ApproxCountDistinct":
        return ApproxCountDistinct(data[COLUMN_FIELD], where)
    if name == "Correlation":
        return Correlation(data["firstColumn"], data["secondColumn"], where)
    if name == "StandardDeviation":
        return StandardDeviation(data[COLUMN_FIELD], where)
    if name == "ApproxQuantile":
        return ApproxQuantile(
            data[COLUMN_FIELD], data["quantile"], data["relativeError"], where
        )
    if name == "ApproxQuantiles":
        quantiles = [float(q) for q in data["quantiles"].split(",")]
        return ApproxQuantiles(data[COLUMN_FIELD], quantiles, data["relativeError"])
    if name == "EngineMetric":
        from deequ_tpu_torch.repository.engine import EngineMetric

        return EngineMetric(data["metric"], data.get("instance", "engine"))
    if name == "ForensicsAudit":
        from deequ_tpu_torch.repository.audit import AuditRecord

        return AuditRecord(data.get("payload", ""), data.get("instance", "forensics"))
    raise ValueError(f"Unable to deserialize analyzer {name}.")


# ---------------------------------------------------------------------------
# Metric <-> json (reference: AnalysisResultSerde.scala:477-570)
# ---------------------------------------------------------------------------


def serialize_metric(metric: Metric) -> Dict[str, Any]:
    import math

    if metric.value.is_failure:
        raise ValueError("Unable to serialize failed metrics.")
    if isinstance(metric, DoubleMetric):
        value = metric.value.get()
        # NaN/Inf are not RFC-8259 JSON (Gson would refuse them outright);
        # store null so the history file stays parseable everywhere
        if isinstance(value, float) and not math.isfinite(value):
            value = None
        return {
            "metricName": "DoubleMetric",
            "entity": metric.entity.value,
            "instance": metric.instance,
            "name": metric.name,
            "value": value,
        }
    if isinstance(metric, HistogramMetric):
        dist = metric.value.get()
        return {
            "metricName": "HistogramMetric",
            COLUMN_FIELD: metric.instance,
            "numberOfBins": dist.number_of_bins,
            "value": serialize_distribution(dist),
        }
    if isinstance(metric, KeyedDoubleMetric):
        return {
            "metricName": "KeyedDoubleMetric",
            "entity": metric.entity.value,
            "instance": metric.instance,
            "name": metric.name,
            "value": dict(metric.value.get()),
        }
    raise ValueError(f"Unable to serialize metrics {metric!r}.")


def deserialize_metric(data: Dict[str, Any]) -> Metric:
    name = data["metricName"]
    if name == "DoubleMetric":
        value = data["value"]
        return DoubleMetric(
            Entity(data["entity"]),
            data["name"],
            data["instance"],
            Success(float("nan") if value is None else value),
        )
    if name == "HistogramMetric":
        return HistogramMetric(
            Entity.COLUMN,
            "Histogram",
            data[COLUMN_FIELD],
            Success(deserialize_distribution(data["value"])),
        )
    if name == "KeyedDoubleMetric":
        return KeyedDoubleMetric(
            Entity(data["entity"]),
            data["name"],
            data["instance"],
            Success({k: float(v) for k, v in data["value"].items()}),
        )
    raise ValueError(f"Unable to deserialize metric {name}.")


def serialize_distribution(dist: Distribution) -> Dict[str, Any]:
    return {
        "numberOfBins": dist.number_of_bins,
        "values": {
            key: {"absolute": dv.absolute, "ratio": dv.ratio}
            for key, dv in dist.values.items()
        },
    }


def deserialize_distribution(data: Dict[str, Any]) -> Distribution:
    return Distribution(
        {
            key: DistributionValue(entry["absolute"], entry["ratio"])
            for key, entry in data["values"].items()
        },
        data["numberOfBins"],
    )


# ---------------------------------------------------------------------------
# AnalysisResult list <-> json (entry points,
# reference: AnalysisResultSerde.scala:75-106)
# ---------------------------------------------------------------------------


def serialize_result_key(key: ResultKey) -> Dict[str, Any]:
    return {DATASET_DATE_FIELD: key.data_set_date, TAGS_FIELD: dict(key.tags)}


def deserialize_result_key(data: Dict[str, Any]) -> ResultKey:
    return ResultKey(data[DATASET_DATE_FIELD], dict(data.get(TAGS_FIELD) or {}))


def serialize_analysis_results(results: List[AnalysisResult]) -> str:
    out = []
    for result in results:
        metric_map = []
        for analyzer, metric in result.analyzer_context.metric_map.items():
            try:
                entry = {
                    ANALYZER_FIELD: serialize_analyzer(analyzer),
                    METRIC_FIELD: serialize_metric(metric),
                }
            except ValueError:
                continue  # unserializable analyzer/failed metric skipped
            metric_map.append(entry)
        out.append(
            {
                RESULT_KEY_FIELD: serialize_result_key(result.result_key),
                ANALYZER_CONTEXT_FIELD: {METRIC_MAP_FIELD: metric_map},
            }
        )
    return json.dumps(out, indent=2)


def deserialize_analysis_results(payload: str) -> List[AnalysisResult]:
    results = []
    for entry in json.loads(payload):
        key = deserialize_result_key(entry[RESULT_KEY_FIELD])
        metric_map = {}
        for item in entry[ANALYZER_CONTEXT_FIELD][METRIC_MAP_FIELD]:
            analyzer = deserialize_analyzer(item[ANALYZER_FIELD])
            metric = deserialize_metric(item[METRIC_FIELD])
            metric_map[analyzer] = metric
        results.append(AnalysisResult(key, AnalyzerContext(metric_map)))
    return results


# SimpleResultSerde (reference: AnalysisResultSerde.scala:56-73)


def simple_serialize(success_data: List[Dict[str, Any]]) -> str:
    return json.dumps(success_data)


def simple_deserialize(payload: str) -> List[Dict[str, Any]]:
    return json.loads(payload)
