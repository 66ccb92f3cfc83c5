"""What the drivers share: the program's resolved settings, and its
results turned into plain numbers that the references can judge."""

from __future__ import annotations

import json


def program_settings(ctx) -> dict:
    """The settings the port resolved for this run: users run the defaults."""
    import os

    from deequ_tpu_torch.ops import runtime
    from deequ_tpu_torch.runners.engine import resolve_engine

    import torch

    device = torch.device(ctx.device)
    mesh = resolve_engine("auto", num_rows=getattr(ctx.data, "rows", None), device=device)
    return {
        "placement_mode": runtime.placement_mode(device),
        "decode_workers": runtime.decode_workers(),
        "pipeline_depth": runtime.pipeline_depth(),
        "engine": "single" if mesh is None else f"mesh of {len(mesh.devices)}",
        "compute_dtype": str(runtime.compute_dtype()),
        "knobs": {k: v for k, v in sorted(os.environ.items()) if k.startswith("DEEQU_TPU_")},
    }


def metric_key(metric) -> str:
    return f"{metric.name}({metric.instance})"


def metric_value(metric):
    if not metric.value.is_success:
        return None
    value = metric.value.get()
    if isinstance(value, dict):
        return {str(k): float(v) for k, v in value.items()}
    return float(value)


def result_numbers(result) -> dict:
    """A VerificationResult's or AnalyzerContext's metrics by
    `Name(instance)`, and a verification's constraint statuses by
    `status[i]`, numbered over its checks and their constraints in order."""
    metric_map = result.metrics if hasattr(result, "check_results") else result.metric_map
    out = {metric_key(m): metric_value(m) for m in metric_map.values()}
    results = getattr(result, "check_results", {}).values()
    statuses = [c.status.value for r in results for c in r.constraint_results]
    out.update((f"status[{i}]", status) for i, status in enumerate(statuses))
    return out


def profile_numbers(profiles) -> dict:
    """A ColumnProfiles' fields by `<column>.<field>`, histograms as
    {value: count}."""
    out = {"num_records": float(profiles.num_records)}
    for entry in json.loads(profiles.to_json())["columns"]:
        column = entry["column"]
        for key, value in entry.items():
            if key in ("column", "isDataTypeInferred"):
                continue
            if key == "histogram":
                value = {h["value"]: h["count"] for h in value}
            out[f"{column}.{key}"] = value
    return out
