"""The harness on the CPU at tiny sizes: the last line's shape, the
references against the program, the module check, and cells, traffic
mixes and metrics found by name."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_helpers import CELLS, TINY, tiny_run

from benchmark import core

ROOT = core.ROOT


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct_and_shaped(cell, tmp_path):
    result = tiny_run(cell, tmp_path)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"  # the numbers compared come last
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    entry = core.resolve(cell)
    assert set(result["metrics"]) == {m["name"] for m in entry.end_to_end}
    for metric in result["metrics"].values():
        assert metric["value"] > 0 and isinstance(metric["unit"], str)
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]
    json.dumps(result)  # one JSON line


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_span_metrics(cell, tmp_path):
    result = tiny_run(cell, tmp_path, trace=True)
    assert result["correct"] is True
    span_metrics = {m["name"] for m in core.resolve(cell).per_layer
                    if m["source"] == "program_span"}
    assert span_metrics <= set(result["metrics"])  # device metrics need the card


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("jaxtyping", "deequ_tpu_torch", "deequ_tpu_torch.ops", "jaxlib_like"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not set(core.forbidden_modules()) & {"jaxtyping", "deequ_tpu_torch", "jaxlib_like"}
    monkeypatch.setitem(sys.modules, "deequ_tpu.ops.fused", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert core.forbidden_modules() == ["deequ_tpu", "jax"]


def test_forbidden_module_fails_the_run(tmp_path, monkeypatch, capsys):
    """A module of the JAX stack loaded by the time the result is due:
    exit 3, nothing on standard output, the module named on standard error."""
    from benchmark import run

    result = tiny_run("lineitem.scan", tmp_path)
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "flax", object())
    assert run.report(result) == 3
    out, err = capsys.readouterr()
    assert out == "" and "flax" in err


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload",
         "lineitem.scan", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_json_names_files_that_exist():
    bench = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for config in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, config["file"]))
        generator = core.load_json(os.path.join(ROOT, config["file"]))["generator"]
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "gen", f"{generator}.py"))
    for cell in bench["workloads"]:
        resolved = core.resolve(cell["name"])
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "drivers",
                                           f"{resolved.traffic['driver']}.py"))
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "reference",
                                           f"{cell['traffic']}.py"))
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", f"{metric['name']}.py"))


def test_new_traffic_and_metric_are_found_by_name(tmp_path):
    """A copy of the tree takes a new traffic mix (data file and its
    reference) and a new per-layer metric as new files plus entries in
    BENCHMARK.json, with no other edit."""
    tree = tmp_path / "tree"
    shutil.copytree(os.path.join(ROOT, "benchmark"), tree / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    bench_dir = str(tree / "benchmark")
    traffic = core.load_json(os.path.join(bench_dir, "traffic", "scan.json"))
    traffic["analyzers"] = [{"kind": "size"}, {"kind": "mean", "columns": ["l_tax"]}]
    (tree / "benchmark" / "traffic" / "scan_small.json").write_text(json.dumps(traffic))
    (tree / "benchmark" / "reference" / "scan_small.py").write_text(
        "from benchmark.reference.scan import *  # noqa: F401,F403\n"
        "from benchmark.reference.scan import judge, control  # noqa: F401\n")
    (tree / "benchmark" / "metrics" / "requests.scan.py").write_text(
        "def read(run):\n    return float(len(run.done))\n")
    bench["workloads"].append({"name": "lineitem.scan_small", "config": "tpch_lineitem_sf1",
                               "traffic": "scan_small", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "requests.scan", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "harness", "moves": "rows_per_s",
                               "workloads": ["lineitem.scan_small"]})
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + ["lineitem.scan_small"])
                           if "lineitem.scan" in m.get("workloads", []) else m
                           for m in bench["end_to_end"]]
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    TINY["lineitem.scan_small"] = TINY["lineitem.scan"]
    try:
        result = tiny_run("lineitem.scan_small", tmp_path / "work", bench_dir=bench_dir,
                          trace=True)
    finally:
        del TINY["lineitem.scan_small"]
    assert result["correct"] is True
    assert result["metrics"]["requests.scan"]["value"] == result["attempted"]
    assert set(result["checks"]) == {"missing", "exact_mismatch", "moment_rel_err",
                                     "failed_requests"}


def test_launch_log_records_every_kernel_call(tmp_path):
    """The traced run's launch sizes: the wrappers keep the kernels'
    launch counters and record each call's rows and value width."""
    from benchmark.trace import LaunchLog

    with LaunchLog().installed() as log:
        result = tiny_run("lineitem.profile", tmp_path)
    assert result["correct"] is True and result["failed"] == 0
    kernels = {name for name, *_ in log.sizes()}
    assert {"masked_moments", "masked_centered_sumsq", "hll_register_max", "hist16"} <= kernels
    assert all(rows >= live >= 0 and width in (1, 4, 8) for _, rows, width, live in log.sizes())
