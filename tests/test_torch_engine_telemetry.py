"""Engine telemetry end-to-end.

Covers the fleet-telemetry loop: a traced suite run flattens into an
`engine.*` metric record (rows/s, per-phase seconds, wire bytes, peak
RSS from /proc, predicted-vs-observed drift), persists as a time series
through the ordinary `MetricsRepository`, renders as OpenMetrics
exposition text, and feeds the regression sentinel — which must flag
exactly a synthetically injected 30% throughput drop and exit nonzero.

Also here: the `_sanitize_tag_column` collision regression test and
loader filter coverage (`after`/`before`/`with_tag_values`) over
interleaved engine + data-quality result keys, including a filesystem
round trip.

Port-mapped from tests/test_engine_telemetry.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import importlib.util
import io
import json
import os
import re

from deequ_tpu_torch.analyzers import Mean, Minimum, Size, StandardDeviation
from deequ_tpu_torch.core.maybe import Success
from deequ_tpu_torch.core.metrics import DoubleMetric, Entity
from deequ_tpu_torch.observe import telemetry
from deequ_tpu_torch.repository import (
    FileSystemMetricsRepository,
    InMemoryMetricsRepository,
    ResultKey,
)
from deequ_tpu_torch.repository import engine as engine_repo
from deequ_tpu_torch.repository.base import AnalysisResult, _sanitize_tag_column
from deequ_tpu_torch.repository.serde import (
    deserialize_analyzer,
    serialize_analyzer,
)
from deequ_tpu_torch.runners import AnalysisRunner
from deequ_tpu_torch.runners.context import AnalyzerContext

from torch_fixtures import get_df_with_numeric_values
import pytest

pytestmark = pytest.mark.usefixtures("cpu_default")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _traced_context():
    return (
        AnalysisRunner.on_data(get_df_with_numeric_values())
        .with_tracing(True)
        .add_analyzers([Size(), Mean("att1"), StandardDeviation("att2"), Minimum("att1")])
        .run()
    )


def _data_context(value=5.0):
    analyzer = Size()
    metric = DoubleMetric(Entity.DATASET, "Size", "*", Success(float(value)))
    return AnalyzerContext({analyzer: metric})


# ---------------------------------------------------------------------------
# /proc resources (satellite: no psutil)
# ---------------------------------------------------------------------------


class TestProcResources:
    def test_reports_peak_rss_and_major_faults(self):
        res = telemetry.proc_resources()
        assert res["peak_rss_mb"] > 0.0
        assert res["major_faults"] >= 0.0

    def test_traced_run_stamps_resources_on_root_span(self):
        ctx = _traced_context()
        attrs = ctx.run_trace.root.attrs
        assert attrs["peak_rss_mb"] > 0.0
        assert attrs["major_faults"] >= 0


# ---------------------------------------------------------------------------
# flat engine metric record from a traced run
# ---------------------------------------------------------------------------


class TestEngineMetricRecord:
    def test_record_shape_from_traced_run(self):
        ctx = _traced_context()
        rec = telemetry.engine_metric_record(ctx.run_trace, ctx.plan_cost)

        assert all(k.startswith("engine.") for k in rec)
        assert all(isinstance(v, float) for v in rec.values())
        assert rec["engine.wall_s"] > 0.0
        assert rec["engine.cpu_s"] >= 0.0
        assert rec["engine.rows"] == 6.0
        assert rec["engine.batches"] >= 1.0
        assert rec["engine.rows_per_s"] > 0.0
        assert rec["engine.peak_rss_mb"] > 0.0
        assert rec["engine.major_faults"] >= 0.0
        # the four dispatch-report phases are always present
        for phase in ("plan", "dispatch", "transfer", "merge"):
            assert f"engine.phase.{phase}_s" in rec

    def test_drift_is_zero_when_plan_matches_trace(self):
        # PR4's differential pins dispatch_signature equality between
        # PlanCost and the trace, so every drift field must be 0.
        ctx = _traced_context()
        rec = telemetry.engine_metric_record(ctx.run_trace, ctx.plan_cost)
        drift = {k: v for k, v in rec.items() if k.startswith("engine.drift.")}
        assert drift, "no drift fields computed despite a PlanCost"
        assert all(v == 0.0 for v in drift.values()), drift

    def test_wire_bytes_summed_from_dispatch_spans(self, monkeypatch):
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
        ctx = _traced_context()
        rec = telemetry.engine_metric_record(ctx.run_trace)
        assert rec.get("engine.wire_bytes", 0.0) > 0.0

    def test_extra_keys_are_prefixed(self):
        ctx = _traced_context()
        rec = telemetry.engine_metric_record(
            ctx.run_trace, extra={"round": 3.0, "engine.custom": 1.5}
        )
        assert rec["engine.round"] == 3.0
        assert rec["engine.custom"] == 1.5


# ---------------------------------------------------------------------------
# repository persistence: EngineMetric pseudo-analyzer + record_run
# ---------------------------------------------------------------------------


class TestEnginePersistence:
    def test_engine_metric_serde_round_trip(self):
        analyzer = engine_repo.EngineMetric("engine.rows_per_s", "engine")
        back = deserialize_analyzer(serialize_analyzer(analyzer))
        assert back == analyzer
        assert back.metric == "engine.rows_per_s"
        assert back.instance == "engine"

    def test_record_run_round_trip_in_memory(self):
        ctx = _traced_context()
        repo = InMemoryMetricsRepository()
        key = engine_repo.record_run(
            repo, ctx.run_trace, ctx.plan_cost,
            suite="nightly", dataset="numeric", data_set_date=1111,
        )
        assert key.data_set_date == 1111
        assert key.tags["telemetry"] == "engine"
        assert key.tags["suite"] == "nightly"
        assert key.tags["dataset"] == "numeric"
        assert "host" in key.tags and "placement" in key.tags

        series = engine_repo.engine_series(repo, "engine.rows_per_s")
        assert [p.time for p in series] == [1111]
        assert series[0].metric_value > 0.0
        names = engine_repo.engine_metric_names(repo)
        assert "engine.wall_s" in names and "engine.rows" in names

    def test_engine_series_survives_fs_round_trip(self, tmp_path):
        ctx = _traced_context()
        path = str(tmp_path / "engine.json")
        repo = FileSystemMetricsRepository(path)
        for date in (300, 100, 200):
            engine_repo.record_run(
                repo, ctx.run_trace, ctx.plan_cost,
                suite="s", dataset="d", data_set_date=date,
            )
        # fresh instance: forces deserialization from disk
        reloaded = FileSystemMetricsRepository(path)
        series = engine_repo.engine_series(reloaded, "engine.wall_s")
        assert [p.time for p in series] == [100, 200, 300]
        assert all(p.metric_value > 0.0 for p in series)

    def test_persist_skips_non_numeric_values(self):
        repo = InMemoryMetricsRepository()
        key = engine_repo.engine_result_key(1, suite="s", dataset="d")
        engine_repo.persist_engine_record(
            repo, {"engine.ok": 2.0, "engine.bad": "nan-string-not-a-number"}, key
        )
        names = engine_repo.engine_metric_names(repo)
        assert names == ["engine.ok"]


# ---------------------------------------------------------------------------
# satellite: _sanitize_tag_column collision fix
# ---------------------------------------------------------------------------


class TestSanitizeTagColumn:
    def test_collision_suffixes_are_distinct(self):
        # old code returned "a_b_2" for BOTH the second and third
        # colliding tag, silently overwriting a column
        row = {"a_b": 1}
        second = _sanitize_tag_column("a.b", row)
        assert second == "a_b_2"
        row[second] = 2
        third = _sanitize_tag_column("a@b", row)
        assert third == "a_b_3"

    def test_no_collision_passes_through(self):
        assert _sanitize_tag_column("region", {"value": 1}) == "region"
        assert _sanitize_tag_column("data set", {}) == "data_set"

    def test_three_colliding_tags_yield_three_columns(self):
        key = ResultKey(7, {"a b": "x", "a.b": "y", "a@b": "z"})
        rows = AnalysisResult(key, _data_context()).get_success_metrics_as_rows()
        assert len(rows) == 1
        row = rows[0]
        assert row["a_b"] == "x"
        assert row["a_b_2"] == "y"
        assert row["a_b_3"] == "z"
        assert row["dataset_date"] == 7


# ---------------------------------------------------------------------------
# satellite: loader filters over interleaved engine + data result keys
# ---------------------------------------------------------------------------


def _interleaved_repo(repo):
    """Data results at 100/300, engine records at 200/400."""
    for date in (100, 300):
        repo.save(ResultKey(date, {"kind": "data", "region": "eu"}), _data_context(date))
    for date in (200, 400):
        key = engine_repo.engine_result_key(date, suite="nightly", dataset="numeric")
        engine_repo.persist_engine_record(
            repo, {"engine.rows_per_s": float(date)}, key
        )
    return repo


class TestInterleavedLoaderFilters:
    def _check(self, repo):
        def dates(loader):
            return sorted(r.result_key.data_set_date for r in loader.get())

        assert dates(repo.load()) == [100, 200, 300, 400]
        assert dates(repo.load().after(150)) == [200, 300, 400]
        assert dates(repo.load().before(250)) == [100, 200]
        assert dates(repo.load().after(150).before(350)) == [200, 300]
        assert dates(repo.load().with_tag_values({"telemetry": "engine"})) == [200, 400]
        assert dates(repo.load().with_tag_values({"kind": "data"})) == [100, 300]
        assert dates(
            repo.load().after(250).with_tag_values({"telemetry": "engine"})
        ) == [400]
        # engine pseudo-analyzers coexist with data analyzers per-result
        engine_rows = repo.load().with_tag_values({"telemetry": "engine"}).get()
        for result in engine_rows:
            assert all(
                isinstance(a, engine_repo.EngineMetric)
                for a in result.analyzer_context.metric_map
            )

    def test_in_memory(self):
        self._check(_interleaved_repo(InMemoryMetricsRepository()))

    def test_fs_round_trip(self, tmp_path):
        path = str(tmp_path / "mixed.json")
        _interleaved_repo(FileSystemMetricsRepository(path))
        self._check(FileSystemMetricsRepository(path))


# ---------------------------------------------------------------------------
# OpenMetrics exposition (satellite: grammar-validated in tier 1)
# ---------------------------------------------------------------------------

_TYPE_RE = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) gauge$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"  # family name
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\\\|\\\"|\\n)*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\\\|\\\"|\\n)*\")*\})?"
    r" (-?\d+(\.\d+)?([eE][+-]?\d+)?)$"
)


def _validate_openmetrics(text):
    """Minimal exposition-grammar validator: returns {family: [samples]}.

    Enforces: newline-terminated, `# EOF` last line, every sample
    preceded by its family's TYPE line, no duplicate (family, labelset).
    """
    assert text.endswith("\n")
    lines = text.splitlines()
    assert lines[-1] == "# EOF"
    typed = set()
    seen = set()
    families = {}
    for line in lines[:-1]:
        m = _TYPE_RE.match(line)
        if m:
            assert m.group(1) not in typed, f"duplicate TYPE for {m.group(1)}"
            typed.add(m.group(1))
            continue
        m = _SAMPLE_RE.match(line)
        assert m, f"line fails exposition grammar: {line!r}"
        family, labels = m.group(1), m.group(2) or ""
        assert family in typed, f"sample before TYPE line: {line!r}"
        assert (family, labels) not in seen, f"duplicate label set: {line!r}"
        seen.add((family, labels))
        families.setdefault(family, []).append(line)
    return families


class TestOpenMetrics:
    def test_engine_and_data_results_validate(self):
        repo = _interleaved_repo(InMemoryMetricsRepository())
        text = telemetry.openmetrics_text(repo.load().get())
        families = _validate_openmetrics(text)
        assert "deequ_tpu_engine_rows_per_s" in families
        assert "deequ_tpu_metric" in families
        # data family labelled by metric/instance/entity
        assert any(
            'metric="Size"' in line for line in families["deequ_tpu_metric"]
        )

    def test_latest_point_per_tag_set_wins(self):
        repo = InMemoryMetricsRepository()
        tags = {"telemetry": "engine", "suite": "s"}
        for date, value in ((1, 10.0), (2, 99.0)):
            engine_repo.persist_engine_record(
                repo, {"engine.rows_per_s": value}, ResultKey(date, dict(tags))
            )
        text = telemetry.openmetrics_text(repo.load().get())
        _validate_openmetrics(text)
        assert "99.0" in text
        assert "10.0" not in text

    def test_label_values_are_escaped(self):
        repo = InMemoryMetricsRepository()
        nasty = 'we"ird\\path\nline'
        engine_repo.persist_engine_record(
            repo,
            {"engine.rows_per_s": 5.0},
            ResultKey(1, {"telemetry": "engine", "source": nasty}),
        )
        text = telemetry.openmetrics_text(repo.load().get())
        _validate_openmetrics(text)
        assert 'source="we\\"ird\\\\path\\nline"' in text

    def test_failed_and_non_finite_metrics_are_skipped(self):
        repo = InMemoryMetricsRepository()
        engine_repo.persist_engine_record(
            repo,
            {"engine.ok": 1.0, "engine.inf": float("inf"), "engine.nan": float("nan")},
            ResultKey(1, {"telemetry": "engine"}),
        )
        text = telemetry.openmetrics_text(repo.load().get())
        families = _validate_openmetrics(text)
        assert "deequ_tpu_engine_ok" in families
        assert "deequ_tpu_engine_inf" not in families
        assert "deequ_tpu_engine_nan" not in families


# ---------------------------------------------------------------------------
# regression sentinel (tentpole: injected 30% drop flags exactly once)
# ---------------------------------------------------------------------------


def _sentinel_module():
    spec = importlib.util.spec_from_file_location(
        "repo_sentinel", os.path.join(REPO, "tools", "torch_sentinel.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: stable ~100 rows/s with small deterministic jitter, then a 30% drop
FLAT_HISTORY = [100.0, 101.0, 99.0, 100.5, 100.0, 99.5, 101.0, 100.0, 100.2]
DROP_VALUE = 70.0
DROP_TIME = 10


def _series_repo(path, inject_drop):
    repo = FileSystemMetricsRepository(path)
    values = list(FLAT_HISTORY) + ([DROP_VALUE] if inject_drop else [])
    for t, value in enumerate(values, start=1):
        key = engine_repo.engine_result_key(t, suite="bench", dataset="stream")
        engine_repo.persist_engine_record(
            repo, {"engine.rows_per_s": value, "engine.wall_s": 1.0}, key
        )
    return path


class TestSentinel:
    def test_detects_exactly_the_injected_drop(self, tmp_path):
        sentinel = _sentinel_module()
        path = _series_repo(str(tmp_path / "engine.json"), inject_drop=True)
        points = engine_repo.engine_series(
            FileSystemMetricsRepository(path), "engine.rows_per_s"
        )
        findings = sentinel.detect_regressions(points, direction="down", max_drop=0.2)
        assert [f["time"] for f in findings] == [DROP_TIME]
        assert findings[0]["value"] == DROP_VALUE
        assert "RateOfChange" in findings[0]["strategies"]

    def test_clean_history_passes(self, tmp_path):
        sentinel = _sentinel_module()
        path = _series_repo(str(tmp_path / "engine.json"), inject_drop=False)
        points = engine_repo.engine_series(
            FileSystemMetricsRepository(path), "engine.rows_per_s"
        )
        assert sentinel.detect_regressions(points, direction="down") == []

    def test_run_sentinel_exits_nonzero_on_regression(self, tmp_path):
        sentinel = _sentinel_module()
        path = _series_repo(str(tmp_path / "engine.json"), inject_drop=True)
        out = io.StringIO()
        rc = sentinel.run_sentinel(
            path, str(tmp_path / "no-bench-*.json"), out=out
        )
        text = out.getvalue()
        assert rc == 1
        assert "REGRESSION" in text
        assert "verdict: REGRESSION" in text
        assert f"t={DROP_TIME}" in text

    def test_run_sentinel_ok_on_clean_history(self, tmp_path):
        sentinel = _sentinel_module()
        path = _series_repo(str(tmp_path / "engine.json"), inject_drop=False)
        out = io.StringIO()
        rc = sentinel.run_sentinel(path, str(tmp_path / "no-bench-*.json"), out=out)
        assert rc == 0
        assert "verdict: ok" in out.getvalue()

    def test_main_cli_on_injected_drop(self, tmp_path, capsys):
        sentinel = _sentinel_module()
        path = _series_repo(str(tmp_path / "engine.json"), inject_drop=True)
        rc = sentinel.main(
            ["--repo", path, "--bench", str(tmp_path / "none-*.json")]
        )
        assert rc == 1
        assert "REGRESSION" in capsys.readouterr().out

    def test_not_enough_history_is_ok(self, tmp_path):
        sentinel = _sentinel_module()
        out = io.StringIO()
        rc = sentinel.run_sentinel(
            str(tmp_path / "absent.json"), str(tmp_path / "none-*.json"), out=out
        )
        assert rc == 0
        assert "not enough engine history" in out.getvalue()

    def test_constant_series_is_not_flagged(self, tmp_path):
        # zero-variance series are routine engine telemetry (identical
        # peak RSS every run); a one-sided OnlineNormal must not flag
        # them (regression: inf * 0 = nan used to poison the bounds)
        sentinel = _sentinel_module()
        path = str(tmp_path / "engine.json")
        repo = FileSystemMetricsRepository(path)
        for t in range(1, 11):
            engine_repo.persist_engine_record(
                repo,
                {
                    "engine.rows_per_s": 100.0,
                    "engine.wall_s": 1.0,
                    "engine.peak_rss_mb": 250.0,
                    "engine.phase.dispatch_s": 0.25,
                },
                engine_repo.engine_result_key(t, suite="s", dataset="d"),
            )
        out = io.StringIO()
        rc = sentinel.run_sentinel(path, str(tmp_path / "none-*.json"), out=out)
        assert rc == 0, out.getvalue()
        assert "verdict: ok" in out.getvalue()

    def test_bench_series_skips_unparsed_rounds_and_sorts(self, tmp_path):
        sentinel = _sentinel_module()
        rounds = [
            ("BENCH_r03.json", {"n": 3, "parsed": {"value": 120.0}}),
            ("BENCH_r01.json", {"n": 1, "parsed": None}),
            ("BENCH_r02.json", {"n": 2, "parsed": {"value": 100.0}}),
        ]
        for name, payload in rounds:
            (tmp_path / name).write_text(json.dumps(payload))
        points = sentinel._bench_series(str(tmp_path / "BENCH_r0*.json"))
        assert [(p.time, p.metric_value) for p in points] == [(2, 100.0), (3, 120.0)]

    def test_phase_share_regression_flags(self, tmp_path):
        # a phase eating a growing share of wall time is an "up" regression
        sentinel = _sentinel_module()
        path = str(tmp_path / "engine.json")
        repo = FileSystemMetricsRepository(path)
        shares = [0.10, 0.11, 0.10, 0.09, 0.10, 0.11, 0.10, 0.10, 0.10, 0.40]
        for t, share in enumerate(shares, start=1):
            key = engine_repo.engine_result_key(t, suite="s", dataset="d")
            engine_repo.persist_engine_record(
                repo,
                {
                    "engine.rows_per_s": 100.0,
                    "engine.wall_s": 2.0,
                    "engine.phase.dispatch_s": 2.0 * share,
                },
                key,
            )
        out = io.StringIO()
        rc = sentinel.run_sentinel(path, str(tmp_path / "none-*.json"), out=out)
        text = out.getvalue()
        assert rc == 1
        assert "engine.phase_share.dispatch" in text
        assert "t=10" in text


# ---------------------------------------------------------------------------
# end-to-end: traced run -> repository -> sentinel
# ---------------------------------------------------------------------------


class TestEndToEnd:
    def test_traced_suite_run_feeds_the_sentinel(self, tmp_path):
        sentinel = _sentinel_module()
        path = str(tmp_path / "engine.json")
        repo = FileSystemMetricsRepository(path)
        ctx = _traced_context()
        # 9 healthy synthetic points anchored on the real run's record,
        # then the real record scaled to a 30% throughput collapse
        rec = telemetry.engine_metric_record(ctx.run_trace, ctx.plan_cost)
        base = rec["engine.rows_per_s"]
        for t, jitter in enumerate(FLAT_HISTORY, start=1):
            engine_repo.persist_engine_record(
                repo,
                {"engine.rows_per_s": base * (jitter / 100.0), "engine.wall_s": rec["engine.wall_s"]},
                engine_repo.engine_result_key(t, suite="e2e", dataset="numeric"),
            )
        dropped = dict(rec)
        dropped["engine.rows_per_s"] = base * 0.70
        engine_repo.persist_engine_record(
            repo, dropped,
            engine_repo.engine_result_key(DROP_TIME, suite="e2e", dataset="numeric"),
        )
        out = io.StringIO()
        rc = sentinel.run_sentinel(path, str(tmp_path / "none-*.json"), out=out)
        text = out.getvalue()
        assert rc == 1
        assert "engine.rows_per_s" in text
        assert f"REGRESSION at t={DROP_TIME}" in text
