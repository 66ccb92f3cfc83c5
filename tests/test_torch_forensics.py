"""Failure forensics: row-level violation capture,
metric provenance, and the persistent audit trail.

Contracts pinned here:

* every FAILURE-status row-level-capable constraint yields >= 1 sampled
  violating row, and every sample's (partition, row group, row index,
  value) coordinates verify against an independent numpy mirror of the
  written data;
* the reservoir is deterministic (content-derived seed, the
  `sketch._batch_seed` trick): reruns sample identical rows;
* the report round-trips through the FileSystem metrics repository as a
  versioned binary envelope — corrupt, truncated, or version-bumped
  entries warn DQ317 and degrade to no-forensics, never a wrong answer —
  including under concurrent writers;
* EXPLAIN predicts forensics capability statically (DQ316 fall-offs);
* forensics is off by default and the off path returns None.

Port-mapped from tests/test_forensics.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import base64
import struct
import threading

import numpy as np
import pytest

from deequ_tpu_torch.checks.check import Check, CheckLevel, CheckStatus
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.observe.forensics import ForensicsReport
from deequ_tpu_torch.repository.audit import (
    AUDIT_FORMAT_VERSION,
    AUDIT_MAGIC,
    AuditDecodeError,
    AuditRecord,
    audit_entry_for,
    decode_audit,
    encode_audit,
    load_audit_trail,
)
from deequ_tpu_torch.repository.base import ResultKey
from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository
from deequ_tpu_torch.verification.suite import VerificationSuite

pytestmark = pytest.mark.usefixtures("cpu_default")

ROW_GROUP = 100


def _partition_arrays(part: int, n: int = 400):
    """Deterministic per-partition columns with known violations."""
    rng = np.random.default_rng(1000 + part)
    ids = (np.arange(n) + part * n).astype(np.int64)
    val = rng.uniform(10.0, 90.0, n)
    name = np.array([f"n{i}" for i in range(n)], dtype=object)
    code = np.array(["ABC"] * n, dtype=object)
    if part != 1:
        # completeness violations
        name[[3, 155, 311]] = None
        # min violations (negative) + max violations (> 1000)
        val[[7, 250]] = [-5.0 - part, -1.0]
        val[[380]] = 5000.0 + part
        # pattern violations (lowercase) and a null (null is NOT a
        # pattern violation — the mask requires a present value)
        code[[42, 199]] = ["xyz", "nope"]
        code[[60]] = None
    return {"id": ids, "val": val, "name": name, "code": code}


def _write_dataset(tmp_path, parts=3):
    data_dir = tmp_path / "dataset"
    data_dir.mkdir(exist_ok=True)
    arrays = {}
    for p in range(parts):
        cols = _partition_arrays(p)
        arrays[f"part-{p}.parquet"] = cols
        Table.from_pydict(dict(cols)).to_parquet(
            str(data_dir / f"part-{p}.parquet"), row_group_size=ROW_GROUP
        )
    return str(data_dir), arrays


def _checks():
    return (
        Check(CheckLevel.ERROR, "forensics e2e")
        .is_complete("name")
        .has_min("val", lambda v: v >= 0.0)
        .has_max("val", lambda v: v <= 1000.0)
        .satisfies("val < 100", "val bounded", lambda r: r >= 1.0)
        .has_pattern("code", r"^[A-Z]{3}$")
    )


def _run(data_dir, **kwargs):
    data = Table.scan_parquet_dataset(data_dir)
    builder = VerificationSuite.on_data(data).add_check(_checks())
    builder = builder.with_forensics()
    for key, value in kwargs.items():
        builder = getattr(builder, key)(*value)
    return builder.run()


def _mirror_violations(arrays, kind):
    """Independent numpy mirror: {(partition, row_group, row_in_group)}
    -> expected offending value(s), per forensics family."""
    out = {}
    for part_name, cols in arrays.items():
        val, name, code = cols["val"], cols["name"], cols["code"]
        if kind == "completeness":
            rows = [i for i, v in enumerate(name) if v is None]
            values = {i: {"name": None} for i in rows}
        elif kind == "minimum":
            rows = [i for i in range(len(val)) if not (val[i] >= 0.0)]
            values = {i: {"val": float(val[i])} for i in rows}
        elif kind == "maximum":
            rows = [i for i in range(len(val)) if not (val[i] <= 1000.0)]
            values = {i: {"val": float(val[i])} for i in rows}
        elif kind == "compliance":
            rows = [i for i in range(len(val)) if not (val[i] < 100.0)]
            values = {i: {"val": float(val[i])} for i in rows}
        elif kind == "pattern":
            rows = [
                i
                for i, c in enumerate(code)
                if c is not None and not (len(c) == 3 and c.isupper())
            ]
            values = {i: {"code": str(code[i])} for i in rows}
        else:  # pragma: no cover - test bug
            raise AssertionError(kind)
        for i in rows:
            out[(part_name, i // ROW_GROUP, i % ROW_GROUP)] = values[i]
    return out


def test_failure_samples_verify_against_numpy_mirror(tmp_path):
    data_dir, arrays = _write_dataset(tmp_path)
    result = _run(data_dir)
    assert result.status == CheckStatus.ERROR
    report = result.forensics()
    assert report is not None

    by_kind = {c.kind: c for c in report.constraints}
    # every family in the plan was classified capable
    assert set(by_kind) == {
        "completeness", "minimum", "maximum", "compliance", "pattern",
    }
    assert report.falloffs == []

    for kind, entry in by_kind.items():
        mirror = _mirror_violations(arrays, kind)
        assert entry.status == ("SUCCESS" if not mirror else "FAILURE")
        if not mirror:
            assert entry.samples == []
            continue
        # acceptance: every FAILURE capable constraint sampled >= 1 row
        assert entry.samples, f"{kind}: no sampled violating rows"
        assert entry.capture_errors == 0
        for sample in entry.samples:
            coord = (sample.partition, sample.row_group, sample.row_index)
            assert coord in mirror, f"{kind}: {coord} is not a violation"
            assert sample.values == mirror[coord], f"{kind}: wrong values"
            assert sample.fingerprint  # partition fingerprint attached
        # the ratio families count exact violations over the scan
        if kind in ("completeness", "compliance", "pattern"):
            assert entry.violations_seen == len(mirror)


def test_reservoir_is_deterministic_and_bounded(tmp_path):
    data_dir, _ = _write_dataset(tmp_path)

    def coords(result):
        return {
            c.kind: [
                (s.partition, s.row_group, s.row_index, repr(s.values))
                for s in c.samples
            ]
            for c in result.forensics().constraints
        }

    first = coords(_run(data_dir))
    second = coords(_run(data_dir))
    assert first == second

    # a tighter cap stays deterministic and bounded
    data = Table.scan_parquet_dataset(data_dir)
    tight = (
        VerificationSuite.on_data(data)
        .add_check(_checks())
        .with_forensics(True, 2)
        .run()
    )
    for entry in tight.forensics().constraints:
        assert len(entry.samples) <= 2


def test_forensics_off_by_default(tmp_path):
    data_dir, _ = _write_dataset(tmp_path, parts=1)
    data = Table.scan_parquet_dataset(data_dir)
    result = VerificationSuite.on_data(data).add_check(_checks()).run()
    assert result.forensics() is None


def test_env_knob_enables_forensics(tmp_path, monkeypatch):
    data_dir, _ = _write_dataset(tmp_path, parts=1)
    monkeypatch.setenv("DEEQU_TPU_FORENSICS", "1")
    data = Table.scan_parquet_dataset(data_dir)
    result = VerificationSuite.on_data(data).add_check(_checks()).run()
    assert result.forensics() is not None
    # explicit False wins over the env knob
    data = Table.scan_parquet_dataset(data_dir)
    result = (
        VerificationSuite.on_data(data)
        .add_check(_checks())
        .with_forensics(False)
        .run()
    )
    assert result.forensics() is None


def test_provenance_names_cached_vs_scanned_partitions(tmp_path):
    from deequ_tpu_torch.repository.states import FileSystemStateRepository

    data_dir, _ = _write_dataset(tmp_path)
    repo = FileSystemStateRepository(str(tmp_path / "states"))

    def run():
        data = Table.scan_parquet_dataset(data_dir)
        return (
            VerificationSuite.on_data(data)
            .add_check(_checks())
            .with_forensics()
            .with_state_repository(repo, "forensics")
            .run()
        )

    cold = run().forensics()
    assert [p["mode"] for p in cold.provenance["partitions"]] == ["scan"] * 3
    assert cold.provenance["planSignature"]
    assert cold.provenance["rowGroupsScanned"] > 0

    warm = run().forensics()
    assert [p["mode"] for p in warm.provenance["partitions"]] == ["cache"] * 3
    assert warm.provenance["planSignature"] == cold.provenance["planSignature"]
    # cached partitions contribute provenance, not samples
    for entry in warm.constraints:
        assert entry.samples == []
    # same fingerprints either way, in the same partition order
    assert [p["fingerprint"] for p in warm.provenance["partitions"]] == [
        p["fingerprint"] for p in cold.provenance["partitions"]
    ]


def test_render_names_rows_partitions_and_plan(tmp_path):
    data_dir, _ = _write_dataset(tmp_path)
    report = _run(data_dir).forensics()
    text = report.render()
    assert "failure forensics" in text
    assert "part-0.parquet" in text
    assert "[FAILURE]" in text
    assert "partitions: 3 scanned, 0 merged from state cache (3 total)" in text
    # report rides render_report as the forensics section
    from deequ_tpu_torch import observe

    with observe.tracing() as tracer:
        with observe.span("x", cat="plan"):
            pass
    full = observe.render_report(tracer, forensics=report)
    assert "failure forensics" in full


# -- audit-trail envelope ----------------------------------------------------


def _report():
    return ForensicsReport(
        constraints=[],
        falloffs=[{"constraint": "c", "reason": "r"}],
        provenance={"planSignature": "abc", "partitions": []},
    )


def test_envelope_round_trip():
    payload = _report().to_dict()
    assert decode_audit(encode_audit(payload)) == payload


def test_envelope_rejects_bit_flips():
    blob = bytearray(encode_audit(_report().to_dict()))
    for pos in (0, 5, len(blob) // 2, len(blob) - 1):
        flipped = bytearray(blob)
        flipped[pos] ^= 0x40
        with pytest.raises(AuditDecodeError):
            decode_audit(bytes(flipped))


def test_envelope_rejects_truncation():
    blob = encode_audit(_report().to_dict())
    for keep in (0, 3, 11, len(blob) // 2, len(blob) - 1):
        with pytest.raises(AuditDecodeError):
            decode_audit(blob[:keep])


def test_envelope_rejects_version_bump_with_valid_digest():
    import hashlib

    blob = encode_audit(_report().to_dict())
    body = bytearray(blob[:-32])
    struct.pack_into(">I", body, len(AUDIT_MAGIC), AUDIT_FORMAT_VERSION + 1)
    bumped = bytes(body) + hashlib.sha256(bytes(body)).digest()
    with pytest.raises(AuditDecodeError, match="format version"):
        decode_audit(bumped)


def test_audit_round_trips_through_fs_repository(tmp_path):
    data_dir, _ = _write_dataset(tmp_path)
    repo = FileSystemMetricsRepository(str(tmp_path / "metrics"))
    key = ResultKey(20260805, {"suite": "forensics"})
    result = _run(
        data_dir, use_repository=(repo,), save_or_append_result=(key,)
    )
    report = result.forensics()
    loaded = load_audit_trail(repo, key)
    assert loaded is not None
    assert loaded.to_dict() == report.to_dict()
    # the ordinary metrics for the run were saved alongside the trail
    context = repo.load_by_key(key)
    assert any(
        getattr(a, "name", None) != "ForensicsAudit"
        for a in context.metric_map
    )


def _save_corrupted(repo, key, mutate):
    """Persist a run context whose audit payload is `mutate`d."""
    report = _report()
    record, _ = audit_entry_for(report)
    blob = bytearray(base64.b64decode(record.payload))
    payload = mutate(blob)
    bad = AuditRecord(base64.b64encode(bytes(payload)).decode("ascii"))
    from deequ_tpu_torch.runners.context import AnalyzerContext

    repo.save(key, AnalyzerContext({bad: bad.to_metric()}))


def test_unusable_audit_entries_warn_dq317_and_degrade(tmp_path):
    repo = FileSystemMetricsRepository(str(tmp_path / "metrics"))
    cases = {
        "flip": lambda b: bytes(b[:40]) + bytes([b[40] ^ 0x01]) + bytes(b[41:]),
        "truncate": lambda b: bytes(b[: len(b) // 2]),
        "empty": lambda b: b"",
    }
    for i, (label, mutate) in enumerate(cases.items()):
        key = ResultKey(i, {"case": label})
        _save_corrupted(repo, key, mutate)
        with pytest.warns(RuntimeWarning, match="DQ317"):
            assert load_audit_trail(repo, key) is None


def test_missing_trail_is_none_without_warning(tmp_path):
    repo = FileSystemMetricsRepository(str(tmp_path / "metrics"))
    assert load_audit_trail(repo, ResultKey(1, {})) is None


def test_audit_trail_under_concurrent_writers(tmp_path):
    """Writer threads racing on one FileSystemMetricsRepository file,
    with concurrent readers. The repository's whole-history
    read-modify-write can LOSE a racing entry (last atomic publish
    wins) but must never TEAR one: every trail that is present loads
    back intact under its own key — the envelope digest guarantees a
    decoded trail is exactly what its writer persisted — and readers
    never see a torn file or a wrong-key payload."""
    from deequ_tpu_torch.runners.context import AnalyzerContext

    repo = FileSystemMetricsRepository(str(tmp_path / "metrics"))
    n = 16
    barrier = threading.Barrier(n + 1)
    errors = []
    stop = threading.Event()

    def write(i):
        report = ForensicsReport(
            constraints=[],
            falloffs=[],
            provenance={"planSignature": f"sig-{i}", "partitions": []},
        )
        record, metric = audit_entry_for(report)
        barrier.wait()
        try:
            repo.save(
                ResultKey(i, {"w": str(i)}),
                AnalyzerContext({record: metric}),
            )
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    def read():
        barrier.wait()
        while not stop.is_set():
            for i in range(n):
                try:
                    loaded = load_audit_trail(repo, ResultKey(i, {"w": str(i)}))
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                    return
                if loaded is not None:
                    sig = loaded.provenance.get("planSignature")
                    if sig != f"sig-{i}":
                        errors.append(AssertionError(f"key {i} read {sig}"))
                        return

    threads = [threading.Thread(target=write, args=(i,)) for i in range(n)]
    reader = threading.Thread(target=read)
    for t in threads:
        t.start()
    reader.start()
    for t in threads:
        t.join()
    stop.set()
    reader.join()
    assert errors == []
    survived = 0
    for i in range(n):
        loaded = load_audit_trail(repo, ResultKey(i, {"w": str(i)}))
        if loaded is not None:
            assert loaded.provenance["planSignature"] == f"sig-{i}"
            survived += 1
    # the last publish always lands whole
    assert survived >= 1


# -- EXPLAIN prediction ------------------------------------------------------


def test_explain_predicts_capability_and_dq316_falloffs(tmp_path):
    data_dir, _ = _write_dataset(tmp_path, parts=1)
    data = Table.scan_parquet_dataset(data_dir)
    check = (
        Check(CheckLevel.ERROR, "predict")
        .is_complete("name")
        .is_unique("id")  # uniqueness is grouped: no per-row identity
    )
    explained = VerificationSuite.on_data(data).add_check(check).explain()
    assert any(code == "DQ316" for code in _diag_codes(explained))
    assert len(explained.forensics_capable) == 1
    assert "Completeness" in explained.forensics_capable[0][0]
    assert len(explained.forensics_falloffs) == 1
    text = str(explained)
    assert "failure forensics" in text
    assert "DQ316" in text


def _diag_codes(explained):
    return [d.code for d in explained.diagnostics]
