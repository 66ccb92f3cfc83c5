"""State files across the two packages: reference-named state-provider
directories, plan signatures, DQST envelopes, and a partition-state
repository that the JAX package filled serving a run of the port.

The JAX side is pinned to its device placement with its encoded fold off
(DEEQU_TPU_PLACEMENT=device, DEEQU_TPU_ENCODED_FOLD=0), where its plan
signature hashes what the port's CPU signature hashes, and to its plain
pyarrow route (torch_stream_helpers.plain_route). Tolerance: bytes and
signatures are equal; metrics served from the JAX package's states equal
the JAX run's bit for bit.
"""

from __future__ import annotations

import glob

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import deequ_tpu.analyzers as J
import deequ_tpu_torch.analyzers as P
from deequ_tpu.analyzers import state_provider as jsp
from deequ_tpu.analyzers.state_provider import FileSystemStateProvider as JProvider
from deequ_tpu.data.table import Table as JTable
from deequ_tpu.ops.fused import FusedScanPass as JPass
from deequ_tpu.repository import states as jstates
from deequ_tpu.runners.analysis_runner import AnalysisRunner as JRunner
from deequ_tpu_torch.analyzers.state_provider import FileSystemStateProvider as PProvider
from deequ_tpu_torch.analyzers.state_provider import serialize_state
from deequ_tpu_torch.data.table import Table as PTable
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.ops.fused import FusedScanPass as PPass
from deequ_tpu_torch.repository import states as pstates
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner as PRunner
from torch_stream_helpers import bits, plain_route

ANALYZERS = [
    ("Size", ()),
    ("Completeness", ("x",)),
    ("Minimum", ("x",)),
    ("Maximum", ("x",)),
    ("Mean", ("x",)),
    ("StandardDeviation", ("x",)),
    ("Correlation", ("x", "y")),
    ("ApproxCountDistinct", ("id",)),
    ("ApproxQuantile", ("x", 0.5)),
    ("DataType", ("s",)),
    ("Compliance", ("positive", "x > 0")),
]
ORDER_INSENSITIVE = [
    a for a in ANALYZERS if a[0] not in ("Mean", "StandardDeviation", "Correlation")
]


def _columns(rng, n):
    x = rng.normal(3.0, 2.0, n)
    x[::11] = np.nan
    return {
        "x": x,
        "y": 0.5 * x + rng.normal(0.0, 1.0, n),
        "id": rng.integers(0, 5 * n, n),
        "s": np.array([["1", "2.5", "w", None][i] for i in rng.integers(0, 4, n)], dtype=object),
    }


def _both(spec):
    return [getattr(J, n)(*a) for n, a in spec], [getattr(P, n)(*a) for n, a in spec]


@pytest.fixture
def pinned(monkeypatch):
    plain_route(monkeypatch)
    monkeypatch.delenv("DEEQU_TPU_STATE_CACHE", raising=False)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reference_named_provider_directory_loads_in_the_other(tmp_path, pinned, writer):
    """A run of one package saves its states through a reference-named
    provider; the other package's provider over the same prefix finds
    every file and reads the same bytes back."""
    rng = np.random.default_rng(1)
    cols = _columns(rng, 2000)
    janalyzers, panalyzers = _both(ANALYZERS)
    janalyzers += [J.Histogram("s"), J.CountDistinct(["id"])]
    panalyzers += [P.Histogram("s"), P.CountDistinct(["id"])]
    prefix = str(tmp_path / "states")
    jprov = JProvider(prefix, naming="reference")
    pprov = PProvider(prefix, naming="reference")
    if writer == "jax":
        JRunner.do_analysis_run(
            JTable.from_numpy(cols), janalyzers, save_states_with=jprov, engine="single"
        )
    else:
        PRunner.do_analysis_run(
            PTable.from_numpy(cols), panalyzers, save_states_with=pprov, device="cpu"
        )
    for ja, pa_ in zip(janalyzers, panalyzers):
        jstate, pstate = jprov.load(ja), pprov.load(pa_)
        assert jstate is not None and pstate is not None, repr(pa_)
        assert serialize_state(pa_, pstate) == jsp.serialize_state(ja, jstate), repr(pa_)


def test_plan_signature_equals_the_jax_package(pinned, tmp_path):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "p0.parquet")
    pq.write_table(pa.table(_columns(rng, 100)), path)
    janalyzers, panalyzers = _both(ANALYZERS)
    jsource = JTable.scan_parquet_dataset(str(tmp_path))
    psource = PTable.scan_parquet_dataset(str(tmp_path))
    jsig = jstates.plan_signature_for(janalyzers, jsource)
    assert pstates.plan_signature_for(panalyzers, psource, device="cpu") == jsig
    assert pstates.plan_signature_for(panalyzers, psource, batch_size=4096, device="cpu") == (
        jstates.plan_signature_for(janalyzers, jsource, batch_size=4096)
    )
    # the card's folds sum in another order: their states never mix
    cuda_sig = pstates.plan_signature(
        panalyzers,
        placement="device",
        compute_dtype="float64",
        batch_size=None,
        batch_rows=psource.batch_rows,
        variant=runtime.fold_variant(torch.device("cuda")),
    )
    assert runtime.fold_variant(torch.device("cuda")) == "cuda-folds"
    assert cuda_sig != jsig
    assert pstates.dtype_name(runtime.compute_dtype()) == "float64"


def test_order_insensitive_envelopes_equal_the_jax_package(pinned):
    rng = np.random.default_rng(3)
    cols = _columns(rng, 3000)
    janalyzers, panalyzers = _both(ORDER_INSENSITIVE)
    jres = JPass(janalyzers).run(JTable.from_numpy(cols))
    pres = PPass(panalyzers, device="cpu").run(PTable.from_numpy(cols))
    jblob = jstates.encode_states([(r.analyzer, r.state) for r in jres])
    pblob = pstates.encode_states([(r.analyzer, r.state) for r in pres])
    assert pblob == jblob
    # each package decodes the other's envelope to the same states
    for a, decoded, r in zip(panalyzers, pstates.decode_states(jblob, panalyzers), pres):
        assert serialize_state(a, decoded) == serialize_state(a, r.state)
    for a, decoded, r in zip(janalyzers, jstates.decode_states(pblob, janalyzers), jres):
        assert jsp.serialize_state(a, decoded) == jsp.serialize_state(a, r.state)


def _write_days(directory, days, rows=1500, seed=4):
    rng = np.random.default_rng(seed)
    directory.mkdir(exist_ok=True)
    for day in days:
        pq.write_table(
            pa.table(_columns(rng, rows)), str(directory / f"day-{day:03d}.parquet"),
            row_group_size=512,
        )


def test_repository_filled_by_the_jax_package_serves_the_port(pinned, tmp_path):
    data = tmp_path / "data"
    _write_days(data, range(5))
    janalyzers, panalyzers = _both(ANALYZERS)
    jrepo = jstates.FileSystemStateRepository(str(tmp_path / "cache"))
    jctx = JRunner.do_analysis_run(
        JTable.scan_parquet_dataset(str(data)), janalyzers,
        state_repository=jrepo, dataset_name="days", engine="single",
    )
    prepo = pstates.FileSystemStateRepository(str(tmp_path / "cache"))
    with runtime.monitored() as stats:
        pctx = PRunner.do_analysis_run(
            PTable.scan_parquet_dataset(str(data)), panalyzers,
            state_repository=prepo, dataset_name="days", device="cpu",
        )
    assert (stats.partitions_cached, stats.partitions_scanned, stats.partitions_total) == (5, 0, 5)
    assert stats.device_passes == 0
    for ja, pa_ in zip(janalyzers, panalyzers):
        jv, pv = jctx.metric_map[ja].value.get(), pctx.metric_map[pa_].value.get()
        if hasattr(jv, "values"):
            assert {k: (v.absolute, v.ratio) for k, v in pv.values.items()} == {
                k: (v.absolute, v.ratio) for k, v in jv.values.items()
            }
        else:
            assert bits(pv) == bits(jv), repr(pa_)


def test_partition_fingerprint_equals_the_jax_package(tmp_path):
    """The same file has the same fingerprint in both packages, so a
    repository's entries are found by either; a rewrite changes it."""
    from deequ_tpu.data.source import partition_fingerprint as jfingerprint
    from deequ_tpu_torch.data.source import partition_fingerprint as pfingerprint

    data = tmp_path / "data"
    _write_days(data, range(2))
    for path in sorted(glob.glob(str(data / "*.parquet"))):
        assert pfingerprint(path) == jfingerprint(path)
    first = sorted(glob.glob(str(data / "*.parquet")))[0]
    before = pfingerprint(first)
    partition = PTable.scan_parquet_dataset(str(data)).partitions()[0]
    assert partition.fingerprint == before
    rng = np.random.default_rng(9)
    pq.write_table(pa.table(_columns(rng, 1400)), first, row_group_size=512)
    assert pfingerprint(first) != before
    assert pfingerprint(first) == jfingerprint(first)


def test_metrics_repository_json_equals_the_jax_package(tmp_path, pinned):
    """A metrics repository's history file: the port writes the JAX
    package's JSON for the same metrics, and each package loads the
    other's file. (Small integers: every metric here is exact.)"""
    from deequ_tpu.repository import FileSystemMetricsRepository as JRepository
    from deequ_tpu.repository import ResultKey as JKey
    from deequ_tpu_torch.repository import FileSystemMetricsRepository as PRepository
    from deequ_tpu_torch.repository import ResultKey as PKey

    cols = {"x": np.arange(40.0) % 7, "g": np.arange(40) % 5,
            "s": np.array(["a", "b", None, "1"] * 10, dtype=object)}
    spec = [("Size", ()), ("Mean", ("x",)), ("Maximum", ("x",)), ("Uniqueness", (["g"],)),
            ("Histogram", ("s",)), ("ApproxQuantiles", ("x", [0.25, 0.5])), ("DataType", ("s",))]
    janalyzers, panalyzers = _both(spec)
    jpath, ppath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    JRunner.on_data(JTable.from_numpy(cols)).add_analyzers(janalyzers).with_engine(
        "single").use_repository(JRepository(jpath)).save_or_append_result(
        JKey(5, {"day": "mon"})).run()
    PRunner.on_data(PTable.from_numpy(cols), device="cpu").add_analyzers(
        panalyzers).use_repository(PRepository(ppath)).save_or_append_result(
        PKey(5, {"day": "mon"})).run()
    assert open(ppath).read() == open(jpath).read()
    from_jax = PRepository(jpath).load().with_tag_values({"day": "mon"}).get_success_metrics_as_json()
    from_port = JRepository(ppath).load().with_tag_values({"day": "mon"}).get_success_metrics_as_json()
    assert from_jax == from_port


@pytest.mark.parametrize("name", ["EngineMetric", "ForensicsAudit", "NoSuchAnalyzer"])
def test_analyzers_outside_the_port_do_not_deserialize(name):
    """An analyzer name the port does not know raises; the telemetry and
    audit keys (repository/engine.py, repository/audit.py) are the
    port's own since they were ported, and deserialize to its classes."""
    from deequ_tpu_torch.repository.audit import AuditRecord
    from deequ_tpu_torch.repository.engine import EngineMetric
    from deequ_tpu_torch.repository.serde import deserialize_analyzer

    data = {"analyzerName": name, "metric": "m", "instance": "i"}
    if name == "NoSuchAnalyzer":
        with pytest.raises(ValueError, match=f"Unable to deserialize analyzer {name}"):
            deserialize_analyzer(data)
        return
    analyzer = deserialize_analyzer(data)
    assert isinstance(analyzer, EngineMetric if name == "EngineMetric" else AuditRecord)
    assert analyzer.instance == "i"
