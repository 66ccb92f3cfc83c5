"""The observability, drift and service examples
(examples/tracing_example.py, forensics_example.py, resume_example.py,
drift_example.py, service_example.py and sharing_example.py) run on the
port: each script's `deequ_tpu` imports renamed to `deequ_tpu_torch`,
every run on the CPU (tests/torch_cpu.py). The tracing example's cross-process demo
runs too: its two shard workers are separate interpreters (the port's
`procspawn`), each put on the CPU the way `cpu_default` puts this
process, exchanging their state envelopes through files; their traces
merge into one document with pids 0 and 1.
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import re
from pathlib import Path

import pytest

pytestmark = pytest.mark.usefixtures("cpu_default")

EXAMPLES_DIR = Path(__file__).resolve().parent.parent / "examples"

# a worker interpreter resolves an unset device to the CPU, as
# tests/torch_cpu.py's fixture does in this process
_WORKER_ON_CPU = (
    'os.environ["DEEQU_TPU_SHARD"] = str(rank)\n'
    "    from deequ_tpu_torch.ops import runtime as _runtime\n"
    "    _resolve = _runtime.resolve_device\n"
    '    _runtime.resolve_device = lambda device=None: _resolve("cpu" if device is None else device)\n'
)


def _ported_source(name: str) -> str:
    source = (EXAMPLES_DIR / name).read_text(encoding="utf-8")
    source = re.sub(r"\bdeequ_tpu\b(?=[ .])", "deequ_tpu_torch", source)
    return source.replace('os.environ["DEEQU_TPU_SHARD"] = str(rank)\n', _WORKER_ON_CPU)


def _run(name: str, capsys, monkeypatch) -> str:
    monkeypatch.syspath_prepend(str(EXAMPLES_DIR))  # example_utils
    code = compile(_ported_source(name), str(EXAMPLES_DIR / name), "exec")
    exec(code, {"__name__": "__main__", "__file__": str(EXAMPLES_DIR / name)})
    return capsys.readouterr().out


def test_sources_import_only_the_port():
    for name in ("tracing_example.py", "forensics_example.py", "resume_example.py", "drift_example.py",
                 "service_example.py", "sharing_example.py"):
        source = _ported_source(name)
        assert not re.search(r"\bdeequ_tpu\b(?=[ .])", source), name
        assert "deequ_tpu_torch" in source


def test_tracing_example_runs_on_the_port(capsys, monkeypatch):
    out = _run("tracing_example.py", capsys, monkeypatch)
    assert out.startswith("deequ_tpu run report — verification_suite")
    assert "phases (self-time):" in out
    assert "chrome trace written to:" in out
    # the cross-process demo: both workers' traces merged, pids 0 and 1
    assert "shard processes (pids [0, 1])" in out
    assert "shard_allgather" in out and "shard_merge" in out


def test_forensics_example_runs_on_the_port(capsys, monkeypatch):
    out = _run("forensics_example.py", capsys, monkeypatch)
    assert "failure forensics:" in out
    assert out.strip()


def test_resume_example_runs_on_the_port(capsys, monkeypatch):
    out = _run("resume_example.py", capsys, monkeypatch)
    assert "first attempt ended early" in out
    assert "rerun: 1 partition(s) from cache, 2 scanned" in out


def test_drift_example_runs_on_the_port(capsys, monkeypatch):
    """Two stable weeks pass the week-over-week gate; after the skewed
    day lands, the mean and cardinality constraints fail, as they do in
    the JAX package's run of the script."""
    out = _run("drift_example.py", capsys, monkeypatch)
    assert "window plan: sliding(7, step=1) -> 3 segment merges" in out
    stable, skewed = out.split("week over week after the skewed day landed:")
    assert "drift status: SUCCESS" in stable and "[FAILURE]" not in stable
    assert "drift status: ERROR" in skewed
    failed = {line.split("] ")[1].split(" of ")[0]
              for line in skewed.splitlines() if line.startswith("\t[FAILURE]")}
    assert failed == {"mean drift", "cardinality drift"}


def test_service_example_runs_on_the_port(capsys, monkeypatch):
    """The heavy run resumes to done after its preemptions, the corrupt
    dataset fails twice and is then turned away with DQ413, and its
    breaker is open, as in the JAX package's run of the script (how many
    probes preempt the heavy run depends on timing there too)."""
    out = _run("service_example.py", capsys, monkeypatch)
    assert "heavy admitted: tier=heavy" in out
    for i in range(3):
        assert f"probe-{i}: done (tier=interactive)" in out
    heavy = re.search(r"heavy: (\w+) after (\d+) preemption\(s\), (\d+) attempt\(s\)", out)
    assert heavy, out
    status, preemptions, attempts = heavy.group(1), int(heavy.group(2)), int(heavy.group(3))
    assert status == "done" and attempts == preemptions + 1
    codes = re.findall(r"corrupt submit \d: (\w+) code=(\S+)", out)
    assert codes == [("failed", "-"), ("failed", "-"), ("rejected", "DQ413")]
    assert "breaker for (flaky-tenant, corrupt): open" in out
    assert "engine.service.tenant.batch-tenant.bytes_scanned = 24800000.0" in out


def test_sharing_example_runs_on_the_port(capsys, monkeypatch):
    """One shared scan; every tenant in it carries a CONTAINED proof with
    zero drift (a tenant the worker took before the others queued runs
    solo, as one did in a JAX run of the script)."""
    out = _run("sharing_example.py", capsys, monkeypatch)
    assert "shared scans run: 1" in out
    lines = [line for line in out.splitlines() if line.startswith("  ")]
    assert len(lines) == 3
    shared = [line for line in lines if "shared with" in line]
    assert len(shared) >= 2
    for line in lines:
        assert "SUCCESS" in line
        assert line.endswith("proof CONTAINED, drift 0") or line.endswith("solo (no group formed)"), line
