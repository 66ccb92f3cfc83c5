"""The observability examples (examples/tracing_example.py,
forensics_example.py and resume_example.py) run on the port: each
script's `deequ_tpu` imports renamed to `deequ_tpu_torch`, every run on
the CPU (tests/torch_cpu.py). The tracing example's cross-process demo
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
    for name in ("tracing_example.py", "forensics_example.py", "resume_example.py"):
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
