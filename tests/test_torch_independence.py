"""The PyTorch port stands alone: importing it loads neither JAX nor any
module of the JAX package, and no source of the port imports them.

The import check runs in a subprocess because this test process already
imported jax (tests/conftest.py)."""

from __future__ import annotations

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "deequ_tpu_torch")


def _forbidden(module: str) -> bool:
    # exact names and dotted children only: "deequ_tpu_torch" shares the
    # "deequ_tpu" prefix but is the port itself
    return any(
        module == root or module.startswith(root + ".")
        for root in ("jax", "jaxlib", "deequ_tpu")
    )


def _port_sources():
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "build")]
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")
    tools = os.path.join(REPO, "tools")
    for name in sorted(os.listdir(tools)):
        if name.startswith("torch_") and name.endswith(".py"):
            yield os.path.join(tools, name)


# the modules of the port's later slices, some of which carry their own
# copies of JAX-package modules that import no JAX themselves (kll.py,
# expr.py)
SLICE_MODULES = [
    "deequ_tpu_torch.ops.sketches.kll",
    "deequ_tpu_torch.data.expr",
    "deequ_tpu_torch.analyzers.grouping",
    "deequ_tpu_torch.analyzers.frequency",
    "deequ_tpu_torch.analyzers.histogram",
    "deequ_tpu_torch.ops.freq_agg",
    "deequ_tpu_torch.runners.grouping_runner",
    "deequ_tpu_torch.constraints.constrainable_data_types",
    "deequ_tpu_torch.ops.counts_family",
    "deequ_tpu_torch.profiles.internal_analyzers",
    "deequ_tpu_torch.profiles.column_profile",
    "deequ_tpu_torch.profiles.column_profiler",
    "deequ_tpu_torch.profiles.runner",
    "deequ_tpu_torch.core.fileio",
    "deequ_tpu_torch.suggestions.suggestion",
    "deequ_tpu_torch.suggestions.rules",
    "deequ_tpu_torch.suggestions.runner",
    "deequ_tpu_torch.data.source",
    "deequ_tpu_torch.ops.pipeline",
    "deequ_tpu_torch.core.controller",
    "deequ_tpu_torch.analyzers.freq_spill",
    "deequ_tpu_torch.core.fsio",
    "deequ_tpu_torch.analyzers.state_provider",
    "deequ_tpu_torch.analyzers.analysis",
    "deequ_tpu_torch.repository.base",
    "deequ_tpu_torch.repository.memory",
    "deequ_tpu_torch.repository.fs",
    "deequ_tpu_torch.repository.serde",
    "deequ_tpu_torch.repository.states",
    "deequ_tpu_torch.lint.schema",
    "deequ_tpu_torch.lint",
    "deequ_tpu_torch.lint.interval",
    "deequ_tpu_torch.lint.diagnostics",
    "deequ_tpu_torch.lint.fold",
    "deequ_tpu_torch.lint.typecheck",
    "deequ_tpu_torch.lint.effects",
    "deequ_tpu_torch.lint.subsume",
    "deequ_tpu_torch.lint.cost",
    "deequ_tpu_torch.lint.explain",
    "deequ_tpu_torch.lint.planlint",
    "deequ_tpu_torch.applicability.applicability",
    "deequ_tpu_torch.schema.row_level_schema_validator",
    "deequ_tpu_torch.anomaly",
    "deequ_tpu_torch.anomaly.base",
    "deequ_tpu_torch.anomaly.strategies",
    "deequ_tpu_torch.anomaly.detector",
    "deequ_tpu_torch.anomaly.holt_winters",
    "deequ_tpu_torch.ops.native",
    "deequ_tpu_torch.data.arrow_decode",
    "deequ_tpu_torch.data.native_reader",
    "deequ_tpu_torch.data.encfold",
    "deequ_tpu_torch.lint.pushdown",
    "deequ_tpu_torch.runners.engine",
    "deequ_tpu_torch.parallel",
    "deequ_tpu_torch.parallel.distributed",
    "deequ_tpu_torch.parallel.multihost",
    "deequ_tpu_torch.parallel.procspawn",
    "deequ_tpu_torch.parallel.shard",
    "deequ_tpu_torch.observe",
    "deequ_tpu_torch.observe.spans",
    "deequ_tpu_torch.observe.counters",
    "deequ_tpu_torch.observe.export",
    "deequ_tpu_torch.observe.report",
    "deequ_tpu_torch.observe.runtrace",
    "deequ_tpu_torch.observe.compare",
    "deequ_tpu_torch.observe.heartbeat",
    "deequ_tpu_torch.observe.telemetry",
    "deequ_tpu_torch.observe.forensics",
    "deequ_tpu_torch.repository.engine",
    "deequ_tpu_torch.repository.audit",
]


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([PORT], prefix="deequ_tpu_torch."))


@pytest.mark.parametrize("name", SLICE_MODULES)
def test_slice_modules_are_checked(name):
    """Each is among the modules the subprocess import check loads, and
    its source among those the import scan reads."""
    assert name in _port_modules()
    path = os.path.join(REPO, *name.split("."))
    path = os.path.join(path, "__init__.py") if os.path.isdir(path) else path + ".py"
    assert path in list(_port_sources())


@pytest.mark.parametrize("name", ["deequ_tpu", "deequ_tpu.ops", "jax", "jaxlib.xla"])
def test_forbidden_matches_the_jax_package(name):
    assert _forbidden(name)


@pytest.mark.parametrize("name", ["deequ_tpu_torch", "deequ_tpu_torch.ops", "jaxtyping"])
def test_forbidden_spares_the_port(name):
    assert not _forbidden(name)


def test_import_loads_neither_jax_nor_the_jax_package():
    modules = _port_modules()
    code = (
        "import importlib, sys\n"
        f"for name in {['deequ_tpu_torch'] + modules!r}:\n"
        "    importlib.import_module(name)\n"
        "roots = ('jax', 'jaxlib', 'deequ_tpu')\n"
        "print(sorted(m for m in sys.modules if any("
        "m == r or m.startswith(r + '.') for r in roots)))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout
    assert len(modules) >= 20, modules


def _imported_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            imported.append(node.module)
    return imported


def test_streaming_source_loads_no_jax():
    """Importing the streamed sources (which pull in pyarrow and the
    table, the runtime and the pipeline) loads no JAX."""
    code = (
        "import sys\n"
        "import deequ_tpu_torch.data.source\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'deequ_tpu.'))))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_chip_smoke_imports_are_walked():
    """Every port module chip_smoke.py imports (its stream phase's
    included) is one the subprocess import check loads."""
    modules = set(_port_modules()) | {"deequ_tpu_torch"}
    imported = [m for m in _imported_modules(os.path.join(REPO, "chip_smoke.py"))
                if m.startswith("deequ_tpu_torch")]
    assert "deequ_tpu_torch.data.source" in imported
    assert [m for m in imported if m not in modules] == []


@pytest.mark.parametrize(
    "path", list(_port_sources()), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_source_imports_jax_or_the_jax_package(path):
    imported = _imported_modules(path)
    assert not [m for m in imported if _forbidden(m)], imported


def test_the_c_library_builds_from_the_ports_sources_alone():
    """The loader compiles the C files beside it, into the port's build
    directory, and none of its paths reaches the JAX package."""
    from deequ_tpu_torch.ops import native

    native_dir = os.path.join(PORT, "ops", "native")
    assert native.SOURCES and all(os.path.dirname(p) == native_dir for p in native.SOURCES)
    assert sorted(os.path.basename(p) for p in native.SOURCES) == sorted(
        n for n in os.listdir(native_dir) if n.endswith(".c")
    )
    assert os.path.dirname(native.library_path()) == os.path.join(PORT, "build")
