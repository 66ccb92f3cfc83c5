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


@pytest.mark.parametrize("name", ["deequ_tpu", "deequ_tpu.ops", "jax", "jaxlib.xla"])
def test_forbidden_matches_the_jax_package(name):
    assert _forbidden(name)


@pytest.mark.parametrize("name", ["deequ_tpu_torch", "deequ_tpu_torch.ops", "jaxtyping"])
def test_forbidden_spares_the_port(name):
    assert not _forbidden(name)


def test_import_loads_neither_jax_nor_the_jax_package():
    modules = sorted(
        m.name
        for m in pkgutil.walk_packages([PORT], prefix="deequ_tpu_torch.")
    )
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


@pytest.mark.parametrize(
    "path", list(_port_sources()), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_source_imports_jax_or_the_jax_package(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            imported.append(node.module)
    assert not [m for m in imported if _forbidden(m)], imported
