"""The port's state serde paths hold the JAX package's SERDE rule: no
pickle in repository/states.py or analyzers/state_provider.py. The rule
is tools/lint.py's own `check_serde_pickle`, run over the port's files."""

from __future__ import annotations

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SERDE_FILES = (
    "deequ_tpu_torch/repository/states.py",
    "deequ_tpu_torch/analyzers/state_provider.py",
)


def _check_serde_pickle():
    spec = importlib.util.spec_from_file_location(
        "repo_lint_serde", os.path.join(REPO, "tools", "lint.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.check_serde_pickle


@pytest.mark.parametrize("rel", PORT_SERDE_FILES)
def test_port_serde_paths_use_no_pickle(rel):
    assert _check_serde_pickle()(os.path.join(REPO, rel)) == []


@pytest.mark.parametrize(
    "code", ["import pickle\n", "def f(b):\n    import dill\n    return dill.loads(b)\n"]
)
def test_the_rule_flags_pickle(tmp_path, code):
    path = tmp_path / "serde.py"
    path.write_text(code)
    assert _check_serde_pickle()(str(path))
