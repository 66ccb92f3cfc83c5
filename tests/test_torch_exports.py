"""The port's packages export the names the JAX package's export: every
name of `deequ_tpu.__all__` is importable from `deequ_tpu_torch`, and the
`analyzers` and `checks` packages re-export what the JAX package's do
(less its drift checks, which come with the port's drift layer)."""

from __future__ import annotations

import importlib

import pytest

import deequ_tpu
import deequ_tpu.analyzers
import deequ_tpu.checks

#: names the JAX `checks` package exports whose module the port lacks yet
NOT_YET = {"DriftCheck", "DriftCheckResult", "DriftConstraint", "DriftConstraintResult"}


@pytest.mark.parametrize("name", sorted(deequ_tpu.__all__))
def test_top_level_name_importable(name):
    port = importlib.import_module("deequ_tpu_torch")
    assert name in port.__all__
    assert getattr(port, name).__name__ == getattr(deequ_tpu, name).__name__


@pytest.mark.parametrize(
    "package, jax_package",
    [("deequ_tpu_torch.analyzers", deequ_tpu.analyzers), ("deequ_tpu_torch.checks", deequ_tpu.checks)],
)
def test_subpackage_exports(package, jax_package):
    port = importlib.import_module(package)
    missing = sorted(set(jax_package.__all__) - NOT_YET - set(port.__all__))
    assert missing == []
    for name in port.__all__:
        assert hasattr(port, name), name
