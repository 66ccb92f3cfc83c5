"""The port's packages export the names the JAX package's export: every
name of `deequ_tpu.__all__` is importable from `deequ_tpu_torch`, and the
`analyzers`, `checks` (its drift checks included), `windows`, `testing`
and `service` packages re-export what the JAX package's do."""

from __future__ import annotations

import importlib

import pytest

import deequ_tpu
import deequ_tpu.analyzers
import deequ_tpu.checks
import deequ_tpu.service
import deequ_tpu.testing
import deequ_tpu.windows


@pytest.mark.parametrize("name", sorted(deequ_tpu.__all__))
def test_top_level_name_importable(name):
    port = importlib.import_module("deequ_tpu_torch")
    assert name in port.__all__
    assert getattr(port, name).__name__ == getattr(deequ_tpu, name).__name__


@pytest.mark.parametrize(
    "package, jax_package",
    [
        ("deequ_tpu_torch.analyzers", deequ_tpu.analyzers),
        ("deequ_tpu_torch.checks", deequ_tpu.checks),
        ("deequ_tpu_torch.windows", deequ_tpu.windows),
        ("deequ_tpu_torch.testing", deequ_tpu.testing),
        ("deequ_tpu_torch.service", deequ_tpu.service),
    ],
)
def test_subpackage_exports(package, jax_package):
    port = importlib.import_module(package)
    missing = sorted(set(jax_package.__all__) - set(port.__all__))
    assert missing == []
    for name in port.__all__:
        assert hasattr(port, name), name


@pytest.mark.parametrize(
    "module",
    [
        "checks.drift", "analyzers.drift", "windows.spec", "windows.segments", "windows.query",
        "testing.faults", "core.controller", "service", "service.codes", "service.quotas",
        "service.breaker", "service.telemetry", "service.admission", "service.sharing",
        "service.service",
    ],
)
def test_module_all_equals_jax(module):
    """The fault-containment, drift, window and service modules export
    the JAX modules' names."""
    port = importlib.import_module(f"deequ_tpu_torch.{module}")
    jax = importlib.import_module(f"deequ_tpu.{module}")
    assert sorted(port.__all__) == sorted(jax.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name


def test_drift_checks_reexported_from_checks():
    import deequ_tpu_torch.checks as checks
    from deequ_tpu_torch.checks import drift

    for name in ("DriftCheck", "DriftCheckResult", "DriftConstraint", "DriftConstraintResult"):
        assert getattr(checks, name) is getattr(drift, name)
