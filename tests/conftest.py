"""Test harness: run JAX on a virtual 8-device CPU platform.

The analogue of the reference's SparkContextSpec local-master session
(reference: src/test/scala/com/amazon/deequ/SparkContextSpec.scala:25-95):
everything "distributed" is tested without TPU hardware — the host CPU is
split into 8 XLA devices so mesh/sharding code paths run for real.

Must run before jax is imported anywhere.
"""

import os
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"

# isolate the per-user on-disk caches (placement probe results): tests
# must neither read a developer's production cache nor overwrite it
os.environ["DEEQU_TPU_CACHE_DIR"] = tempfile.mkdtemp(prefix="deequ_tpu_test_cache_")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "true")

# jaxtyping's pytest plugin imports jax before this conftest runs, so the
# env vars alone can be too late — on a machine with a real accelerator the
# backend would otherwise initialize with 1 TPU device instead of 8 virtual
# CPU devices. Push platform + device count + x64 through the live config
# (safe post-import: the backend is not initialized until first use).
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except AttributeError:
    # older jax (< 0.4.34 area) has no such option; the
    # xla_force_host_platform_device_count flag above does the same job
    pass
jax.config.update(
    "jax_enable_x64", os.environ["JAX_ENABLE_X64"].lower() in ("1", "true")
)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def pytest_configure(config):
    # tests/test_torch_strings_card.py: CUDA kernels with no CPU mode,
    # skipped without a card
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")
