"""A fixture that puts every run of the port on the CPU: the port-mapped
copies of reference tests (tests/test_torch_*.py) call entry points with
no device, which on a machine without CUDA raise; with this fixture a
device left unset resolves to the CPU, as `device="cpu"` would. A test
module imports `cpu_default` and sets
`pytestmark = pytest.mark.usefixtures("cpu_default")`; the fixture is
module-scoped, so the module's own module-scoped fixtures run on the
CPU too."""

from __future__ import annotations

import pytest

from deequ_tpu_torch.ops import runtime

_RESOLVE = runtime.resolve_device


@pytest.fixture(scope="module")
def cpu_default():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(
            runtime, "resolve_device", lambda device=None: _RESOLVE("cpu" if device is None else device)
        )
        yield
