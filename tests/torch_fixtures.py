"""The toy tables of tests/fixtures.py as tables of the port: the same
columns, types and values, for the port-mapped copies of reference tests
(tests/test_torch_*.py)."""

from __future__ import annotations

import fixtures as _reference
from torch_stream_helpers import port_table


def _ported(name):
    make = getattr(_reference, name)

    def build():
        return port_table(make())

    build.__name__ = name
    build.__doc__ = f"`fixtures.{name}` as a table of the port."
    return build


__all__ = sorted(n for n in dir(_reference) if n.startswith("get_"))
for _name in __all__:
    globals()[_name] = _ported(_name)
