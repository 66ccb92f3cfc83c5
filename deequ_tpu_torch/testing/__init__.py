"""Deterministic test harnesses for the engine (fault injection)."""

from deequ_tpu_torch.testing import faults

__all__ = ["faults"]
